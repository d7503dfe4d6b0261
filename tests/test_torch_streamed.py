"""The port's host-streamed SGD (``tpu_sgd_torch/optimize/streamed.py``), on
the CPU: the twins of the host-streaming cases of
``tests/test_gradient_descent.py``, ``test_io.py``, ``test_superstep.py``
and ``test_resident.py``.

Against the JAX package:

* exact: every iteration's sampled rows, valid mask, row cap and sliced
  window (the JAX driver's batches are recorded through its prefetcher),
  the window helpers, history length and the convergence iteration;
* the per-step sums at the bounds of ``tests/test_pallas.py`` (grad rtol
  2e-4 / atol 2e-3, loss rtol 2e-4);
* whole runs of <= 20 iterations: loss history rtol 1e-4 (the same
  samples);
* checkpoints cross between the packages both ways, the error-feedback
  accumulator (``extras["ef"]``) included.

Within the port, bitwise: prefetch depth 2 against 0; K = 1 against
K = 4 against K = 4 with residency; resident prefix against none; a run
healed from an ``io.device_put`` fault and an ``io.chunk`` corruption
against a clean one; a preempted run resumed against the uninterrupted
one.
"""

import warnings

import numpy as np
import pytest
import torch

import tpu_sgd.io as jio
from tpu_sgd.config import SGDConfig as JConfig
from tpu_sgd.ops.gradients import LeastSquaresGradient as JLS
from tpu_sgd.ops.updaters import SimpleUpdater as JSimple
from tpu_sgd.optimize import streamed as jst
from tpu_sgd.optimize.gradient_descent import GradientDescent as JGD
from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.io.integrity import IntegrityError
from tpu_sgd_torch.obs import counters
from tpu_sgd_torch.ops.gradients import LeastSquaresGradient
from tpu_sgd_torch.ops.updaters import SimpleUpdater
from tpu_sgd_torch.optimize import streamed as tst_
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.reliability import (FaultInjected, RetryPolicy,
                                       TrainingPreempted, corrupt_nth,
                                       fail_nth, inject_faults)
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.utils.checkpoint import CheckpointManager

MODES = ("sliced", "indexed", "bernoulli")
CPU = "cpu"


def _data(rng, n=2000, d=8):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _opt(mode="bernoulli", iters=12, frac=0.1, k=1, c=0, R=0, wc=None,
         depth=2, tol=0.0, seed=7, step=0.1):
    o = (GradientDescent(device=CPU)
         .set_num_iterations(iters).set_step_size(step)
         .set_mini_batch_fraction(frac).set_sampling(mode)
         .set_convergence_tol(tol).set_seed(seed)
         .set_host_streaming(True, resident_rows=R)
         .set_ingest_options(prefetch_depth=depth, wire_compress=wc)
         .set_superstep(k))
    if c:
        o.set_residency(c)
    return o


def _jopt(mode="bernoulli", iters=12, frac=0.1, k=1, c=0, wc=None, tol=0.0,
          seed=7, step=0.1):
    o = (JGD().set_num_iterations(iters).set_step_size(step)
         .set_mini_batch_fraction(frac).set_sampling(mode)
         .set_convergence_tol(tol).set_seed(seed).set_host_streaming(True))
    if k > 1:
        o.set_superstep(k)
    if c:
        o.set_residency(c)
    if wc:
        o.set_ingest_options(wire_compress=wc)
    return o


def _run(o, X, y, d=8):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return o.optimize_with_history((X, y), np.zeros(d, np.float32))


def _eq(a, b):
    (wa, ha), (wb, hb) = a, b
    np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))
    np.testing.assert_array_equal(ha, hb)


# ---- the host sampler is the JAX package's, exactly -------------------------

class _Recorder:
    """Stands in for the JAX package's ``Prefetcher`` and records what its
    producer made for each item."""

    seen = []

    def __init__(self, producer, items, depth=2, **kw):
        self._it = iter(items)
        self._producer = producer

    def __iter__(self):
        return self

    def __next__(self):
        out = self._producer(next(self._it))
        _Recorder.seen.append(out)
        return out

    def close(self):
        pass


@pytest.mark.parametrize("mode,R", [("bernoulli", 0), ("indexed", 0),
                                    ("sliced", 0), ("sliced", 1500)])
def test_sampled_rows_caps_and_windows_equal_the_jax_draws(rng, mode, R,
                                                           monkeypatch):
    X, y = _data(rng, n=2000, d=4)
    X[:, 0] = np.arange(2000)  # each row names itself
    cfg = JConfig(step_size=0.1, num_iterations=9, mini_batch_fraction=0.1,
                  convergence_tol=0.0, sampling=mode, seed=3)
    _Recorder.seen = []
    monkeypatch.setattr(jio, "Prefetcher", _Recorder)
    jst.optimize_host_streamed(JLS(), JSimple(), cfg, X, y,
                               np.zeros(4, np.float32), resident_rows=R)
    assert len(_Recorder.seen) == 9
    sampler = tst_.HostSampler(SGDConfig(**{
        k: getattr(cfg, k) for k in ("step_size", "num_iterations",
                                     "mini_batch_fraction",
                                     "convergence_tol", "sampling",
                                     "seed")}), 2000, R)
    for i, (kind, payload) in enumerate(_Recorder.seen, start=1):
        draw = sampler.draw(i)
        if kind == "resident":
            assert draw == ("resident", payload)
            continue
        Xb, _, valid = (np.asarray(a) for a in payload)
        assert Xb.shape[0] == sampler.cap  # the row cap
        rows = Xb[:, 0].astype(np.int64)
        if draw[0] == "window":
            assert valid.all()
            np.testing.assert_array_equal(
                rows, np.arange(draw[1], draw[1] + sampler.m))
        else:
            _, idx, count = draw
            np.testing.assert_array_equal(valid, np.arange(sampler.cap)
                                          < count)
            np.testing.assert_array_equal(rows, idx)


@pytest.mark.parametrize("n,frac,R", [(2000, 0.1, 500), (997, 0.33, 997),
                                      (10, 0.05, 3), (10_000_000, 0.1,
                                                      5_000_000)])
def test_window_helpers_equal_the_jax_helpers(n, frac, R):
    assert tst_.sliced_window_rows(n, frac) == jst.sliced_window_rows(n, frac)
    assert tst_.resident_window_probability(n, frac, R) == \
        jst.resident_window_probability(n, frac, R)
    sigma = np.sqrt(n * frac * (1.0 - frac))
    assert tst_.bernoulli_cap(n, frac) == int(
        min(n, np.ceil(n * frac + 6.0 * sigma + 8)))


def test_resident_windows_follow_the_resident_probability():
    cfg = SGDConfig(num_iterations=4000, mini_batch_fraction=0.1,
                    sampling="sliced", seed=1)
    s = tst_.HostSampler(cfg, 2000, 1000)
    hits = sum(s.draw(i)[0] == "resident" for i in range(1, 4001))
    p = tst_.resident_window_probability(2000, 0.1, 1000)
    assert abs(hits - 4000 * p) <= 4 * np.sqrt(4000 * p * (1 - p))


# ---- per-step sums and whole runs against the JAX package --------------------

@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_per_step_sums_within_the_pallas_bounds(rng, frac):
    from tpu_sgd.ops.gradients import LeastSquaresGradient as JG

    X, y = _data(rng, n=500, d=8)
    w = rng.normal(size=8).astype(np.float32)
    mask = rng.random(500) < frac
    g, l, c = LeastSquaresGradient().batch_sums(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(mask))
    gj, lj, cj = (np.asarray(a) for a in JG().batch_sums(X, y, w, mask))
    np.testing.assert_allclose(g.numpy(), gj, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(float(l), float(lj), rtol=2e-4)
    assert float(c) == float(cj)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 4])
def test_streamed_history_matches_the_jax_run(rng, mode, k):
    X, y = _data(rng)
    w, h = _run(_opt(mode, iters=18, frac=0.1, k=k), X, y)
    wj, hj = _run(_jopt(mode, iters=18, frac=0.1, k=k), X, y)
    assert len(h) == len(hj) == 18
    np.testing.assert_allclose(h, hj, rtol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=2e-4,
                               atol=2e-3)


def test_full_batch_and_resident_prefix_match_the_jax_run(rng):
    X, y = _data(rng, n=600)
    _, h = _run(_opt(iters=10, frac=1.0), X, y)
    _, hj = _run(_jopt(iters=10, frac=1.0), X, y)
    np.testing.assert_allclose(h, hj, rtol=1e-4)
    o = _jopt("sliced", iters=15, frac=0.2)
    o.streaming_resident_rows = 300
    _, hj = _run(o, X, y)
    _, h = _run(_opt("sliced", iters=15, frac=0.2, R=300), X, y)
    np.testing.assert_allclose(h, hj, rtol=1e-4)


@pytest.mark.parametrize("k", [1, 4])
def test_convergence_iteration_and_history_length_are_exact(rng, k):
    X, y = _data(rng, n=800)
    h = _run(_opt("sliced", iters=200, frac=0.25, k=k, tol=0.05,
                  step=0.05), X, y)[1]
    hj = _run(_jopt("sliced", iters=200, frac=0.25, k=k, tol=0.05,
                    step=0.05), X, y)[1]
    assert len(h) == len(hj) < 200
    np.testing.assert_allclose(h, hj, rtol=1e-4)


def test_bf16_wire_and_bf16_host_rows_train(rng):
    X, y = _data(rng)
    h32 = _run(_opt("sliced", iters=12, frac=0.25), X, y)[1]
    o = _opt("sliced", iters=12, frac=0.25)
    o.set_ingest_options(wire_dtype="bfloat16")
    hw = _run(o, X, y)[1]
    hb = _run(_opt("sliced", iters=12, frac=0.25),
              torch.from_numpy(X).bfloat16(), y)[1]
    np.testing.assert_array_equal(hw, hb)  # cast on the wire == bf16 rows
    assert hw[-1] < 0.5 * hw[0]
    np.testing.assert_allclose(hw, h32, rtol=5e-2)
    o = _opt("sliced", iters=12, frac=0.25)
    o.set_ingest_options(wire_dtype="bfloat16", pipeline=False)
    np.testing.assert_array_equal(_run(o, X, y)[1], h32)  # plain feed


@pytest.mark.parametrize("wc", ["topk:0.01", "topk:0.25"])
@pytest.mark.parametrize("k", [1, 8])
def test_compressed_wire_history_matches_the_jax_run(rng, wc, k):
    """The top-k error-feedback rule is the JAX package's: the same
    selections, so whole compressed runs agree (at 1% the loss does not
    settle within 32 iterations, in both packages alike)."""
    X = rng.normal(size=(2000, 100)).astype(np.float32)
    y = (X @ rng.normal(size=100)).astype(np.float32)
    h = _run(_opt(iters=32, frac=1.0, k=k, wc=wc, step=0.5), X, y, d=100)[1]
    hj = _run(_jopt(iters=32, frac=1.0, k=k, wc=wc, step=0.5), X, y,
              d=100)[1]
    np.testing.assert_allclose(h, hj, rtol=1e-4)


# ---- bitwise contracts within the port ---------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_prefetch_depth_two_equals_depth_zero(rng, mode):
    X, y = _data(rng)
    _eq(_run(_opt(mode, depth=2), X, y), _run(_opt(mode, depth=0), X, y))
    _eq(_run(_opt(mode, k=4, depth=3), X, y),
        _run(_opt(mode, k=4, depth=0), X, y))


@pytest.mark.parametrize("mode", MODES)
def test_k1_equals_k4_with_a_tail(rng, mode):
    X, y = _data(rng)
    _eq(_run(_opt(mode, iters=18, k=1), X, y),
        _run(_opt(mode, iters=18, k=4), X, y))


@pytest.mark.parametrize("wc", [None, "topk:0.25"])
def test_full_batch_k1_k4_and_residency_are_bitwise(rng, wc):
    X, y = _data(rng, n=400)
    a = _run(_opt(iters=18, frac=1.0, wc=wc), X, y)
    _eq(a, _run(_opt(iters=18, frac=1.0, k=4, wc=wc), X, y))
    _eq(a, _run(_opt(iters=18, frac=1.0, k=4, c=2, wc=wc), X, y))


@pytest.mark.parametrize("k", [1, 4])
def test_resident_prefix_changes_where_rows_come_from_not_the_result(rng, k):
    X, y = _data(rng, n=1000)
    ref = _run(_opt("sliced", iters=20, frac=0.1, k=k), X, y)
    counters.enable()
    try:
        with counters.deltas() as dl:
            got = _run(_opt("sliced", iters=20, frac=0.1, k=k, R=500), X, y)
        sent = dl.get()
    finally:
        counters.disable()
        counters.reset()
    _eq(ref, got)
    cfg = SGDConfig(num_iterations=20, mini_batch_fraction=0.1,
                    sampling="sliced", seed=7)
    s = tst_.HostSampler(cfg, 1000, 500)
    resident = sum(s.draw(i)[0] == "resident" for i in range(1, 21))
    assert 0 < resident < 20
    frames = sum(c["n"] for name, c in sent.items()
                 if name.endswith(".wire.dense-f32"))
    # one frame for the prefix, then one a (super)step
    assert frames == 1 + (20 if k == 1 else 5)
    xbytes = sum(c["bytes"] for name, c in sent.items()
                 if name.endswith(".wire.dense-f32"))
    per_window = 100 * 8 * 4
    yv = k * 100 * 5
    assert xbytes == 500 * 8 * 4 + (20 - resident) * per_window + (
        20 if k == 1 else 5) * yv


def test_fully_resident_slab_with_residency_is_bitwise(rng):
    X, y = _data(rng, n=400)
    _eq(_run(_opt("sliced", iters=18, frac=0.25, k=4), X, y),
        _run(_opt("sliced", iters=18, frac=0.25, k=4, c=2, R=400), X, y))


@pytest.mark.parametrize("k", [1, 4])
def test_device_put_fault_and_chunk_corruption_heal_bitwise(rng, k):
    X, y = _data(rng)
    ref = _run(_opt("bernoulli", k=k), X, y)
    o = _opt("bernoulli", k=k)
    o.set_ingest_options(retry=RetryPolicy(max_attempts=3,
                                           base_backoff_s=0.0))
    with inject_faults({"io.device_put": fail_nth(2),
                        "io.chunk": corrupt_nth(2)}):
        got = _run(o, X, y)
        assert fp.triggers("io.device_put") == 1
        assert fp.triggers("io.chunk") == 1
    _eq(ref, got)
    with inject_faults({"io.chunk": corrupt_nth(1)}):
        with pytest.raises(IntegrityError):
            _run(_opt("bernoulli", k=k), X, y)
    with inject_faults({"io.device_put": fail_nth(1)}):
        with pytest.raises(FaultInjected):
            _run(_opt("bernoulli", k=k), X, y)


@pytest.mark.parametrize("k,wc", [(1, None), (4, None), (1, "topk:0.25"),
                                  (4, "topk:0.25")])
def test_stop_at_13_and_resume_equal_the_uninterrupted_run(rng, tmp_path, k,
                                                           wc):
    X, y = _data(rng)
    ref = _run(_opt("bernoulli", iters=20, k=k, wc=wc), X, y)
    mgr = CheckpointManager(str(tmp_path))
    seen = {"i": 0}

    class Stop:
        def on_run_start(self, cfg):
            pass

        def on_iteration(self, e):
            seen["i"] = e.iteration

        def on_run_end(self, e):
            pass

    o = _opt("bernoulli", iters=20, k=k, wc=wc)
    o.set_listener(Stop()).set_checkpoint(mgr, every=5)
    o.set_stop_signal(lambda: seen["i"] >= 13)
    with pytest.raises(TrainingPreempted) as stop:
        _run(o, X, y)
    assert stop.value.iteration == (13 if k == 1 else 16)
    o2 = _opt("bernoulli", iters=20, k=k, wc=wc)
    o2.set_checkpoint(CheckpointManager(str(tmp_path)), every=5)
    _eq(ref, _run(o2, X, y))


def test_completed_checkpoint_returns_the_restored_run(rng, tmp_path):
    X, y = _data(rng, n=256, d=6)
    o = _opt("sliced", iters=4, frac=0.5)
    o.set_checkpoint(CheckpointManager(str(tmp_path)), every=1)
    a = _run(o, X, y, d=6)
    o2 = _opt("sliced", iters=4, frac=0.5)
    o2.set_checkpoint(CheckpointManager(str(tmp_path)), every=1)
    _eq(a, _run(o2, X, y, d=6))


# ---- checkpoints cross between the packages ----------------------------------

def _ef_ckpt(which, d, tmp, stop_at, X, y, resume=False):
    """A compressed streamed run of 12 full-batch iterations, preempted
    after ``stop_at`` with checkpoints every 4 (or resumed)."""
    from tpu_sgd.utils.checkpoint import CheckpointManager as JCM

    mgr = (CheckpointManager if which == "port" else JCM)(tmp)
    opt = (_opt if which == "port" else _jopt)(
        iters=12, frac=1.0, wc="topk:0.25")
    seen = {"i": 0}

    class L:
        def on_run_start(self, cfg):
            pass

        def on_iteration(self, e):
            seen["i"] = e.iteration

        def on_run_end(self, e):
            pass

    opt.set_checkpoint(mgr, every=4)
    if not resume:
        opt.set_listener(L())
        opt.set_stop_signal(lambda: seen["i"] >= stop_at)
    return opt, mgr


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_ef_checkpoints_cross_between_the_packages(rng, tmp_path, writer,
                                                   reader):
    from tpu_sgd.reliability.supervisor import \
        TrainingPreempted as JPreempted
    from tpu_sgd.utils.checkpoint import CheckpointManager as JCM

    X, y = _data(rng, n=300)
    tmp = str(tmp_path)
    opt, _ = _ef_ckpt(writer, 8, tmp, 6, X, y)
    with pytest.raises((TrainingPreempted, JPreempted)):
        _run(opt, X, y)
    saved_port = CheckpointManager(tmp).restore()
    saved_jax = JCM(tmp).restore()
    assert saved_port["iteration"] == saved_jax["iteration"] == 6
    for key in ("weights", "loss_history"):
        np.testing.assert_array_equal(np.asarray(saved_port[key]),
                                      np.asarray(saved_jax[key]))
    ef = np.asarray(saved_jax["extras"]["ef"])
    np.testing.assert_array_equal(np.asarray(saved_port["extras"]["ef"]), ef)
    assert ef.shape == (8,) and np.any(ef != 0)
    opt2, _ = _ef_ckpt(reader, 8, tmp, None, X, y, resume=True)
    _, h = _run(opt2, X, y)
    np.testing.assert_array_equal(h[:6], np.asarray(saved_jax[
        "loss_history"]))
    ref = _run(_jopt(iters=12, frac=1.0, wc="topk:0.25"), X, y)[1]
    assert len(h) == 12
    np.testing.assert_allclose(h, ref, rtol=1e-4)


def test_a_finished_run_frees_its_staging_without_a_collection(rng):
    """The run's prefetcher and save callback refer back to it; closing
    the run drops those references, so its staging buffers (on the card:
    pinned slots and device slots of a whole batch each) go when the run
    returns, not at the next garbage collection."""
    import gc
    import weakref

    from tpu_sgd_torch.io import prefetch

    made = []
    orig = prefetch.PinnedRing.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        made.append(weakref.ref(self))

    X, y = _data(rng, n=400)
    gc.disable()
    try:
        prefetch.PinnedRing.__init__ = init
        for k, frac, wc in ((1, 0.2, None), (4, 0.2, "topk:0.5"),
                            (4, 1.0, None)):
            _run(_opt(iters=6, frac=frac, k=k, wc=wc), X, y)
        assert made and all(r() is None for r in made)
    finally:
        prefetch.PinnedRing.__init__ = orig
        gc.enable()


class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, payload["name"], payload))


@pytest.mark.parametrize("k", [1, 4])
def test_the_feed_reports_its_cost_only_when_traced(rng, k):
    """Tracing on, every produce is an ``ingest.produce`` span holding its
    frame's ``ingest.checksum`` span, and each ring reports its pinned
    bytes (0 here: the CPU's buffers are pageable; the copies' card time,
    ``ingest.h2d``, is timed on the card only).  Tracing off, the feed
    emits nothing and the run is the same."""
    from tpu_sgd_torch.obs import spans

    X, y = _data(rng, n=400)
    quiet = _run(_opt(iters=8, frac=0.2, k=k), X, y)
    sink = _Sink()
    spans.enable_tracing(sink)
    try:
        traced = _run(_opt(iters=8, frac=0.2, k=k), X, y)
    finally:
        spans.disable_tracing()
    _eq(traced, quiet)
    by = {}
    for kind, name, payload in sink.records:
        by.setdefault((kind, name), []).append(payload)
    produced = by[("trace_span", "ingest.produce")]
    checks = by[("trace_span", "ingest.checksum")]
    assert len(produced) == len(checks) == -(-8 // k)
    ids = {p["span_id"] for p in produced}
    assert all(c["parent_id"] in ids for c in checks)
    assert [r["pinned_bytes"] for r in by[("trace_event", "ingest.ring")]] \
        == [0]
    assert ("trace_event", "ingest.h2d") not in by


# ---- guards ------------------------------------------------------------------

def test_streamed_guards(rng):
    X, y = _data(rng, n=100)
    with pytest.raises(TypeError, match="Mesh"):
        tst_.optimize_host_streamed(LeastSquaresGradient(), SimpleUpdater(),
                                    SGDConfig(), X, y, np.zeros(8),
                                    device=CPU, mesh=object())
    with pytest.raises(NotImplementedError, match="sliced"):
        _run(_opt("bernoulli", R=50), X, y)
    with pytest.raises(ValueError, match="smaller than one window"):
        _run(_opt("sliced", frac=0.5, R=10), X, y)
    with pytest.raises(ValueError, match="initial_weights"):
        _opt().optimize_with_history((X, y), np.zeros(3))
    w, h = _opt().optimize_with_history((X[:0], y[:0]), np.zeros(8))
    assert h.shape == (0,)
    with pytest.raises(ValueError, match="wire_compress"):
        GradientDescent(device=CPU).set_ingest_options(wire_compress="gz")
    with pytest.raises(ValueError, match="prefetch_depth"):
        GradientDescent(device=CPU).set_ingest_options(prefetch_depth=-1)
    with pytest.raises(TypeError, match="RetryPolicy"):
        GradientDescent(device=CPU).set_ingest_options(retry=3)
    with pytest.raises(ValueError, match="floating"):
        GradientDescent(device=CPU).set_ingest_options(wire_dtype="int8")
    o = GradientDescent(device=CPU).set_ingest_options(
        retry=RetryPolicy(), wire_compress="topk:0.1")
    o.set_ingest_options(retry=False, wire_compress=False)
    assert o.ingest_retry_policy is None and o.ingest_wire_compress is None


def test_host_sampled_residency_and_partial_slab_compression_warn(rng):
    X, y = _data(rng, n=400)
    with pytest.warns(RuntimeWarning, match="superstep driver"):
        _opt("bernoulli", iters=8, k=4, c=2).optimize_with_history(
            (X, y), np.zeros(8, np.float32))
    with pytest.warns(RuntimeWarning, match="partially-resident"):
        _opt("sliced", iters=8, frac=0.25, R=200,
             wc="topk:0.25").optimize_with_history(
            (X, y), np.zeros(8, np.float32))


def test_predict_streamed_equals_predict(rng):
    import tpu_sgd.models.regression as jreg
    from tpu_sgd_torch.models.regression import LinearRegressionModel

    X, _ = _data(rng, n=1000)
    w = rng.normal(size=8).astype(np.float32)
    m = LinearRegressionModel(w, 0.5, device=CPU)
    got = m.predict_streamed(X, batch_rows=300)
    np.testing.assert_array_equal(got, m.predict(torch.from_numpy(X))
                                  .numpy())
    ref = np.asarray(jreg.LinearRegressionModel(w, 0.5).predict_streamed(
        X, batch_rows=300))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(X).bfloat16()
    np.testing.assert_array_equal(m.predict_streamed(xb, 256),
                                  m.predict(xb).numpy())
    assert m.predict_streamed(X[:0]).shape == (0,)
    with pytest.raises(ValueError, match="batch_rows"):
        m.predict_streamed(X, 0)


def test_integrity_zero_added_runtime_events(rng, monkeypatch):
    """Checksums are pure host work: the warmed streamed superstep driver
    counts the same dispatches, compiles, host syncs and staged h2d bytes
    whether the integrity plane is on or off (counted by the
    port's hooks, the CPU tensors' reads and copies counted as the
    card's), and the two runs are bitwise equal."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.io.integrity import set_integrity

    monkeypatch.setattr(counters, "_card", lambda x: True)
    X, y = _data(rng, n=400)
    o = _opt("sliced", iters=24, frac=0.5, k=4)
    _run(o, X, y)  # warm

    def counted():
        obs.enable()
        try:
            counters.reset()
            out = _run(o, X, y)
            return out, {k.split(".", 1)[1]: v
                         for k, v in counters.snapshot().items()
                         if k.endswith(("dispatch", "compile", "host_sync",
                                        "h2d"))}
        finally:
            obs.disable()
            counters.reset()

    on, c_on = counted()
    set_integrity(False)
    try:
        off, c_off = counted()
    finally:
        set_integrity(True)
    assert c_on == c_off
    assert c_on["host_sync"]["n"] > 0
    # on the CPU the ring's slots are the step's buffers: no copy, no
    # launch, no capture (the card's counts are chip_smoke.py's)
    assert set(c_on) == {"host_sync"}
    _eq(on, off)
