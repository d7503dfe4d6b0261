"""K-iteration blocks and the observed superstep driver of the port
(``tpu_sgd_torch/optimize/gradient_descent.py``), on the CPU: the twins of
the resident-path cases of ``tests/test_superstep.py`` and of
``test_gradient_descent.py::test_stepwise_numerics_reports_true_iteration``,
plus the device step and the block itself.

Contracts pinned here (on the CPU nothing is captured: every block runs
eagerly, the same code a captured graph records on the card):

* the updater's step computed on the device from the iteration counter
  equals the host's float32 rounding, bitwise, for i = 1 … 10⁶;
* ``make_run`` in blocks of any K equals the per-iteration loop of
  ``make_step`` bitwise (weights, history, record count, convergence
  iteration), in every sampling mode;
* the observed driver at K = 1 and K ≥ 2 gives the same history, events
  (wall times aside) and checkpoints, bitwise; a preempted run resumed
  equals the uninterrupted one, bitwise.

Across packages (the observed driver against the JAX package's, at full
batch or with the JAX window starts injected): history length,
convergence iteration, event count and checkpoint iterations exact;
losses rtol 2e-4 per step; weights rtol 2e-4 / atol 2e-3.
"""

import glob
import re

import jax
import numpy as np
import pytest
import torch

from tpu_sgd.optimize import gradient_descent as jgd
from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops import gradients as tg
from tpu_sgd_torch.ops import updaters as tu
from tpu_sgd_torch.optimize import gradient_descent as tgd
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.reliability import (
    RetryPolicy,
    TrainingPreempted,
    TrainingSupervisor,
    fail_nth,
    inject_faults,
)
from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import SGDListener

MODES = ("sliced", "indexed", "bernoulli")
CPU = "cpu"


def _data(rng, n=1000, d=12):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _opt(mode="sliced", iters=12, k=1, seed=7, tol=0.0, step=0.1,
         frac=0.5):
    return (GradientDescent(device=CPU)
            .set_num_iterations(iters).set_step_size(step)
            .set_mini_batch_fraction(frac).set_sampling(mode)
            .set_convergence_tol(tol).set_seed(seed).set_superstep(k))


class _Recorder:
    def __init__(self):
        self.events = []
        self.ended = None

    def on_run_start(self, cfg):
        pass

    def on_iteration(self, e):
        self.events.append(e)

    def on_run_end(self, e):
        self.ended = e


# ---- the device step ---------------------------------------------------------

@pytest.mark.parametrize("step_size", [0.5, 0.1, 1.0, 2.5e-3])
def test_device_step_equals_the_host_rounding(step_size):
    """The step the updaters compute from a device counter equals the old
    host rounding ``np.float32(s) / np.sqrt(np.float32(i))`` bitwise over
    i = 1 … 10⁶."""
    i = np.arange(1, 1_000_001)
    host = np.float32(step_size) / np.sqrt(i.astype(np.float32))
    dev = tu._this_step(step_size, torch.arange(1, 1_000_001))
    assert dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)


@pytest.mark.parametrize("updater", ["SimpleUpdater", "L1Updater",
                                     "SquaredL2Updater"])
def test_updaters_equal_host_scalar_arithmetic(updater, rng):
    """Each updater on a device counter equals the float32 host-scalar
    arithmetic it replaced, bitwise."""
    w = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=50).astype(np.float32))
    reg, s = 0.013, 0.37
    for i in (1, 2, 7, 100, 12345, 999_999):
        step = float(np.float32(s) / np.sqrt(np.float32(i)))
        ref = w - step * g
        if updater == "L1Updater":
            shrink = float(np.float32(reg) * np.float32(step))
            ref = torch.sign(ref) * torch.clamp(torch.abs(ref) - shrink,
                                                min=0.0)
        elif updater == "SquaredL2Updater":
            decay = float(np.float32(1.0) - np.float32(step)
                          * np.float32(reg))
            ref = w * decay - step * g
        got, _ = getattr(tu, updater)().compute(w, g, s, torch.tensor([i]),
                                                reg)
        same, _ = getattr(tu, updater)().compute(w, g, s, i, reg)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
        np.testing.assert_array_equal(same.numpy(), ref.numpy())


# ---- blocks ------------------------------------------------------------------

def _per_iteration(gradient, updater, cfg, X, y):
    """The per-iteration loop the blocks replace: ``make_step`` with host
    iteration numbers, a host read of the convergence flag each
    iteration."""
    step = tgd.make_step(gradient, updater, cfg)
    w = torch.zeros(X.shape[1])
    _, reg = updater.compute(w, torch.zeros_like(w), 0.0, 1, cfg.reg_param)
    losses = []
    for i in range(1, cfg.num_iterations + 1):
        new_w, loss_i, new_reg, c = step(w, X, y, i, reg)
        if float(c) > 0:
            losses.append(float(loss_i.to(torch.float32)))
        conv = False
        if cfg.convergence_tol > 0 and i > 1 and float(c) > 0:
            diff = torch.linalg.vector_norm(new_w - w)
            wn = torch.linalg.vector_norm(new_w)
            conv = bool(diff < cfg.convergence_tol * torch.clamp(wn,
                                                                 min=1.0))
        w, reg = new_w, new_reg
        if conv:
            break
    return w, np.asarray(losses, np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_make_run_blocks_equal_the_per_iteration_loop(rng, monkeypatch,
                                                     mode, k):
    X, y = (torch.from_numpy(a) for a in _data(rng, n=600, d=8))
    monkeypatch.setattr(tgd, "RUN_BLOCK_ITERS", k)
    for tol, iters in ((0.0, 23), (0.01, 300)):
        cfg = SGDConfig(step_size=0.05, num_iterations=iters,
                        mini_batch_fraction=0.5, convergence_tol=tol,
                        sampling=mode, seed=5)
        g, u = tg.LeastSquaresGradient(), tu.SquaredL2Updater()
        w_ref, h_ref = _per_iteration(g, u, cfg.replace(reg_param=0.01),
                                      X, y)
        run = tgd.make_run(g, u, cfg.replace(reg_param=0.01))
        w, losses, n_rec = run(torch.zeros(8), X, y)
        h = losses[:int(n_rec)].numpy()
        np.testing.assert_array_equal(h, h_ref)
        np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
        if tol:
            assert len(h) < iters  # converged, inside a block for k > 1
        # the cached runner replays the same run
        w2, losses2, n2 = run(torch.zeros(8), X, y)
        assert torch.equal(w2, w) and torch.equal(n2, n_rec)
        assert torch.equal(losses2[:len(h)], losses[:len(h)])


def test_make_run_caches_its_runner_by_tensor_identity(rng):
    X, y = (torch.from_numpy(a) for a in _data(rng, n=200, d=4))
    run = tgd.make_run(tg.LeastSquaresGradient(), tu.SimpleUpdater(),
                       SGDConfig(num_iterations=10, convergence_tol=0.0))
    run(torch.zeros(4), X, y)
    first = run.cache["runner"]
    run(torch.ones(4), X, y)
    assert run.cache["runner"] is first
    run(torch.zeros(4), X.clone(), y)
    assert run.cache["runner"] is not first


@pytest.mark.parametrize("path", ["loop", "observed", "sparse"])
def test_the_cached_runner_holds_its_tensors_weakly(rng, path):
    """Between runs the cached runner keeps its graph and state, not the
    caller's tensors: dropping X frees it.  A second run on the same
    tensors reuses the runner as a repeat, except on sparse X, whose
    transposed CSR the runner built goes at the run's end."""
    import weakref

    Xn, yn = _data(rng, n=200, d=4)
    X, y = torch.from_numpy(Xn), torch.from_numpy(yn)
    o = _opt("bernoulli", iters=12, k=4 if path == "observed" else 1)
    if path == "observed":
        o.set_listener(SGDListener())
    if path == "sparse":
        from tpu_sgd_torch.ops.sparse import to_csr

        X = to_csr(X.to_sparse_csr())  # the optimizer's own layout
    o.optimize_with_history((X, y), np.zeros(4, np.float32))
    o.optimize_with_history((X, y), np.zeros(4, np.float32))
    runner = (o._observed_entry[1] if path == "observed"
              else o._run_cache[1].cache["runner"])
    sparse = path == "sparse"
    assert runner.runs == (1 if sparse else 2) and runner.data is None
    assert runner._owned is None and runner._repeat is not sparse
    ref = weakref.ref(X)
    del X
    assert ref() is None


@pytest.mark.parametrize("last,i0,repeat,adaptive,expect", [
    (20, 1, False, True, False),    # 20 iterations: one block after
    (50, 1, False, True, False),    # 50: four blocks after the warm-up
    (90, 1, False, True, True),     # 90: eight
    (89, 1, False, True, False),
    (100, 11, False, True, True),
    (20, 1, True, True, True),      # a repeated run on the same tensors
    (20, 1, False, False, True),    # the observed drivers always capture
])
def test_a_short_first_run_does_not_warm_up(rng, last, i0, repeat,
                                            adaptive, expect):
    """A first unobserved run too short for ``CAPTURE_MIN_REPLAYS``
    replays after its warm-up block neither times a warm-up nor captures:
    its blocks are the eager loop's."""
    X, y = (torch.from_numpy(a) for a in _data(rng, n=100, d=4))
    run = tgd.make_run(tg.LeastSquaresGradient(), tu.SimpleUpdater(),
                       SGDConfig(num_iterations=10, convergence_tol=0.0))
    run(torch.zeros(4), X, y)
    runner = run.cache["runner"]
    assert runner.k == 10 and not runner.capture and not runner.warm
    runner.adaptive, runner._repeat, runner._last = adaptive, repeat, last
    assert runner._may_capture(i0) is expect


@pytest.mark.parametrize("replays,host_ms,card_ms,expect", [
    (1, 10.0, 9.98, False),   # host-paced, but one replay never repays
    (7, 10.0, 9.98, False),
    (8, 10.0, 9.98, True),    # host-paced, eight replays ahead
    (9, 15.4, 15.39, True),   # the exact statistics at 100 iterations
    (9, 10.0, 10.9, True),    # within the 10% slack
    (9, 10.0, 11.2, False),   # the card paced the block
    (9, 5.0, 14.0, False),    # Bernoulli at 100 iterations
])
def test_capture_repays_rule(replays, host_ms, card_ms, expect):
    """The unobserved run captures when the card waited on the host in
    the warm-up block and ``CAPTURE_MIN_REPLAYS`` replays are ahead."""
    assert tgd.CAPTURE_MIN_REPLAYS == 8
    assert tgd._capture_repays(replays, host_ms, card_ms) is expect


def test_the_run_converges_at_the_true_iteration_inside_a_block():
    """The device flag freezes the rest of the block: the history ends at
    the converged iteration, the count equals it, and the weights are
    that iteration's.  (On these data the run converges at iteration
    25, inside a block.)"""
    X, y = _data(np.random.default_rng(1), n=512, d=8)
    o = _opt("sliced", iters=400, tol=0.01, step=0.05)
    w, h = o.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert len(h) % tgd.RUN_BLOCK_ITERS != 0
    o1 = _opt("sliced", iters=400, tol=0.01, step=0.05)
    o1.set_listener(SGDListener())
    w1, h1 = o1.optimize_with_history((X, y), np.zeros(8, np.float32))
    np.testing.assert_array_equal(h, h1)
    np.testing.assert_array_equal(w.numpy(), w1.numpy())


def test_sampling_depends_only_on_seed_and_iteration_in_blocks(rng):
    """A block draws iteration i's sample from (seed, i) alone: K = 4
    blocks resumed at 6 (off the grid) draw what a single run draws."""
    X, y = _data(rng, n=400, d=6)
    w_ref, h_ref = _opt("indexed", iters=14, k=4).set_listener(
        SGDListener()).optimize_with_history((X, y), np.zeros(6, np.float32))
    o = _opt("indexed", iters=14, k=4)
    sup = TrainingSupervisor(o, checkpoint_manager=CheckpointManager(
        str(__import__("tempfile").mkdtemp())), checkpoint_every=5,
        retry=RetryPolicy(max_attempts=3, base_backoff_s=0.0),
        install_signal_handlers=False)
    with inject_faults({"checkpoint.save": fail_nth(2)}):
        res = sup.run((X, y), np.zeros(6, np.float32))
    assert res.completed and res.attempts == 2
    np.testing.assert_array_equal(res.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res.loss_history, h_ref)


def test_capture_rule(rng):
    """Blocks are captured on a CUDA device only, and never when the
    window of sliced sampling is sliced on the host (a gradient without
    a kernel rule)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = SGDConfig(mini_batch_fraction=0.5, sampling="sliced")
    ls = tg.LeastSquaresGradient()
    multi = tg.MultinomialLogisticGradient(3)
    assert tgd._captures(ls, cfg, cuda) and not tgd._captures(ls, cfg, cpu)
    assert not tgd._captures(multi, cfg, cuda)
    assert tgd._captures(multi, cfg.replace(sampling="bernoulli"), cuda)
    assert tgd._captures(ls, cfg.replace(mini_batch_fraction=1.0), cuda)


def test_captured_launches_move_to_the_replays():
    """The launches a capture records leave the counts and come back with
    each replay, by wrapper and by source."""
    ck.reset_launch_counts()
    # an eager launch before
    ck.count_launch(ck.fused_window_sums, source="window_sums")
    with ck.captured_launches() as record:
        for _ in range(3):
            ck.count_launch(ck.fused_window_sums, source="window_sums")
    assert ck.launch_counts()["fused_window_sums"] == 1
    assert record["wrappers"]["fused_window_sums"] == 3
    assert record["sources"] == {"fused_sums": 0, "window_sums": 3}
    ck.add_replayed_launches(record)
    ck.add_replayed_launches(record)
    assert ck.launch_counts()["fused_window_sums"] == 7
    assert ck.kernel_launch_counts() == {"fused_sums": 0, "window_sums": 7}
    ck.reset_launch_counts()


def test_csr_launches_by_columns_move_to_the_replays():
    """The CSR wrappers' counts by right-hand column count follow the
    same capture and replay rule as their totals."""
    ck.reset_launch_counts()
    ck._count_csr(ck.csr_margins, torch.zeros(4))  # an eager launch before
    with ck.captured_launches() as record:
        ck._count_csr(ck.csr_margins, torch.zeros(4, 25))
        ck._count_csr(ck.csr_grad_sum, torch.zeros(4))
    assert ck.csr_launch_counts(by_columns=True) == {"csr_margins/1": 1}
    assert record["csr_columns"] == {"csr_margins/25": 1,
                                     "csr_grad_sum/1": 1}
    ck.add_replayed_launches(record)
    ck.add_replayed_launches(record)
    assert ck.csr_launch_counts(by_columns=True) == {
        "csr_margins/1": 1, "csr_margins/25": 2, "csr_grad_sum/1": 2}
    assert ck.csr_launch_counts() == {"csr_margins": 3, "csr_grad_sum": 2}
    ck.reset_launch_counts()
    assert ck.csr_launch_counts(by_columns=True) == {}


def test_the_cpu_path_captures_nothing(rng):
    X, y = _data(rng, n=300, d=6)
    o = _opt("sliced", iters=20, k=4).set_listener(SGDListener())
    o.optimize_with_history((X, y), np.zeros(6, np.float32))
    runner = o._observed_entry[1]
    assert runner.graph is None and runner.replays == 0
    assert runner.eager_blocks == 5


# ---- observed driver: K = 1 against K >= 2 -------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_stepwise_fused_matches_legacy_with_events(rng, mode):
    X, y = _data(rng, n=800, d=10)

    def run(k):
        rec = _Recorder()
        o = _opt(mode, iters=10, k=k, seed=3).set_listener(rec)
        w, h = o.optimize_with_history((X, y), np.zeros(10, np.float32))
        return w, h, rec

    w1, h1, rec1 = run(1)
    w4, h4, rec = run(4)
    assert len(h4) == len(h1) == 10
    np.testing.assert_array_equal(w4.numpy(), w1.numpy())
    np.testing.assert_array_equal(h4, h1)
    assert [e.iteration for e in rec.events] == list(range(1, 11))
    np.testing.assert_array_equal(
        np.asarray([e.loss for e in rec.events], np.float32), h4)
    key = lambda e: (e.iteration, e.loss, e.weight_delta_norm,  # noqa
                     e.mini_batch_size)
    assert [key(e) for e in rec.events] == [key(e) for e in rec1.events]
    assert rec.ended is not None and rec.ended.num_iterations == 10


def test_observed_equals_the_unobserved_run(rng):
    X, y = _data(rng, n=500, d=8)
    w, h = _opt("bernoulli", iters=17).optimize_with_history(
        (X, y), np.zeros(8, np.float32))
    for k in (1, 4):
        wo, ho = _opt("bernoulli", iters=17, k=k).set_listener(
            SGDListener()).optimize_with_history((X, y),
                                                 np.zeros(8, np.float32))
        np.testing.assert_array_equal(wo.numpy(), w.numpy())
        np.testing.assert_array_equal(ho, h)


def test_stepwise_fused_convergence_reports_true_iteration():
    # data on which the run converges inside a block (iteration 25)
    X, y = _data(np.random.default_rng(1), n=512, d=8)

    def run(k):
        o = _opt("sliced", iters=400, k=k, tol=0.01, step=0.05)
        return o.set_listener(SGDListener()).optimize_with_history(
            (X, y), np.zeros(8, np.float32))

    w1, h1 = run(1)
    w8, h8 = run(8)
    assert len(h8) == len(h1)
    assert len(h8) % 8 != 0  # genuinely mid-block
    np.testing.assert_array_equal(w8.numpy(), w1.numpy())


def test_stepwise_fused_checkpoint_cadence_matches_legacy(rng, tmp_path):
    X, y = _data(rng, n=400, d=6)

    def run(k, sub):
        o = _opt("sliced", iters=10, k=k, seed=3).set_checkpoint(
            CheckpointManager(str(tmp_path / sub), keep=100), every=3)
        o.optimize_with_history((X, y), np.zeros(6, np.float32))
        return sorted(int(f[-12:-4]) for f in
                      glob.glob(str(tmp_path / sub / "ckpt_*.npz")))

    assert run(1, "legacy") == run(4, "fused") == [3, 6, 9, 10]
    for it in (3, 6, 9, 10):
        a = CheckpointManager(str(tmp_path / "legacy")).restore_version(it)
        b = CheckpointManager(str(tmp_path / "fused")).restore_version(it)
        for key in ("weights", "loss_history"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["reg_val"] == b["reg_val"]
        assert a["config_key"] == b["config_key"]


@pytest.mark.parametrize("mode", MODES)
def test_fused_preempt_resumes_bitwise_all_modes(rng, mode, tmp_path):
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    w_ref, h_ref = _opt(mode, iters=18, k=4).optimize_with_history(
        (X, y), w0)

    class StopSecond:
        def __init__(self):
            self.polls = 0

        def __call__(self):
            self.polls += 1
            return self.polls == 2

    opt = (_opt(mode, iters=18, k=4)
           .set_checkpoint(CheckpointManager(str(tmp_path / mode)),
                           every=100))
    opt.set_stop_signal(StopSecond())
    with pytest.raises(TrainingPreempted) as ei:
        opt.optimize_with_history((X, y), w0)
    assert ei.value.iteration == 8  # the SECOND block boundary
    opt.set_stop_signal(None)
    w_res, h_res = opt.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w_res.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h_res, h_ref)


def test_supervisor_preempts_fused_run_at_boundary(rng, tmp_path):
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    w_ref, h_ref = _opt("sliced", iters=16, k=4).optimize_with_history(
        (X, y), w0)
    opt = _opt("sliced", iters=16, k=4)
    sup = TrainingSupervisor(
        opt, checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=100, install_signal_handlers=False)

    class Stop:
        def on_run_start(self, c): ...

        def on_iteration(self, ev):
            if ev.iteration == 6:
                sup.request_preempt()

        def on_run_end(self, ev): ...

    opt.set_listener(Stop())
    res = sup.run((X, y), w0)
    assert res.status == "preempted" and res.preempted_at == 8
    assert CheckpointManager(str(tmp_path)).latest_version() == 8
    opt.set_listener(None)
    res2 = sup.run((X, y), w0)
    assert res2.completed
    np.testing.assert_array_equal(res2.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res2.loss_history, h_ref)


def test_fused_crash_resume_unaligned_grid_bitwise(rng, tmp_path):
    """A crash at the second checkpoint save (iteration 6) resumes from
    iteration 3's checkpoint: off the K = 4 block grid, and still bitwise
    the uninterrupted run."""
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    w_ref, h_ref = _opt("sliced", iters=14, k=4).optimize_with_history(
        (X, y), w0)
    sup = TrainingSupervisor(
        _opt("sliced", iters=14, k=4),
        checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=3,
        retry=RetryPolicy(max_attempts=4, base_backoff_s=0.0),
        install_signal_handlers=False)
    with inject_faults({"checkpoint.save": fail_nth(2)}):
        res = sup.run((X, y), w0)
    assert res.completed and res.attempts == 2
    np.testing.assert_array_equal(res.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res.loss_history, h_ref)


def test_set_superstep_validates():
    with pytest.raises(ValueError, match="superstep"):
        GradientDescent(device=CPU).set_superstep(0)
    assert GradientDescent(device=CPU).set_superstep(8).superstep == 8


@pytest.mark.parametrize("k,c", [(1, 0), (4, 0), (4, 2)])
def test_stepwise_numerics_reports_true_iteration(rng, k, c):
    """The observed driver checks one loss at a time: the error names the
    ACTUAL diverging iteration, not 'iteration 1', at any K and C."""
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = (X @ rng.uniform(-1, 1, 8).astype(np.float32)).astype(np.float32)
    opt = (GradientDescent(tg.LeastSquaresGradient(), tu.SimpleUpdater(),
                           device=CPU)
           .set_step_size(1e12).set_num_iterations(10)
           .set_mini_batch_fraction(1.0).set_check_numerics(True)
           .set_listener(SGDListener()).set_superstep(k))
    if c:
        opt.set_residency(c)
    with pytest.raises(FloatingPointError) as exc:
        opt.optimize_with_history((X, y), np.zeros(8, np.float32))
    reported = int(re.search(r"iteration (\d+)", str(exc.value)).group(1))
    assert reported > 1
    losses = []
    try:
        (GradientDescent(device=CPU).set_step_size(1e12)
         .set_num_iterations(10).set_mini_batch_fraction(1.0)
         .set_listener(type("L", (SGDListener,), {
             "on_iteration": lambda self, e: losses.append(e.loss)})())
         .optimize_with_history((X, y), np.zeros(8, np.float32)))
    except FloatingPointError:
        pass
    first_bad = next(i for i, v in enumerate(losses) if not np.isfinite(v))
    assert reported == first_bad + 1


def test_chunk_iters_warns_on_the_observed_path(rng):
    X, y = _data(rng, n=4096, d=4)
    o = (_opt("sliced", iters=4).set_sufficient_stats(True)
         .set_gram_options(block_rows=256, aligned=True, chunk_iters=2)
         .set_listener(SGDListener()))
    with pytest.warns(RuntimeWarning, match="chunk_iters is ignored"):
        o.optimize_with_history((X, y), np.zeros(4, np.float32))


# ---- across packages --------------------------------------------------------

def _jax_opt(mode, iters, tol, frac, listener):
    o = (jgd.GradientDescent().set_num_iterations(iters).set_step_size(0.05)
         .set_mini_batch_fraction(frac).set_sampling(mode)
         .set_convergence_tol(tol).set_seed(7).set_listener(listener))
    return o


def _inject_jax_starts(monkeypatch, seed, n, m, iters):
    key = jax.random.PRNGKey(seed)
    starts = [int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                                     max(1, n - m + 1)))
              for i in range(1, iters + 1)]
    it = iter(starts)
    monkeypatch.setattr(
        tgd, "_window_start",
        lambda gen, n, m, device: torch.tensor([next(it)], device=device))


@pytest.mark.parametrize("k,c", [(1, 0), (4, 0), (4, 2)])
@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_observed_driver_matches_the_jax_package(rng, monkeypatch,
                                                 tmp_path, k, c, frac):
    """The port's observed driver at K and C against the JAX package's
    per-iteration observed driver, with the same samples (full batch, or
    the JAX window starts injected): the same convergence iteration,
    event count and checkpoint iterations, losses per step within the
    tight tier."""
    X, y = _data(rng, n=512, d=8)
    iters = 300
    jrec, trec = _Recorder(), _Recorder()
    from tpu_sgd.utils.checkpoint import CheckpointManager as JCM

    jo = _jax_opt("sliced", iters, 0.01, frac, jrec)
    jo.set_checkpoint(JCM(str(tmp_path / "j"), keep=1000), every=7)
    jw, jh = jo.optimize_with_history((X, y), np.zeros(8, np.float32))
    if frac < 1.0:
        _inject_jax_starts(monkeypatch, 7, 512, round(frac * 512), iters)
    to = _opt("sliced", iters=iters, k=k, tol=0.01, step=0.05, frac=frac)
    if c:
        to.set_residency(c)
    to.set_listener(trec).set_checkpoint(
        CheckpointManager(str(tmp_path / "t"), keep=1000), every=7)
    tw, th = to.optimize_with_history((X, y), np.zeros(8, np.float32))
    assert len(th) == len(jh) < iters
    assert len(trec.events) == len(jrec.events)
    assert trec.ended.converged_early == jrec.ended.converged_early
    np.testing.assert_allclose(th, jh, rtol=2e-4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4,
                               atol=2e-3)
    names = lambda sub: sorted(f[-12:-4] for f in glob.glob(  # noqa
        str(tmp_path / sub / "ckpt_*.npz")))
    assert names("t") == names("j")
