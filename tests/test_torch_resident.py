"""The port's device-resident driver (``set_residency``,
``tpu_sgd_torch/optimize/resident_driver.py``), on the CPU: the twins of the
resident-path cases of ``tests/test_resident.py``.

Contracts pinned here (within the port, bitwise): windows of C blocks give
the superstep driver's trajectory, history, listener events and checkpoint
contents in every sampling mode; convergence lands at the true iteration
inside a window; a tail window (N not dividing C·K) replays without
artifacts; the window hook fires once a full window (``train.io_callback``
counts it) and polls the stop signal there, so a stop lands on a window
boundary and the resumed run is bitwise; a fault in the window hook heals
through the retry policy, or re-raises with its own class for the
supervisor to resume from.
"""

import glob

import numpy as np
import pytest

from tpu_sgd_torch.obs import counters, spans
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.optimize.resident_driver import (
    ResidentBookkeeper,
    ResidentLoop,
)
from tpu_sgd_torch.reliability import (
    FaultInjected,
    RetryPolicy,
    TrainingPreempted,
    TrainingSupervisor,
    fail_nth,
    inject_faults,
)
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import SGDListener

MODES = ("sliced", "indexed", "bernoulli")
CPU = "cpu"


def _data(rng, n=1000, d=12):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _opt(mode="sliced", iters=22, k=4, c=0, seed=7, listener=True):
    o = (GradientDescent(device=CPU)
         .set_num_iterations(iters).set_step_size(0.1)
         .set_mini_batch_fraction(0.5).set_sampling(mode)
         .set_convergence_tol(0.0).set_seed(seed)
         .set_superstep(k))
    if listener:
        o.set_listener(SGDListener())
    if c:
        o.set_residency(c)
    return o


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


# ---- bitwise against the superstep driver -----------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_stepwise_resident_bitwise_vs_superstep_all_modes(rng, mode):
    X, y = _data(rng)
    w0 = np.zeros(12, np.float32)
    wS, hS = _opt(mode, c=0).optimize_with_history((X, y), w0)
    wR, hR = _opt(mode, c=2).optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(wR.numpy(), wS.numpy())
    np.testing.assert_array_equal(hR, hS)


def test_resident_listener_events_match_superstep(rng):
    X, y = _data(rng, n=500, d=8)

    def run(c):
        rec = _Recorder()
        o = _opt("indexed", iters=10, k=4, c=c, listener=False)
        o.set_listener(rec)
        w, h = o.optimize_with_history((X, y), np.zeros(8, np.float32))
        return w, h, rec

    _, _, recS = run(0)
    _, _, recR = run(2)
    assert [e.iteration for e in recR.events] == list(range(1, 11))
    key = lambda e: (e.iteration, e.loss, e.weight_delta_norm,  # noqa
                     e.mini_batch_size)
    assert [key(e) for e in recR.events] == [key(e) for e in recS.events]
    assert recR.ended is not None and recR.ended.num_iterations == 10


def test_resident_checkpoint_cadence_matches_superstep(rng, tmp_path):
    X, y = _data(rng, n=400, d=6)

    def run(c, sub):
        o = _opt("sliced", iters=10, k=4, c=c, listener=False)
        o.set_checkpoint(CheckpointManager(str(tmp_path / sub),
                                           keep=100), every=3)
        o.optimize_with_history((X, y), np.zeros(6, np.float32))
        return sorted(int(f[-12:-4]) for f in
                      glob.glob(str(tmp_path / sub / "ckpt_*.npz")))

    assert run(0, "superstep") == run(2, "resident") == [3, 6, 9, 10]
    for it in (3, 6, 9, 10):
        sS = CheckpointManager(str(tmp_path / "superstep")).restore_version(
            it)
        sR = CheckpointManager(str(tmp_path / "resident")).restore_version(
            it)
        np.testing.assert_array_equal(sR["weights"], sS["weights"])
        np.testing.assert_array_equal(sR["loss_history"],
                                      sS["loss_history"])
        assert sR["reg_val"] == sS["reg_val"]


def test_resident_convergence_detected_at_true_iteration():
    # data on which the run converges inside a window (iteration 25)
    X, y = _data(np.random.default_rng(1), n=512, d=8)
    w0 = np.zeros(8, np.float32)

    def run(c):
        o = (GradientDescent(device=CPU).set_num_iterations(400)
             .set_step_size(0.05).set_mini_batch_fraction(0.5)
             .set_sampling("sliced").set_convergence_tol(0.01)
             .set_seed(7).set_superstep(8).set_listener(SGDListener()))
        if c:
            o.set_residency(c)
        return o.optimize_with_history((X, y), w0)

    wS, hS = run(0)
    wR, hR = run(4)
    assert len(hR) == len(hS)
    assert len(hR) % (4 * 8) != 0  # genuinely mid-window
    np.testing.assert_array_equal(wR.numpy(), wS.numpy())
    np.testing.assert_array_equal(hR, hS)


@pytest.mark.parametrize("iters", (7, 19, 23, 37))
def test_resident_ring_tail_when_n_not_dividing_window(rng, iters):
    X, y = _data(rng, n=400, d=6)
    w0 = np.zeros(6, np.float32)
    wS, hS = _opt("indexed", iters=iters, k=4, c=0) \
        .optimize_with_history((X, y), w0)
    wR, hR = _opt("indexed", iters=iters, k=4, c=3) \
        .optimize_with_history((X, y), w0)
    assert len(hR) == iters
    np.testing.assert_array_equal(wR.numpy(), wS.numpy())
    np.testing.assert_array_equal(hR, hS)


# ---- windows ---------------------------------------------------------------

@pytest.mark.parametrize("iters", (32, 64, 70))
def test_window_hook_fires_once_a_full_window(rng, iters):
    """``train.io_callback`` counts the full windows, as the JAX driver's
    callback does; a partial last window replays without the hook."""
    X, y = _data(rng, n=400, d=6)
    o = _opt("sliced", iters=iters, k=4, c=2)
    counters.reset()
    counters.enable()
    try:
        with counters.deltas() as d:
            _, h = o.optimize_with_history((X, y), np.zeros(6, np.float32))
            got = d.get()
    finally:
        counters.disable()
        counters.reset()
    assert len(h) == iters
    assert got["train.io_callback"]["n"] == iters // 8


def test_resident_loop_counts_windows_and_replays_all_steps(rng):
    import torch

    X, y = (torch.from_numpy(a) for a in _data(rng, n=400, d=6))
    o = _opt("sliced", iters=32, k=4, c=2)
    o.optimize_with_history((X, y), np.zeros(6, np.float32))
    runner = o._observed_entry[1]
    runner.state.reset(torch.zeros(6), 0.0, 1)
    runner.begin(X, y, None, None, 32)
    hooks = ResidentBookkeeper(o.config, 4, 2, losses=[], reg_val=0.0,
                               start_iter=1)
    ResidentLoop(runner, o.config, 4, 2).run(1, hooks)
    assert len(hooks.losses) == 32 and hooks.windows_fired == 4
    assert hooks.replayed_through == 32


def test_window_spans_carry_each_window_start(rng):
    X, y = _data(rng, n=400, d=6)
    o = _opt("sliced", iters=64, k=4, c=2)
    o.optimize_with_history((X, y), np.zeros(6, np.float32))  # warm

    class Sink:
        def __init__(self):
            self.records = []

        def emit(self, kind, payload):
            self.records.append((kind, payload))

    sink = Sink()
    spans.enable_tracing(sink)
    try:
        o.optimize_with_history((X, y), np.zeros(6, np.float32))
    finally:
        spans.disable_tracing()
    wins = [p for k, p in sink.records
            if k == "trace_span" and p["name"] == "train.window"]
    assert [w["i0"] for w in wins] == [1 + 8 * i for i in range(8)]
    assert sum(1 for k, p in sink.records if k == "trace_span"
               and p["name"] == "train.resident_dispatch") == 1


# ---- stop signal / preemption ----------------------------------------------

def test_resident_stop_latency_bounded_by_cadence_window(rng, tmp_path):
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    K, C = 4, 2
    wRef, hRef = _opt("sliced", iters=24, k=K, c=C) \
        .optimize_with_history((X, y), w0)
    o = _opt("sliced", iters=24, k=K, c=C, listener=False)
    o.set_checkpoint(CheckpointManager(str(tmp_path)), every=100)
    o.set_stop_signal(lambda: True)
    with pytest.raises(TrainingPreempted) as ei:
        o.optimize_with_history((X, y), w0)
    assert ei.value.iteration == C * K  # first window boundary
    assert CheckpointManager(str(tmp_path)).latest_version() == C * K
    o.set_stop_signal(None)
    wR, hR = o.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(wR.numpy(), wRef.numpy())
    np.testing.assert_array_equal(hR, hRef)


@pytest.mark.parametrize("mode", MODES)
def test_resident_preempt_resume_bitwise_all_modes(rng, mode, tmp_path):
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    wRef, hRef = _opt(mode, iters=30, k=4, c=2) \
        .optimize_with_history((X, y), w0)

    class StopSecond:
        def __init__(self):
            self.polls = 0

        def __call__(self):
            self.polls += 1
            return self.polls == 2

    o = _opt(mode, iters=30, k=4, c=2, listener=False)
    o.set_checkpoint(CheckpointManager(str(tmp_path / mode)), every=100)
    o.set_stop_signal(StopSecond())
    with pytest.raises(TrainingPreempted) as ei:
        o.optimize_with_history((X, y), w0)
    assert ei.value.iteration == 16  # second C*K window boundary
    o.set_stop_signal(None)
    wR, hR = o.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(wR.numpy(), wRef.numpy())
    np.testing.assert_array_equal(hR, hRef)


# ---- reliability: io.resident_callback failpoint ---------------------------

def test_resident_callback_failpoint_heals_via_retry(rng):
    """A fault in the window hook heals through the retry policy before
    any bookkeeping mutates; without one it re-raises with its own class.
    (The JAX package sets the policy with ``set_ingest_options(retry=)``,
    which waits for ROADMAP A9: here the attribute is set.)"""
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    wRef, hRef = _opt("indexed", iters=24, k=4, c=2) \
        .optimize_with_history((X, y), w0)
    o = _opt("indexed", iters=24, k=4, c=2)
    o.ingest_retry_policy = RetryPolicy(max_attempts=3, base_backoff_s=0.0)
    with inject_faults({"io.resident_callback": fail_nth(2)}):
        w, h = o.optimize_with_history((X, y), w0)
        assert fp.triggers("io.resident_callback") == 1
    np.testing.assert_array_equal(w.numpy(), wRef.numpy())
    np.testing.assert_array_equal(h, hRef)
    with inject_faults({"io.resident_callback": fail_nth(1)}):
        with pytest.raises(FaultInjected):
            _opt("indexed", iters=24, k=4, c=2) \
                .optimize_with_history((X, y), w0)


def test_resident_crash_resume_bitwise_via_supervisor(rng, tmp_path):
    X, y = _data(rng, n=512, d=8)
    w0 = np.zeros(8, np.float32)
    wRef, hRef = _opt("sliced", iters=32, k=4, c=2) \
        .optimize_with_history((X, y), w0)
    sup = TrainingSupervisor(
        _opt("sliced", iters=32, k=4, c=2, listener=False),
        checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=5,
        retry=RetryPolicy(max_attempts=4, base_backoff_s=0.0),
        install_signal_handlers=False)
    # the 2nd window's hook fault crashes the run; the resume replays
    # from iteration 5's checkpoint, off the original window grid
    with inject_faults({"io.resident_callback": fail_nth(2)}):
        res = sup.run((X, y), w0)
    assert res.completed and res.attempts == 2
    np.testing.assert_array_equal(res.weights.numpy(), wRef.numpy())
    np.testing.assert_array_equal(res.loss_history, hRef)


def test_listener_error_in_the_window_keeps_its_class(rng):
    X, y = _data(rng, n=256, d=6)

    class Boom(SGDListener):
        def on_iteration(self, e):
            if e.iteration == 3:
                raise KeyError("listener")

    o = _opt("sliced", iters=24, k=4, c=2, listener=False)
    o.set_listener(Boom())
    with pytest.raises(KeyError, match="listener"):
        o.optimize_with_history((X, y), np.zeros(6, np.float32))


# ---- knobs -----------------------------------------------------------------

def test_set_residency_validates():
    with pytest.raises(ValueError, match="cadence 1"):
        GradientDescent(device=CPU).set_residency(1)
    with pytest.raises(ValueError, match="cadence"):
        GradientDescent(device=CPU).set_residency(-2)
    assert GradientDescent(device=CPU).set_residency(4).resident_cadence == 4
    assert GradientDescent(device=CPU).set_residency(0).resident_cadence == 0


def test_residency_without_superstep_warns_and_falls_back(rng):
    X, y = _data(rng, n=256, d=6)
    o = _opt("sliced", iters=6, k=1, c=2)
    with pytest.warns(RuntimeWarning, match="fused superstep executor"):
        w, h = o.optimize_with_history((X, y), np.zeros(6, np.float32))
    assert len(h) == 6


def test_extra_carried_state_is_a_later_slice():
    """Extra carried state (the compressed wire's error feedback) arrived
    with the ingest slice: a seventh ring leaf goes to ``extras_cb``
    before the window's replay, and ``last_extra`` follows the replayed
    boundary (the streamed drivers' use is pinned in
    ``tests/test_torch_streamed.py``)."""
    from tpu_sgd_torch.config import SGDConfig

    got = []
    hooks = ResidentBookkeeper(SGDConfig(num_iterations=6,
                                         convergence_tol=0.0), 2, 2,
                               losses=[], reg_val=0.0, start_iter=1,
                               extras_cb=lambda i0, ex: got.append(
                                   (i0, ex.copy())))
    ws = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    ones = np.ones(4, np.float32)
    exs = 10 + ws
    hooks.replay(1, (ws, ones, ones, ones, ones, ones, exs), 2)
    assert got and got[0][0] == 1
    np.testing.assert_array_equal(got[0][1], exs)
    np.testing.assert_array_equal(hooks.last_extra, exs[3])
    assert hooks.replayed_through == 4 and len(hooks.losses) == 4


def test_k1_k8_and_residency_give_equal_histories_events_and_checkpoints(
        rng, tmp_path):
    """The observed driver's three modes at 72 iterations (two full
    windows of 4 blocks of 8, then one block), a listener and checkpoints
    every 5: the same history, events (wall times aside) and checkpoint
    contents, bitwise."""
    from tpu_sgd_torch.utils.events import CollectingListener

    X, y = _data(rng, n=600, d=8)
    runs = {}
    for name, (k, c) in {"k1": (1, 0), "k8": (8, 0),
                         "k8_c4": (8, 4)}.items():
        lis = CollectingListener()
        o = _opt("sliced", iters=72, k=k, c=c, listener=False)
        o.set_listener(lis).set_checkpoint(
            CheckpointManager(str(tmp_path / name), keep=100), every=5)
        w, h = o.optimize_with_history((X, y), np.zeros(8, np.float32))
        files = {}
        for f in sorted(glob.glob(str(tmp_path / name / "ckpt_*.npz"))):
            with np.load(f) as z:
                files[f[-17:]] = {key: z[key] for key in z.files}
        runs[name] = (w.numpy(), h, [
            (e.iteration, e.loss, e.weight_delta_norm, e.mini_batch_size)
            for e in lis.iterations], files)
    ref = runs["k1"]
    assert len(ref[3]) == 15 and len(ref[2]) == 72
    for name in ("k8", "k8_c4"):
        w, h, events, files = runs[name]
        np.testing.assert_array_equal(w, ref[0])
        np.testing.assert_array_equal(h, ref[1])
        assert events == ref[2]
        assert files.keys() == ref[3].keys()
        for f, entries in files.items():
            assert entries.keys() == ref[3][f].keys()
            for key, value in entries.items():
                np.testing.assert_array_equal(value, ref[3][f][key])
