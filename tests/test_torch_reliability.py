"""The port's reliability planes (``tpu_sgd_torch/reliability``,
``utils/checkpoint.py``, ``io/integrity.py``) and streaming checkpoints, on
the CPU: the twins of the failpoint, retry, checkpoint and supervisor
cases of ``tests/test_reliability.py`` and of the checkpoint cases of
``tests/test_streaming.py``, and checkpoints across the two packages.

Tolerances: within the port every resumed run is held bitwise to the
uninterrupted one.  Across packages (a checkpoint written by one and
resumed by the other) the tiers of ROADMAP "How a slice counts as done"
apply: checkpoint iterations, history length and the config key exact;
at full batch the resumed history rtol 2e-4 and the weights rtol 2e-4 /
atol 2e-3 against the other package's uninterrupted run.
"""

import glob
import os
import time
import warnings

import numpy as np
import pytest
import torch

import tpu_sgd_torch.reliability.failpoints as fp
from tpu_sgd_torch.io.integrity import IntegrityError
from tpu_sgd_torch.models.streaming import (
    StreamingLinearRegressionWithSGD,
    StreamingLogisticRegressionWithSGD,
)
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.reliability import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    FaultInjected,
    RetriesExhausted,
    RetryPolicy,
    TrainingPreempted,
    TrainingSupervisor,
    corrupt_nth,
    fail_nth,
    fail_prob,
    inject_faults,
    inject_latency,
)
from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import (
    CollectingListener,
    JsonLinesEventLog,
    ReliabilityEvent,
)

CPU = "cpu"


def _data(rng, n=512, d=8):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (X @ w + 0.01 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _opt(iters=16, sampling="sliced", seed=7, k=1):
    return (GradientDescent(device=CPU)
            .set_num_iterations(iters).set_step_size(0.1)
            .set_mini_batch_fraction(0.5).set_sampling(sampling)
            .set_convergence_tol(0.0).set_seed(seed).set_superstep(k))


# -- failpoints -----------------------------------------------------------------

def test_fail_nth_is_one_shot():
    with inject_faults({"t.site": fail_nth(2)}):
        fp.failpoint("t.site")  # hit 1: pass
        with pytest.raises(FaultInjected):
            fp.failpoint("t.site")  # hit 2: trigger
        fp.failpoint("t.site")  # hit 3: healed (one-shot)
        assert fp.hits("t.site") == 3
        assert fp.triggers("t.site") == 1
    assert not fp.is_enabled()
    assert fp.hits("t.site") == 0  # counters cleared on deactivate


def test_fail_prob_replays_bitwise_from_seed():
    def pattern():
        out = []
        with inject_faults({"t.p": fail_prob(0.3, seed=5)}):
            for _ in range(64):
                try:
                    fp.failpoint("t.p")
                    out.append(0)
                except FaultInjected:
                    out.append(1)
        return out

    a, b = pattern(), pattern()
    assert a == b  # seeded stream: identical schedule
    assert 0 < sum(a) < 64  # actually fires, not always


def test_fail_prob_schedule_matches_the_jax_package():
    """The copied module draws from the same seeded stream."""
    from tpu_sgd.reliability import failpoints as jfp

    def pattern(mod):
        out = []
        with mod.inject_faults({"t.p": mod.fail_prob(0.3, seed=11)}):
            for _ in range(64):
                try:
                    mod.failpoint("t.p")
                    out.append(0)
                except mod.FaultInjected:
                    out.append(1)
        return out

    assert pattern(fp) == pattern(jfp)


def test_inject_latency_delays_without_raising():
    with inject_faults({"t.l": inject_latency(30.0)}):
        t0 = time.perf_counter()
        fp.failpoint("t.l")
        assert time.perf_counter() - t0 >= 0.025


def test_custom_exception_class():
    with inject_faults({"t.e": fail_nth(1, exc=OSError)}):
        with pytest.raises(OSError):
            fp.failpoint("t.e")


def test_spec_rejects_conflicting_modes():
    with pytest.raises(ValueError):
        fp.FailpointSpec(nth=2, prob=0.5)
    with pytest.raises(ValueError):
        fp.FailpointSpec(prob=1.5)
    with pytest.raises(ValueError):
        fp.corrupt_nth(1, kind="gzip")


def test_disabled_failpoint_is_a_measured_noop():
    assert not fp.is_enabled()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        fp.failpoint("io.resident_callback")
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 2e-6, f"disabled failpoint costs {per_call*1e9:.0f}ns"


@pytest.mark.parametrize("kind", ["bitflip", "nan", "truncate"])
def test_corruptpoint_damages_a_copy_and_verify_detects_it(kind):
    from tpu_sgd_torch.io.integrity import seal, verify

    frame = (np.arange(16, dtype=np.float32), np.ones(3, np.float32))
    crc = seal(*frame)
    with inject_faults({"t.c": corrupt_nth(1, kind=kind)}):
        bad = fp.corruptpoint("t.c", frame)
        good = fp.corruptpoint("t.c", frame)  # one-shot
    assert good is frame
    np.testing.assert_array_equal(frame[0], np.arange(16, dtype=np.float32))
    verify("t.c", crc, *frame)
    with pytest.raises(IntegrityError, match="t.c"):
        verify("t.c", crc, *bad)


def test_hook_sites_exist_in_their_modules():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for site, path in fp.HOOK_SITES.items():
        with open(os.path.join(root, path)) as f:
            assert f'failpoint("{site}")' in f.read(), (site, path)


# -- retry / deadline / breaker ---------------------------------------------------

def test_retry_policy_heals_transient_fault():
    calls = []

    def flaky():
        calls.append(1)
        fp.failpoint("t.r")
        return 42

    pol = RetryPolicy(max_attempts=3, base_backoff_s=1e-4, seed=0)
    with inject_faults({"t.r": fail_nth(1)}):
        assert pol.call(flaky) == 42
    assert len(calls) == 2


def test_retry_policy_exhausts_with_cause():
    pol = RetryPolicy(max_attempts=3, base_backoff_s=1e-4)

    def always():
        raise OSError("disk on fire")

    with pytest.raises(RetriesExhausted) as ei:
        pol.call(always)
    assert isinstance(ei.value.__cause__, OSError)


def test_retry_policy_nonretryable_propagates_immediately():
    calls = []

    def fatal():
        calls.append(1)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=5, base_backoff_s=1e-4).call(fatal)
    assert len(calls) == 1


def test_retry_backoff_seeded_capped_and_equal_to_the_jax_schedule():
    from tpu_sgd.reliability.retry import RetryPolicy as JRetry

    kw = dict(base_backoff_s=0.1, multiplier=2.0, max_backoff_s=0.3,
              jitter=0.5, seed=3)
    seq_a = [RetryPolicy(**kw).backoff_s(k) for k in range(1, 6)]
    a = RetryPolicy(**kw)
    seq_b = [a.backoff_s(k) for k in range(1, 6)]
    j = JRetry(**kw)
    assert seq_b == [j.backoff_s(k) for k in range(1, 6)]
    assert seq_a[0] == seq_b[0]
    assert all(0 < s <= 0.3 for s in seq_b)
    assert seq_b[0] >= 0.05


def test_deadline_check_and_retry_integration():
    d = Deadline(0.05)
    assert d.remaining_s > 0 and not d.expired
    time.sleep(0.06)
    assert d.expired
    with pytest.raises(DeadlineExceeded):
        d.check("unit test")
    pol = RetryPolicy(max_attempts=10, base_backoff_s=1e-4)
    calls = []

    def failing():
        calls.append(1)
        raise OSError("x")

    with pytest.raises(DeadlineExceeded):
        pol.call(failing, deadline=d)
    assert len(calls) == 0


def test_circuit_breaker_lifecycle():
    br = CircuitBreaker(failure_threshold=2, reset_timeout_s=0.05)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    time.sleep(0.06)
    assert br.state == "half_open" and br.allow()
    br.record_failure()
    assert br.state == "open" and br.total_opens == 2
    time.sleep(0.06)
    br.record_success()
    assert br.state == "closed" and br.allow()
    assert br.snapshot()["total_opens"] == 2


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetcher_heartbeat_ticks_per_chunk(depth):
    """The JAX package's hook: one beat per produced item, after the
    producer returns, on the serial and the threaded path alike."""
    from tpu_sgd.io import Prefetcher as JPrefetcher
    from tpu_sgd.reliability.health import Heartbeat as JHeartbeat
    from tpu_sgd_torch.io import Prefetcher
    from tpu_sgd_torch.reliability.health import Heartbeat

    hb, jhb = Heartbeat("ingest"), JHeartbeat("ingest")
    with Prefetcher(lambda i: i, range(5), depth=depth, heartbeat=hb) as pf:
        got = list(pf)
    with JPrefetcher(lambda i: i, range(5), depth=depth,
                     heartbeat=jhb) as pf:
        want = list(pf)
    assert got == want == list(range(5))
    assert hb.count == jhb.count == 5
    assert hb.age_s() is not None
    with pytest.raises(FaultInjected):
        with inject_faults({"io.prefetch.produce": fail_nth(3)}):
            list(Prefetcher(lambda i: i, range(5), depth=depth,
                            heartbeat=(hb2 := Heartbeat("wedged"))))
    assert hb2.count == 2  # a failed produce never beats


# -- checkpoints ------------------------------------------------------------------

def test_checkpoint_save_fault_leaves_no_partial_files(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    with inject_faults({"checkpoint.save": fail_nth(1)}):
        with pytest.raises(FaultInjected):
            cm.save(1, np.ones(4), 0.0, np.zeros(1))
    assert os.listdir(str(tmp_path)) == []
    cm.save(1, np.ones(4), 0.0, np.zeros(1))
    assert cm.latest_version() == 1


def test_double_corrupt_restore_falls_back_and_names_quarantined(
        tmp_path, caplog):
    import logging

    seen = []
    cm = CheckpointManager(
        str(tmp_path), on_corruption=lambda p, q, e: seen.append((p, q)))
    for i in (1, 2, 3):
        cm.save(i, np.full(4, float(i)), 0.0, np.zeros(1))
    for i in (2, 3):
        p = cm._path(i)
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
    with caplog.at_level(logging.WARNING,
                         logger="tpu_sgd_torch.checkpoint"):
        state = cm.restore()
    assert state is not None and state["iteration"] == 1
    np.testing.assert_array_equal(state["weights"], np.full(4, 1.0))
    assert len(seen) == 2
    for _, quarantined in seen:
        assert quarantined is not None and os.path.exists(quarantined)
        assert os.path.basename(quarantined).startswith(".bad_")
        assert quarantined in caplog.text
    assert cm.versions() == [1]


def test_checkpoint_load_failpoint_exercises_fallback(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    for i in (1, 2):
        cm.save(i, np.full(4, float(i)), 0.0, np.zeros(1))
    with inject_faults({"checkpoint.load": fail_nth(1)}):
        state = cm.restore()
    assert state["iteration"] == 1


def test_restore_transient_io_error_does_not_quarantine(tmp_path):
    seen = []
    cm = CheckpointManager(
        str(tmp_path), on_corruption=lambda p, q, e: seen.append(p))
    for i in (1, 2):
        cm.save(i, np.full(4, float(i)), 0.0, np.zeros(1))
    with inject_faults({"checkpoint.load": fail_nth(1, exc=OSError)}):
        state = cm.restore()
    assert state["iteration"] == 1
    assert seen == []
    assert cm.versions() == [1, 2]
    assert cm.restore()["iteration"] == 2


def test_flipped_checkpoint_byte_is_a_typed_quarantined_corruption(
        tmp_path):
    """A bit flipped at rest in an entry fails the content checksum: the
    explicit path raises ``IntegrityError``, the latest-default restore
    quarantines the file and falls back."""
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, np.full(4, 1.0, np.float32), 0.0, np.zeros(1))
    cm.save(2, np.full(4, 2.0, np.float32), 0.0, np.zeros(1))
    p = cm._path(2)
    with np.load(p) as z:
        entries = {k: z[k] for k in z.files}
    entries["weights"] = entries["weights"].copy()
    entries["weights"][0] = 9.0  # the sealed checksum no longer matches
    with open(p, "wb") as f:
        np.savez(f, **entries)
    with pytest.raises(IntegrityError, match="checkpoint"):
        cm.restore(p)
    assert cm.restore()["iteration"] == 1
    assert cm.versions() == [1]


# -- event log --------------------------------------------------------------------

def test_event_log_read_skips_torn_tail(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    log = JsonLinesEventLog(path, fsync=True)
    log.on_reliability(ReliabilityEvent(kind="heartbeat", source="t",
                                        value=1.0))
    log.on_reliability(ReliabilityEvent(kind="retry", source="t"))
    log.close()
    with open(path, "a") as f:
        f.write('{"kind": "torn_mid')
    events = JsonLinesEventLog.read(path)
    assert [e["kind"] for e in events] == [
        "reliability_heartbeat", "reliability_retry"]
    assert events[0]["source"] == "t" and events[0]["value"] == 1.0


@pytest.mark.parametrize("content", [
    '{"kind": "a"}\nnot json\n{"kind": "b"}\n',
    '{"kind": "a"}\nnot json\n',
])
def test_event_log_read_raises_on_whole_corrupt_lines(tmp_path, content):
    import json

    path = str(tmp_path / "ev.jsonl")
    with open(path, "w") as f:
        f.write(content)
    with pytest.raises(json.JSONDecodeError):
        JsonLinesEventLog.read(path)


# -- the supervisor -----------------------------------------------------------------

def test_supervisor_preempt_checkpoints_and_resumes_bitwise(tmp_path, rng):
    X, y = _data(rng)
    w0 = np.zeros(8, np.float32)
    w_ref, h_ref = _opt().set_listener(CollectingListener()) \
        .optimize_with_history((X, y), w0)

    events = CollectingListener()
    opt = _opt()
    sup = TrainingSupervisor(
        opt, checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=100, listener=events,
        install_signal_handlers=False)
    count = [0]

    class Stopper:
        def on_run_start(self, c): ...

        def on_iteration(self, ev):
            count[0] += 1
            if count[0] == 5:
                sup.request_preempt()

        def on_run_end(self, ev): ...

    opt.set_listener(Stopper())
    res = sup.run((X, y), w0)
    assert res.status == "preempted" and res.preempted_at == 5
    assert CheckpointManager(str(tmp_path)).latest_version() == 5
    assert any(e.kind == "preempted" for e in events.reliability)
    opt.set_listener(None)
    res2 = sup.run((X, y), w0)
    assert res2.completed
    np.testing.assert_array_equal(res2.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res2.loss_history, h_ref)


def test_supervisor_full_batch_stepwise_path_preempts_too(tmp_path, rng):
    X, y = _data(rng, n=256, d=6)
    w0 = np.zeros(6, np.float32)

    def make():
        return (GradientDescent(device=CPU).set_num_iterations(12)
                .set_step_size(0.1).set_convergence_tol(0.0))

    ref = make()
    ref.set_checkpoint(CheckpointManager(str(tmp_path / "ref")), every=50)
    w_ref, h_ref = ref.optimize_with_history((X, y), w0)
    opt = make()
    sup = TrainingSupervisor(
        opt, checkpoint_manager=CheckpointManager(str(tmp_path / "s")),
        checkpoint_every=50, install_signal_handlers=False)
    n = [0]

    class Stop:
        def on_run_start(self, c): ...

        def on_iteration(self, ev):
            n[0] += 1
            if n[0] == 4:
                sup.request_preempt()

        def on_run_end(self, ev): ...

    opt.set_listener(Stop())
    res = sup.run((X, y), w0)
    assert res.status == "preempted" and res.preempted_at == 4
    opt.set_listener(None)
    res2 = sup.run((X, y), w0)
    assert res2.completed
    np.testing.assert_array_equal(res2.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res2.loss_history, h_ref)


@pytest.mark.parametrize("mode", ["sliced", "indexed", "bernoulli"])
def test_kill_and_resume_bitwise_all_sampling_modes(tmp_path, mode, rng):
    """A fault at the third checkpoint save crashes the run; the
    supervisor resumes from the second and the finished run is bitwise
    the fault-free one."""
    X, y = _data(rng)
    w0 = np.zeros(8, np.float32)
    w_ref, h_ref = _opt(sampling=mode).optimize_with_history((X, y), w0)
    sup = TrainingSupervisor(
        _opt(sampling=mode),
        checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=3,
        retry=RetryPolicy(max_attempts=4, base_backoff_s=1e-4),
        install_signal_handlers=False)
    with inject_faults({"checkpoint.save": fail_nth(3)}):
        res = sup.run((X, y), w0)
    assert res.completed and res.attempts == 2
    np.testing.assert_array_equal(res.weights.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(res.loss_history, h_ref)


def test_supervisor_gives_up_after_retry_budget(tmp_path, rng):
    X, y = _data(rng, n=256, d=6)
    sup = TrainingSupervisor(
        _opt(iters=8),
        checkpoint_manager=CheckpointManager(str(tmp_path)),
        checkpoint_every=2,
        retry=RetryPolicy(max_attempts=2, base_backoff_s=1e-4),
        install_signal_handlers=False)
    with inject_faults({"checkpoint.save": fail_prob(1.0, seed=0)}):
        with pytest.raises(FaultInjected):
            sup.run((X, y), np.zeros(6, np.float32))


def test_supervisor_retry_only_wraps_lbfgs(rng):
    from tpu_sgd_torch.optimize.lbfgs import LBFGS

    X, y = _data(rng, n=256, d=6)
    w0 = np.zeros(6, np.float32)
    w_ref, _ = LBFGS(max_num_iterations=6, device=CPU) \
        .optimize_with_history((X, y), w0)
    crashed = [False]

    class CrashOnce(LBFGS):
        def optimize_with_history(self, data, w):
            if not crashed[0]:
                crashed[0] = True
                raise FaultInjected("boom")
            return super().optimize_with_history(data, w)

    sup = TrainingSupervisor(
        CrashOnce(max_num_iterations=6, device=CPU),
        retry=RetryPolicy(max_attempts=3, base_backoff_s=1e-4),
        install_signal_handlers=False)
    res = sup.run((X, y), w0)
    assert res.completed and res.attempts == 2
    np.testing.assert_array_equal(res.weights.numpy(), w_ref.numpy())


def test_supervisor_accepts_a_directory_and_rejects_no_checkpoint_path(
        tmp_path):
    class NoCheckpoints:
        def optimize_with_history(self, data, w):
            return w, np.zeros(0)

    with pytest.raises(TypeError, match="set_checkpoint"):
        TrainingSupervisor(NoCheckpoints(),
                           checkpoint_manager=str(tmp_path),
                           install_signal_handlers=False).run(None, None)


# -- checkpoints across the two packages ------------------------------------------

def _jax_opt(iters):
    from tpu_sgd.optimize.gradient_descent import GradientDescent as JGD

    return (JGD().set_num_iterations(iters).set_step_size(0.3)
            .set_mini_batch_fraction(1.0).set_convergence_tol(0.0))


def _torch_opt(iters):
    return (GradientDescent(device=CPU).set_num_iterations(iters)
            .set_step_size(0.3).set_mini_batch_fraction(1.0)
            .set_convergence_tol(0.0))


def _stop_after(opt, n):
    """Stop the observed run after ``n`` iterations."""
    seen = [0]

    class Count:
        def on_run_start(self, c): ...

        def on_iteration(self, ev):
            seen[0] += 1

        def on_run_end(self, ev): ...

    opt.set_listener(Count())
    opt.set_stop_signal(lambda: seen[0] >= n)
    return opt


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_written_by_one_package_resumes_in_the_other(
        tmp_path, rng, writer):
    from tpu_sgd.reliability.supervisor import (
        TrainingPreempted as JPreempted,
    )
    from tpu_sgd.utils.checkpoint import CheckpointManager as JCM

    X, y = _data(rng, n=300, d=6)
    w0 = np.zeros(6, np.float32)
    iters, stop = 20, 8
    make_w, make_r = ((_jax_opt, _torch_opt) if writer == "jax"
                      else (_torch_opt, _jax_opt))
    mgr_w = (JCM if writer == "jax" else CheckpointManager)(str(tmp_path))
    mgr_r = (CheckpointManager if writer == "jax" else JCM)(str(tmp_path))
    first = _stop_after(make_w(iters), stop).set_checkpoint(mgr_w, every=5)
    with pytest.raises((TrainingPreempted, JPreempted)) as ei:
        first.optimize_with_history((X, y), w0)
    assert ei.value.iteration == stop
    assert sorted(int(f[-12:-4]) for f in glob.glob(
        str(tmp_path / "ckpt_*.npz"))) == [5, stop]
    # the other package reads the state and the same config key: no
    # "config differs" warning on resume
    state = mgr_r.restore()
    assert state["iteration"] == stop and state["weights"].dtype == np.float32
    resumed = make_r(iters).set_checkpoint(mgr_r, every=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        w_res, h_res = resumed.optimize_with_history((X, y), w0)
    w_ref, h_ref = make_r(iters).set_listener(CollectingListener()) \
        .optimize_with_history((X, y), w0)
    assert len(h_res) == len(h_ref) == iters
    np.testing.assert_allclose(h_res, np.asarray(h_ref), rtol=2e-4)
    np.testing.assert_allclose(np.asarray(w_res), np.asarray(w_ref),
                               rtol=2e-4, atol=2e-3)
    assert sorted(int(f[-12:-4]) for f in glob.glob(
        str(tmp_path / "ckpt_*.npz")))[-1] == iters


def test_checkpoint_files_have_the_jax_package_entries(tmp_path):
    from tpu_sgd.utils.checkpoint import CheckpointManager as JCM

    for mgr, sub in ((CheckpointManager, "t"), (JCM, "j")):
        mgr(str(tmp_path / sub)).save(
            4, np.arange(3, dtype=np.float32), 0.5, np.ones(4), "key",
            extras={"intercept": np.asarray(0.25)})
    with np.load(str(tmp_path / "t" / "ckpt_00000004.npz")) as t, \
            np.load(str(tmp_path / "j" / "ckpt_00000004.npz")) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype


def test_sgd_config_repr_is_the_jax_packages():
    """The checkpoint config key is a repr of the config: it must print
    the same in both packages, or a cross-package resume warns."""
    from tpu_sgd.config import SGDConfig as JConfig
    from tpu_sgd_torch.config import SGDConfig

    kw = dict(step_size=0.3, num_iterations=7, reg_param=0.01,
              mini_batch_fraction=0.5, convergence_tol=0.0, seed=3,
              sampling="sliced")
    assert repr(SGDConfig(**kw)) == repr(JConfig(**kw))
    assert repr(SGDConfig()) == repr(JConfig())


# -- streaming checkpoints ------------------------------------------------------------

def _replayable_stream(d=12, batches=10, rows=500):
    w_true = np.linspace(-1, 1, d).astype(np.float32)
    out = []
    for i in range(batches):
        r = np.random.default_rng(100 + i)
        X = r.normal(size=(rows, d)).astype(np.float32)
        y = (X @ w_true + 0.05 * r.normal(size=rows)).astype(np.float32)
        out.append((X, y))
    return out, w_true


def _np(w) -> np.ndarray:
    """Weights of either package as numpy."""
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)


def _stream_alg(**kw):
    return StreamingLinearRegressionWithSGD(device=CPU, **kw)


def test_streaming_checkpoint_resume_reproduces_run(tmp_path):
    stream, _ = _replayable_stream()
    kwargs = dict(step_size=0.3, num_iterations=20)
    full = _stream_alg(**kwargs)
    full.set_initial_weights(np.zeros(12, np.float32))
    full.set_checkpoint(str(tmp_path / "full"), every=1)
    full.train_on(stream)

    part = _stream_alg(**kwargs)
    part.set_initial_weights(np.zeros(12, np.float32))
    part.set_checkpoint(str(tmp_path / "resume"), every=1)
    part.train_on(stream[:4])
    del part

    res = StreamingLinearRegressionWithSGD.resume_from(
        str(tmp_path / "resume"), device=CPU, **kwargs)
    assert res._batch_count == 4
    res.train_on(stream)
    assert res._batch_count == 10
    np.testing.assert_array_equal(res.latest_model().weights.numpy(),
                                  full.latest_model().weights.numpy())
    assert res.latest_model().intercept == full.latest_model().intercept
    np.testing.assert_array_equal(np.asarray(res.loss_history),
                                  np.asarray(full.loss_history))
    assert len(res.loss_history) == 10


def test_streaming_resume_preserves_intercept(tmp_path):
    stream, _ = _replayable_stream(batches=3)
    alg = _stream_alg(step_size=0.3, num_iterations=10)
    alg.algorithm.set_intercept(True)
    alg.set_initial_weights(np.zeros(12, np.float32), intercept=0.5)
    alg.set_checkpoint(str(tmp_path), every=1)
    alg.train_on(stream)
    want = alg.latest_model().intercept
    res = StreamingLinearRegressionWithSGD.resume_from(
        str(tmp_path), step_size=0.3, num_iterations=10, device=CPU)
    res.algorithm.set_intercept(True)
    assert res.latest_model().intercept == want


def test_streaming_resume_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        StreamingLinearRegressionWithSGD.resume_from(str(tmp_path / "x"),
                                                     device=CPU)


def test_streaming_checkpoint_every_k(tmp_path):
    stream, _ = _replayable_stream(batches=6)
    alg = _stream_alg(step_size=0.3, num_iterations=5)
    alg.set_initial_weights(np.zeros(12, np.float32))
    alg.set_checkpoint(CheckpointManager(str(tmp_path), keep=10), every=2)
    alg.train_on(stream)
    files = sorted(glob.glob(str(tmp_path / "ckpt_*.npz")))
    assert [int(f[-12:-4]) for f in files] == [2, 4, 6]


def test_streaming_resume_live_stream_skip_zero(tmp_path):
    stream, _ = _replayable_stream(batches=6)
    alg = _stream_alg(step_size=0.3, num_iterations=5)
    alg.set_initial_weights(np.zeros(12, np.float32))
    alg.set_checkpoint(str(tmp_path), every=1)
    alg.train_on(stream[:3])
    kw = dict(step_size=0.3, num_iterations=5, device=CPU)
    res = StreamingLinearRegressionWithSGD.resume_from(str(tmp_path), **kw)
    res.train_on(stream[3:], skip=0)
    assert res._batch_count == 6
    res2 = StreamingLinearRegressionWithSGD.resume_from(str(tmp_path), **kw)
    res2.train_on(stream)
    np.testing.assert_array_equal(res.latest_model().weights.numpy(),
                                  res2.latest_model().weights.numpy())


def test_streaming_resume_empty_batches_stay_aligned(tmp_path):
    stream, _ = _replayable_stream(batches=5)
    d = stream[0][0].shape[1]
    empty = (np.zeros((0, d), np.float32), np.zeros((0,), np.float32))
    stream = [stream[0], empty] + stream[1:]
    kwargs = dict(step_size=0.3, num_iterations=10)
    full = _stream_alg(**kwargs)
    full.set_initial_weights(np.zeros(d, np.float32))
    full.train_on(stream)
    part = _stream_alg(**kwargs)
    part.set_initial_weights(np.zeros(d, np.float32))
    part.set_checkpoint(str(tmp_path), every=1)
    part.train_on(stream[:3])
    assert part._batch_count == 3
    res = StreamingLinearRegressionWithSGD.resume_from(str(tmp_path),
                                                       device=CPU, **kwargs)
    res.train_on(stream)
    np.testing.assert_array_equal(res.latest_model().weights.numpy(),
                                  full.latest_model().weights.numpy())
    np.testing.assert_array_equal(np.asarray(res.loss_history),
                                  np.asarray(full.loss_history))


def test_streaming_resume_rejects_non_streaming_checkpoint(tmp_path):
    CheckpointManager(str(tmp_path)).save(
        5, np.zeros(4, np.float32), 0.0, np.zeros(5), config_key="sgd:cfg")
    with pytest.raises(ValueError, match="non-streaming checkpoint"):
        StreamingLinearRegressionWithSGD.resume_from(str(tmp_path),
                                                     device=CPU)


def test_streaming_resume_family_mismatch_warns(tmp_path):
    alg = _stream_alg(step_size=0.3, num_iterations=5)
    alg.set_initial_weights(np.zeros(6, np.float32))
    alg.set_checkpoint(str(tmp_path), every=1)
    X = np.random.default_rng(0).normal(size=(64, 6)).astype(np.float32)
    y = (X @ np.ones(6, np.float32)).astype(np.float32)
    alg.train_on_batch(X, y)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        StreamingLogisticRegressionWithSGD.resume_from(str(tmp_path),
                                                       device=CPU)
    assert any("construct the same streaming" in str(r.message)
               for r in rec)


def test_checkpoint_history_tail_bounds_persisted_history(tmp_path, rng):
    alg = (_stream_alg(step_size=0.3, num_iterations=5)
           .set_initial_weights(np.zeros(4, np.float32))
           .set_checkpoint(str(tmp_path / "ck"), every=1, history_tail=3))
    w = rng.uniform(-1, 1, 4).astype(np.float32)
    for _ in range(6):
        X = rng.normal(size=(64, 4)).astype(np.float32)
        alg.train_on_batch(X, (X @ w).astype(np.float32))
    assert len(alg.loss_history) == 6
    st = CheckpointManager(str(tmp_path / "ck")).restore()
    assert st["iteration"] == 6 and len(st["loss_history"]) == 3
    with pytest.raises(ValueError, match="history_tail"):
        _stream_alg().set_checkpoint(str(tmp_path / "ck2"), history_tail=0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_streaming_checkpoint_resumes_across_packages(tmp_path, writer):
    """A stream checkpointed by one package resumes in the other: the
    stream position and the history length exact, the intercept riding
    the ``x_`` extras, the final weights within the tight tier of the
    other package's uninterrupted run."""
    from tpu_sgd.models import streaming as jst

    stream, _ = _replayable_stream(d=6, batches=6, rows=200)
    kw = dict(step_size=0.3, num_iterations=10)

    def jax_alg():
        a = jst.StreamingLinearRegressionWithSGD(**kw)
        a.algorithm.set_schedule("off")
        return a

    def resume(directory):
        if writer == "jax":
            return StreamingLinearRegressionWithSGD.resume_from(
                directory, device=CPU, **kw)
        r = jst.StreamingLinearRegressionWithSGD.resume_from(directory,
                                                             **kw)
        r.algorithm.set_schedule("off")
        return r

    part = jax_alg() if writer == "jax" else _stream_alg(**kw)
    part.set_initial_weights(np.zeros(6, np.float32), intercept=0.5)
    part.set_checkpoint(str(tmp_path), every=1)
    part.train_on(stream[:3])
    res = resume(str(tmp_path))
    assert res._batch_count == 3
    assert res.latest_model().intercept == pytest.approx(
        part.latest_model().intercept)
    res.train_on(stream)
    full = _stream_alg(**kw) if writer == "jax" else jax_alg()
    full.set_initial_weights(np.zeros(6, np.float32), intercept=0.5)
    full.train_on(stream)
    assert res._batch_count == 6 and len(res.loss_history) == 6
    np.testing.assert_allclose(_np(res.latest_model().weights),
                               _np(full.latest_model().weights),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(res.loss_history, full.loss_history,
                               rtol=2e-4)
