"""The highly-available parameter store in the port (``tpu_sgd_torch/
replica/ha.py``), the integrity planes of the replica wire, and the
flight recorder (``tpu_sgd_torch/obs/flightrec.py``): the twins of
``tests/test_replica_ha.py`` and of the replica and flight-recorder
cases of ``tests/test_integrity.py`` / ``tests/test_obs.py``, on the CPU.

Tolerances, by tier:

* exact — epochs, versions, delta-log sequence numbers and retention,
  checkpoint names, keys and contents, the flight recorder's dump;
* bitwise within the port — a standby equals its primary at every
  version; τ=0 with the primary killed mid-round (by the
  ``replica.store_fail`` failpoint or from a ``threading.Timer``), a
  double failure's cold recovery, a weight-corruption rollback, healed
  wire and log corruption, and a supervised preempt-resume through the
  HA layer all equal the fault-free run (which
  ``tests/test_torch_replica.py`` pins to the rank-order reference);
* matched objective ≤ 1.01× for the τ ≥ 1 and compressed runs.

The async runs depend on thread scheduling, so they are held to the JAX
tests' invariants: the staleness bound never violated, EF mass conserved
on rejection and partition, a fenced epoch's push rejected.  Every
threaded run joins with a deadline.
"""

import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from torch_replica_reference import (ListSink, data, full_objective,
                                     rank_order_reference)
from tpu_sgd_torch.io.integrity import IntegrityError, set_integrity
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.reliability.retry import RetryPolicy
from tpu_sgd_torch.replica import (DeltaLog, DeltaRecord, ParameterStore,
                                   ReplicaDriver, ReplicaMembership,
                                   ReplicaWorker, StandbyReplica,
                                   StoreFailed, StoreFenced,
                                   StoreSupervisor, StoreUnreachable,
                                   shard_rows)
from tpu_sgd_torch.utils.checkpoint import CheckpointManager
from tpu_sgd_torch.utils.events import CollectingListener, JsonLinesEventLog

OBJECTIVE_RATIO = 1.01


def _driver(*, iters=24, frac=0.5, step=0.3, reg=0.1, workers=4, tau=0,
            standbys=0):
    drv = (ReplicaDriver(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                         device="cpu")
           .set_step_size(step).set_num_iterations(iters)
           .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
           .set_reg_param(reg).set_workers(workers).set_staleness(tau))
    if standbys:
        drv.set_standbys(standbys)
    return drv


def _cfg(**kw):
    base = dict(step_size=0.2, num_iterations=40, mini_batch_fraction=1.0,
                convergence_tol=0.0, reg_param=0.01)
    base.update(kw)
    return tst.SGDConfig(**base)


def _store_pair(cfg, w0, *, tau=0, shared_ef=None, primary_listener=None,
                standby_listener=None, **sup_kw):
    """A primary + one standby under a supervisor (the direct, no-driver
    composition unit tests drive)."""
    ef = shared_ef if shared_ef is not None else {}
    primary = ParameterStore(tst.SquaredL2Updater(), cfg, w0, staleness=tau,
                             listener=primary_listener, ef_registry=ef,
                             name="s0", device="cpu")
    standby = ParameterStore(tst.SquaredL2Updater(), cfg, w0, staleness=tau,
                             listener=standby_listener, ef_registry=ef,
                             name="s1", device="cpu")
    sup = StoreSupervisor([primary, standby], **sup_kw)
    return primary, standby, sup


def _run_threads(workers, timeout=60):
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a worker hung"


def _wait_live(drv, version, timeout=30.0):
    """Wait until ``drv``'s HA run is live with its primary at
    ``version`` or beyond; False on timeout."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sup = drv._live_supervisor
        if sup is not None and sup.primary().version >= version:
            return True
        time.sleep(0.001)
    return False


def _ones(d=8):
    return torch.ones(d), torch.tensor(1.0), torch.tensor(8.0)


@pytest.fixture(scope="module")
def fault_free():
    """The τ=0 single-store run the HA runs are held to, itself pinned
    bitwise to the rank-order reference."""
    X, y, w0 = data()
    w, h = _driver(tau=0).optimize_with_history((X, y), w0)
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=4)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)
    return X, y, w0, w.numpy(), h


# -- standby bitwise ----------------------------------------------------------------


@pytest.mark.parametrize("tau", [0, 2])
def test_standby_bitwise_at_every_version(tau):
    """The delta log replays, it does not approximate: the standby's
    per-version loss and weight delta (listener events) and its final
    weights are bitwise the primary's."""
    X, y, w0 = data(n=128, d=8, seed=3)
    cfg = _cfg(num_iterations=20, mini_batch_fraction=0.5, step_size=0.3)
    p_lis, s_lis = CollectingListener(), CollectingListener()
    primary, standby, sup = _store_pair(
        cfg, w0, tau=tau, primary_listener=p_lis, standby_listener=s_lis)
    client = sup.client()
    shards = shard_rows(X, y, 2)
    workers = [ReplicaWorker(f"w{s}", s, client, tst.LeastSquaresGradient(),
                             cfg, *shards[s], device="cpu")
               for s in range(2)]
    for s in range(2):
        client.register_worker(f"w{s}", s)
    _run_threads(workers)
    sup.stop()  # drains the standby to the log head
    np.testing.assert_array_equal(standby.loss_history(),
                                  primary.loss_history())
    np.testing.assert_array_equal(standby.weights.numpy(),
                                  primary.weights.numpy())
    assert len(p_lis.iterations) == len(s_lis.iterations) == 20
    for pe, se in zip(p_lis.iterations, s_lis.iterations):
        assert (pe.iteration, pe.loss, pe.weight_delta_norm) == (
            se.iteration, se.loss, se.weight_delta_norm)


def test_ha_fault_free_bitwise_vs_single_store(fault_free):
    X, y, w0, w_ref, h_ref = fault_free
    drv = _driver(tau=0, standbys=1)
    w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)
    assert drv.last_failover_snapshot["failovers"] == 0
    standby = drv.last_supervisor._stores[1]
    np.testing.assert_array_equal(standby.loss_history(), h_ref)


# -- kill the primary mid-round -------------------------------------------------------


def test_tau0_kill_primary_mid_round_bitwise(fault_free):
    """τ=0 with the primary store killed mid-round is BITWISE the
    fault-free run after failover: the promoted standby replays the log
    gap and the re-routed rounds are deterministic in (seed, version)."""
    X, y, w0, w_ref, h_ref = fault_free
    drv = _driver(tau=0, standbys=1)
    # ~8 store accesses per version (4 pulls + 4 pushes): hit 100 lands
    # the kill mid-run
    with fp.inject_faults({"replica.store_fail":
                           fp.fail_nth(100, exc=StoreFailed)}):
        w, h = drv.optimize_with_history((X, y), w0)
    snap = drv.last_failover_snapshot
    assert snap["failovers"] == 1, snap
    rec = snap["records"][0]
    assert rec["old_primary"] == "s0" and rec["new_primary"] == "s1"
    assert rec["epoch"] == 1 and not rec["cold_recovery"]
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)
    store_snap = drv.last_store_snapshot
    assert (store_snap["epoch"], store_snap["version"]) == (1, 24)


def test_tau0_kill_primary_from_a_timer_bitwise():
    """``kill_primary()`` fired from a ``threading.Timer`` while the run
    is live (the chip check's spelling): bitwise the fault-free run."""
    X, y, w0 = data(n=512, d=10, seed=8)
    kw = dict(tau=0, iters=400, frac=0.5, step=0.2, reg=0.01, workers=2)
    w_ref, h_ref = _driver(**kw).optimize_with_history((X, y), w0)
    drv = _driver(standbys=1, **kw)
    versions = []

    def kill():
        # the timer's thread kills once the run is live and past version
        # 5 (a loaded host may start the run after the timer fires)
        if _wait_live(drv, 5):
            versions.append(drv._live_supervisor.primary().version)
            drv.kill_primary()

    timer = threading.Timer(0.05, kill)
    timer.start()
    try:
        w, h = drv.optimize_with_history((X, y), w0)
    finally:
        timer.cancel()
        timer.join(timeout=30)
    assert versions and versions[0] < 400, versions
    assert drv.last_failover_snapshot["failovers"] == 1
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)


def test_tau2_kill_primary_mid_round_converges():
    X, y, w0 = data(n=512, d=10, seed=11)
    iters = 160
    w_ref, _ = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        iters=iters, frac=1.0, step=0.2, reg=0.01, workers=4)
    ref_obj = full_objective(X, y, w_ref, 0.01)
    drv = _driver(tau=2, iters=iters, frac=1.0, step=0.2, reg=0.01,
                  standbys=1)
    # a run makes at least 2 x 160 store accesses (a pull and a push an
    # applied step) and more with rejections: hit 150 lands mid-run
    with fp.inject_faults({"replica.store_fail":
                           fp.fail_nth(150, exc=StoreFailed)}):
        w, h = drv.optimize_with_history((X, y), w0)
    assert drv.last_failover_snapshot["failovers"] == 1
    assert len(h) == iters
    assert drv.last_store_snapshot["max_accepted_staleness"] <= 2
    assert full_objective(X, y, w.numpy(), 0.01) <= ref_obj * \
        OBJECTIVE_RATIO


# -- epoch fencing ---------------------------------------------------------------------


def test_fenced_epoch_push_rejected_and_old_store_refuses():
    _, _, w0 = data(n=32, d=8)
    primary, standby, sup = _store_pair(_cfg(num_iterations=50), w0, tau=2)
    client = sup.client()
    client.register_worker("w0", 0)
    pulled = client.pull("w0")
    assert pulled.epoch == 0
    assert client.push("w0", pulled.version, *_ones(),
                       basis_epoch=pulled.epoch).accepted
    assert sup.kill_primary()
    assert sup.epoch == 1 and sup.primary() is standby
    # the old basis is fenced on the promoted store...
    res = standby.push("w0", pulled.version, *_ones(), basis_epoch=0)
    assert res.fenced and not res.accepted
    assert standby.snapshot()["pushes_fenced"] == 1
    # ...the fenced old store refuses pulls and pushes outright...
    with pytest.raises(StoreFenced):
        primary.pull("w0")
    with pytest.raises(StoreFenced):
        primary.push("w0", 0, *_ones())
    # ...and the CLIENT hides all of it: a fresh pull carries epoch 1
    pulled2 = client.pull("w0")
    assert pulled2.epoch == 1
    assert client.push("w0", pulled2.version, *_ones(),
                       basis_epoch=pulled2.epoch).accepted


def test_resurrected_primary_delta_records_refused_by_log():
    _, _, w0 = data(n=32, d=8)
    primary, standby, sup = _store_pair(_cfg(), w0, tau=2)
    sup.kill_primary()
    log = sup._log
    assert log.epoch == 1
    stale = DeltaRecord(epoch=0, version=standby.version + 1, kind="sums",
                        payloads=(("sums", np.zeros(8, np.float32),
                                   np.zeros((), np.float32),
                                   np.ones((), np.float32)),))
    with pytest.raises(StoreFenced):
        log.append(stale)
    with pytest.raises(StoreFenced):
        primary.apply_replica_record(stale)


def test_delta_log_numbers_records_like_the_jax_package():
    """Exact: the port's log and the JAX package's refuse the same gaps
    and fences and trim to the same live window."""
    from tpu_sgd.replica import DeltaLog as JaxLog
    from tpu_sgd.replica import DeltaRecord as JaxRecord

    payload = ("sums", np.ones(4, np.float32), np.float32(1.0),
               np.float32(2.0))
    def outcome(fn):
        try:
            got = fn()
        except Exception as e:  # typed errors compared by name
            return type(e).__name__
        return "ok" if got is None else [r.version for r in got]

    logs = [(DeltaLog(retain=3), DeltaRecord), (JaxLog(retain=3), JaxRecord)]
    outcomes = []
    for log, Rec in logs:
        log.register_reader("r", 0)
        out = [outcome(lambda: log.append(Rec(e, v, "sums", (payload,))))
               for e, v in ((0, 1), (0, 2), (0, 4), (1, 3), (0, 3), (0, 4))]
        out.append(outcome(lambda: log.since(0, timeout_s=0.0)))
        out.append(outcome(lambda: log.append(Rec(0, 5, "sums",
                                                  (payload,)))))
        out.append(outcome(lambda: log.since(1, timeout_s=0.0)))
        log.advance_reader("r", 4)
        out.append(log.head_version())
        out.append(outcome(lambda: log.since(4, timeout_s=0.0)))
        log.set_epoch(1)
        out.append(outcome(lambda: log.append(Rec(0, 6, "sums",
                                                  (payload,)))))
        outcomes.append(out)
    assert outcomes[0] == outcomes[1]
    # retain=3: record 1 fell off the ring, so a reader at 0 has lost it
    assert outcomes[0] == ["ok", "ok", "StoreFailed", "StoreFenced", "ok",
                           "ok", "StoreFailed", "ok", "StoreFailed", 5,
                           [5], "StoreFenced"]


def test_fenced_old_primary_late_save_never_shadows(tmp_path):
    mgr = CheckpointManager(os.fspath(tmp_path), keep=8)
    w_old = np.full(4, 7.0, np.float32)
    w_new = np.full(4, 9.0, np.float32)
    mgr.save(38, w_new, 0.0, np.zeros(38), "ck", epoch=1)
    mgr.save(40, w_old, 0.0, np.zeros(40), "ck", epoch=0)
    state = mgr.restore()
    assert state["iteration"] == 38 and state["epoch"] == 1
    np.testing.assert_array_equal(state["weights"], w_new)
    mgr.save(40, w_new, 0.0, np.zeros(40), "ck", epoch=1)
    assert mgr.restore()["epoch"] == 1
    st = mgr.restore_version(40)
    assert st["epoch"] == 1
    np.testing.assert_array_equal(st["weights"], w_new)
    assert mgr.versions() == [40, 38]
    assert mgr.latest_version() == 40


def test_fenced_store_refuses_its_late_save(tmp_path, caplog):
    """The store half: a fenced primary's save is refused loudly, so
    only the promoted line writes."""
    _, _, w0 = data(n=32, d=8)
    mgr = CheckpointManager(os.fspath(tmp_path))
    store = ParameterStore(tst.SquaredL2Updater(), _cfg(), w0,
                           checkpoint_manager=mgr, device="cpu")
    store.fence()
    with caplog.at_level(logging.WARNING,
                         logger="tpu_sgd_torch.replica.store"):
        store.save_now()
    assert os.listdir(tmp_path) == []
    assert any("refusing checkpoint save" in r.message
               for r in caplog.records)


def test_checkpoint_epoch_roundtrips_and_prunes_oldest_epoch(tmp_path):
    mgr = CheckpointManager(os.fspath(tmp_path), keep=2)
    for it in (10, 20):
        mgr.save(it, np.zeros(3), 0.0, np.zeros(it), "ck")
    mgr.save(15, np.ones(3), 0.0, np.zeros(15), "ck", epoch=2)
    assert mgr.versions() == [20, 15]
    assert mgr.restore()["epoch"] == 2
    assert mgr.restore()["iteration"] == 15
    assert mgr.restore_version(20)["epoch"] == 0


# -- partition tolerance ----------------------------------------------------------------


def test_partitioned_push_conserves_ef_mass_and_rejoins_after_failover():
    """A compressed push that cannot reach any store restores its
    extracted top-k segment; after a failover the SAME accumulator (the
    registry is shared by the store group) is live on the promoted
    primary and the carried mass ships."""
    X, y, w0 = data(n=64, d=16, seed=5)
    cfg = _cfg(num_iterations=50, step_size=0.1)
    primary, standby, sup = _store_pair(cfg, w0, tau=2, shared_ef={})
    client = sup.client()
    client.register_worker("w0", 0)
    shards = shard_rows(X, y, 1)
    worker = ReplicaWorker("w0", 0, client, tst.LeastSquaresGradient(), cfg,
                           *shards[0], wire_frac=0.25, device="cpu")
    assert worker.run_once()  # one clean cycle: EF live and registered
    acc_before = worker.ef.acc.copy()
    # the failpoint kills the PUSH (access 2 of the cycle), after the
    # pull and the EF fold/extract
    with fp.inject_faults({"replica.store_fail": fp.fail_nth(2)}):
        with pytest.raises(fp.FaultInjected):
            worker.run_once()
    pulled = client.pull("w0")
    g, _, c = worker._local_sums(pulled.weights, worker._X, worker._y,
                                 pulled.version + 1)
    gn = g.numpy().reshape(-1) / max(float(c), 1.0)
    np.testing.assert_allclose(worker.ef.acc, acc_before + gn, rtol=1e-5,
                               atol=1e-7)
    client.partition("w0")
    with pytest.raises(StoreUnreachable):
        worker.run_once()
    client.heal("w0")
    assert sup.kill_primary()
    assert sup.primary() is standby
    assert sup.primary().error_feedback("w0", 0.25) is worker.ef
    v_before = standby.version
    assert worker.run_once()
    assert standby.version == v_before + 1
    assert worker.fenced == 0  # the pull already carried the new epoch


def test_partition_through_full_failover_driver():
    """One worker partitioned across a primary kill (τ=2, compressed
    wire) retries under its RetryPolicy, rejoins the contract after the
    heal, and the run completes every version with a matched
    objective."""
    X, y, w0 = data(n=512, d=10, seed=11)
    w_ref, _ = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        iters=160, frac=1.0, step=0.2, reg=0.01, workers=4)
    ref_obj = full_objective(X, y, w_ref, 0.01)
    iters = 320
    drv = (_driver(tau=2, iters=iters, frac=1.0, step=0.2, reg=0.01,
                   standbys=1)
           .set_wire_compress("topk:0.25")
           .set_retry(RetryPolicy(max_attempts=400, base_backoff_s=0.01,
                                  max_backoff_s=0.05, seed=3)))
    # once the run is past version 20: partition w1, kill the primary
    # while it is cut off (the SSP bound holds the fleet near w1's clock),
    # then heal it; pushes slowed a little so the run outlasts the script
    def chaos():
        if _wait_live(drv, 20):
            drv.partition_worker("w1")
            time.sleep(0.05)
            drv.kill_primary()
            time.sleep(0.1)
            drv.heal_worker("w1")

    spec = fp.inject_latency(1.0, prob=1.0, seed=0)
    with fp.inject_faults({"replica.push": spec}):
        t = threading.Thread(target=chaos)
        t.start()
        try:
            w, h = drv.optimize_with_history((X, y), w0)
        finally:
            t.join(timeout=30)
    assert not t.is_alive()
    snap = drv.last_store_snapshot
    assert drv.last_failover_snapshot["failovers"] == 1
    assert snap["version"] == iters and len(h) == iters
    assert snap["max_accepted_staleness"] <= 2
    assert full_objective(X, y, w.numpy(), 0.01) <= ref_obj * \
        OBJECTIVE_RATIO


# -- double failure ------------------------------------------------------------------------


def test_double_failure_cold_recovery_bitwise_with_loud_warning(
        tmp_path, caplog):
    X, y, w0 = data()
    w_ref, h_ref = _driver(tau=0, iters=60).optimize_with_history(
        (X, y), w0)
    mgr = CheckpointManager(os.fspath(tmp_path))
    drv = _driver(tau=0, iters=60, standbys=1).set_checkpoint(mgr, every=5)

    class _KillTwice(CollectingListener):
        def __init__(self):
            super().__init__()
            self.killed = set()

        def on_iteration(self, ev):
            super().on_iteration(ev)
            if ev.iteration in (15, 30) and ev.iteration not in self.killed:
                self.killed.add(ev.iteration)
                drv.kill_primary()

    drv.set_listener(_KillTwice())
    with caplog.at_level(logging.WARNING, logger="tpu_sgd_torch.replica.ha"):
        w, h = drv.optimize_with_history((X, y), w0)
    snap = drv.last_failover_snapshot
    assert snap["failovers"] == 2
    assert not snap["records"][0]["cold_recovery"]
    assert snap["records"][1]["cold_recovery"]
    assert any("cold-recovering" in r.message for r in caplog.records)
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)
    assert mgr.restore()["epoch"] == 2


# -- preemption vs failover ---------------------------------------------------------------


def test_preempt_waits_for_inflight_failover_to_settle():
    _, _, w0 = data(n=32, d=8)
    primary, standby, sup = _store_pair(_cfg(), w0, tau=2)
    client = sup.client()
    client.register_worker("w0", 0)
    pulled = client.pull("w0")
    client.push("w0", pulled.version, *_ones(), basis_epoch=pulled.epoch)
    # stretch the promotion with injected latency, stop() mid-flight
    with fp.inject_faults({"replica.failover": fp.inject_latency(600.0)}):
        killer = threading.Thread(target=sup.kill_primary)
        killer.start()
        time.sleep(0.15)  # the promotion is now sleeping in its span
        t0 = time.monotonic()
        client.stop()
        waited = time.monotonic() - t0
        killer.join(timeout=30)
    assert not killer.is_alive()
    assert waited >= 0.15, waited
    assert sup.failover_count == 1
    snap = client.snapshot()
    assert snap["epoch"] == 1 and snap["stopped"]
    assert sup.primary() is standby


def test_supervised_preempt_resume_bitwise_with_standby(tmp_path):
    from tpu_sgd_torch.reliability.supervisor import TrainingSupervisor

    X, y, w0 = data()
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        workers=2, iters=40)
    mgr = CheckpointManager(os.fspath(tmp_path))
    drv = _driver(tau=0, workers=2, iters=40, standbys=1)
    sup = TrainingSupervisor(drv, checkpoint_manager=mgr,
                             checkpoint_every=10,
                             install_signal_handlers=False)

    class _PreemptAt(CollectingListener):
        def on_iteration(self, ev):
            super().on_iteration(ev)
            if ev.iteration == 12:
                sup.request_preempt()

    drv.set_listener(_PreemptAt())
    res = sup.run((X, y), w0)
    assert res.status == "preempted"
    drv.set_listener(None)
    res2 = sup.run((X, y), w0)
    assert res2.completed
    np.testing.assert_array_equal(res2.weights.numpy(), w_ref)
    np.testing.assert_array_equal(res2.loss_history, h_ref)


def test_stopped_store_never_applies_partial_round():
    """At τ=0, a worker exiting AFTER stop() must not 'complete' a round
    holding only its peer's contribution."""
    _, _, w0 = data(n=32, d=8)
    store = ParameterStore(tst.SquaredL2Updater(), _cfg(), w0, staleness=0,
                           device="cpu")
    store.register_worker("w0", 0)
    store.register_worker("w1", 1)
    results = []
    t = threading.Thread(
        target=lambda: results.append(store.push("w0", 0, *_ones())))
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with store._cond:
            if "w0" in store._inbox:
                break
        time.sleep(0.005)
    store.stop()
    store.deregister_worker("w1")
    t.join(timeout=30)
    assert not t.is_alive()
    assert store.version == 0


# -- delta-log memory / retention -----------------------------------------------------------


def test_delta_log_trims_to_live_replication_gap():
    X, y, w0 = data(n=128, d=8)
    drv = _driver(tau=0, workers=2, iters=40, standbys=1)
    drv.optimize_with_history((X, y), w0)
    log = drv.last_supervisor._log
    with log._cond:
        assert len(log._records) <= 4, len(log._records)
        assert log._readers == {}


def test_standby_off_retention_window_marks_failed_never_promotes():
    _, _, w0 = data(n=32, d=8)
    store = ParameterStore(tst.SquaredL2Updater(), _cfg(), w0, staleness=2,
                           name="s1", device="cpu")
    log = DeltaLog(retain=2)
    rep = StandbyReplica(store, log, name="s1")
    payload = ("sums", np.ones(8, np.float32),
               np.asarray(1.0, np.float32), np.asarray(8.0, np.float32))
    for v in range(1, 6):
        log.append(DeltaRecord(0, v, "sums", (payload,)))
    rep.start()
    deadline = time.monotonic() + 10
    while not store.failed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert store.failed
    with log._cond:
        assert "s1" not in log._readers
    rep.halt()


# -- integrity: wire and log corruption, poison, rollback ------------------------------------


def _small(tau=0, workers=2, iters=24, retry=None, standbys=0,
           compress=None):
    drv = _driver(tau=tau, workers=workers, iters=iters, standbys=standbys)
    if retry is not None:
        drv.set_retry(retry)
    if compress is not None:
        drv.set_wire_compress(compress)
    return drv


@pytest.mark.parametrize("compress", [None, "topk:0.25"])
def test_corrupt_push_wire_heals_bitwise(compress):
    X, y, w0 = data()
    w_ref, h_ref = _small(compress=compress).optimize_with_history(
        (X, y), w0)
    drv = _small(compress=compress,
                 retry=RetryPolicy(max_attempts=6, base_backoff_s=0.001,
                                   seed=6))
    with fp.inject_faults(
            {"replica.push.wire": fp.corrupt_nth(3, kind="nan")}):
        w, h = drv.optimize_with_history((X, y), w0)
        assert fp.triggers("replica.push.wire") == 1
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)


def test_corrupt_log_record_heals_standby_bitwise():
    X, y, w0 = data()
    drv = _small(standbys=1)
    with fp.inject_faults(
            {"replica.log.record": fp.corrupt_nth(2, kind="bitflip")}):
        drv.optimize_with_history((X, y), w0)
        assert fp.triggers("replica.log.record") == 1
    sup = drv.last_supervisor
    assert sup.failover_count == 0
    primary = sup.primary()
    standby = sup._stores[1]
    assert standby.version == primary.version
    np.testing.assert_array_equal(standby.weights.numpy(),
                                  primary.weights.numpy())


def test_non_finite_and_spiking_pushes_are_poisoned():
    cfg = _cfg(num_iterations=200, step_size=0.1, reg_param=0.0)
    store = ParameterStore(tst.SimpleUpdater(), cfg,
                           np.zeros(16, np.float32), staleness=1,
                           device="cpu")
    store.register_worker("w0", 0)
    g = np.ones(16, np.float32)
    g[3] = np.nan
    res = store.push("w0", 0, g, np.float32(1.0), np.float32(4.0))
    assert res.poisoned and not res.accepted and store.version == 0
    for _ in range(20):
        assert store.push("w0", store.version, np.ones(16, np.float32),
                          np.float32(0.5), np.float32(4.0)).accepted
    spike = np.full(16, 1e4, np.float32)
    assert store.push("w0", store.version, spike, np.float32(0.5),
                      np.float32(4.0)).poisoned
    assert store.snapshot()["pushes_poisoned"] == 2


def test_guard_catches_unsealed_nan_wire_damage():
    """Checksums off, guard on: NaN-damaged pushes are poisoned and
    recomputed; the run lands at the matched objective."""
    X, y, w0 = data()
    set_integrity(False)
    try:
        w_ref, _ = _small(tau=2, iters=48).optimize_with_history((X, y), w0)
        drv = _small(tau=2, iters=48)
        with fp.inject_faults({"replica.push.wire": fp.corrupt_prob(
                0.1, seed=21, kind="nan")}):
            w, _ = drv.optimize_with_history((X, y), w0)
            assert fp.triggers("replica.push.wire") > 0
    finally:
        set_integrity(True)
    assert drv.last_store_snapshot["pushes_poisoned"] >= 1
    assert drv.last_store_snapshot["version"] == 48
    assert full_objective(X, y, w.numpy(), 0.1) <= full_objective(
        X, y, w_ref.numpy(), 0.1) * OBJECTIVE_RATIO


def _corrupt_when(drv, version):
    def corrupter():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            sup = drv._live_supervisor
            if sup is not None:
                try:
                    if sup.primary().version >= version:
                        drv.chaos_corrupt_weights()
                        return
                except StoreFailed:
                    pass
            time.sleep(0.002)

    t = threading.Thread(target=corrupter, daemon=True)
    t.start()
    return t


def test_weight_corruption_rolls_back_bitwise_and_dumps_the_recorder(
        tmp_path):
    """NaN planted in the live primary's weights: the armed rollback
    fences the poisoned line, cold-restores the last good checkpoint and
    the τ=0 replay is BITWISE the clean run; the flight recorder dumps
    the incident."""
    from tpu_sgd_torch.obs import flightrec, spans

    X, y, w0 = data()
    w_ref, h_ref = _small(iters=60).optimize_with_history((X, y), w0)
    rec = flightrec.enable(str(tmp_path / "fr.jsonl"), capacity=64)
    spans.enable_tracing(flightrec.TeeSink(ListSink(), rec))
    try:
        drv = (_small(iters=60)
               .set_checkpoint(CheckpointManager(str(tmp_path / "ck"),
                                                 keep=4), every=5)
               .set_integrity_rollback(True))
        t = _corrupt_when(drv, 10)
        w, h = drv.optimize_with_history((X, y), w0)
        t.join(timeout=5)
    finally:
        spans.disable_tracing()
        flightrec.disable()
    snap = drv.last_failover_snapshot
    assert snap["failovers"] >= 1
    assert any(r["cold_recovery"] for r in snap["records"])
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)
    dump = JsonLinesEventLog.read(str(tmp_path / "fr.jsonl"))
    assert dump[0]["kind"] == "flightrec_meta"
    assert dump[0]["reason"] == "integrity.rollback"
    assert any(r.get("name") == "integrity.rollback" for r in dump[1:])


def test_rollback_rebuilds_standby_redundancy(tmp_path):
    X, y, w0 = data()
    drv = (_small(iters=60, standbys=1)
           .set_checkpoint(CheckpointManager(str(tmp_path), keep=4), every=5)
           .set_integrity_rollback(True))
    t = _corrupt_when(drv, 10)
    w, _ = drv.optimize_with_history((X, y), w0)
    t.join(timeout=5)
    sup = drv.last_supervisor
    assert drv.last_failover_snapshot["failovers"] >= 1
    assert np.isfinite(w.numpy()).all()
    live = [rep for rep in sup._standbys.values()
            if not (rep.store.failed or rep.store.fenced)]
    assert live
    assert live[0].store.version == sup.primary().version
    np.testing.assert_array_equal(live[0].store.weights.numpy(),
                                  sup.primary().weights.numpy())


def test_poison_livelock_fails_loudly_without_rollback(monkeypatch):
    monkeypatch.setattr(ReplicaWorker, "POISON_STREAK_LIMIT", 8)
    X, y, w0 = data()
    drv = _small(workers=1, iters=500, standbys=1).set_rejoin(
        RetryPolicy(max_attempts=2, base_backoff_s=0.001, seed=3))
    t = _corrupt_when(drv, 5)
    with pytest.raises(IntegrityError) as ei:
        drv.optimize_with_history((X, y), w0)
    t.join(timeout=5)
    assert ei.value.kind == "poison"
    assert drv.last_store_snapshot["pushes_poisoned"] >= 8


def test_poison_streak_outlasts_the_rollback_poll():
    """The streak gives up only after POISON_STREAK_LIMIT rejections AND
    POISON_STREAK_MIN_S seconds at one basis: fast poisoned cycles must
    not run out before the driver's 0.1 s health poll can roll back."""
    from tpu_sgd_torch.replica.store import PushResult

    X, y, w0 = data(n=32, d=4)
    store = ParameterStore(tst.SimpleUpdater(), _cfg(), w0, device="cpu")
    worker = ReplicaWorker("w0", 0, store, tst.LeastSquaresGradient(),
                           _cfg(), X, y, device="cpu")
    poisoned = PushResult(False, 3, 0, False, poisoned=True)
    for _ in range(2 * ReplicaWorker.POISON_STREAK_LIMIT):
        worker._account(poisoned, 3, 0)  # within the time floor
    assert worker.poisoned == 2 * ReplicaWorker.POISON_STREAK_LIMIT
    worker._poison_since -= ReplicaWorker.POISON_STREAK_MIN_S
    with pytest.raises(IntegrityError):
        worker._account(poisoned, 3, 0)
    worker._account(poisoned, 4, 0)  # a new basis starts a new streak
    assert worker._poison_streak == 1


def test_manual_rollback_handle_requires_live_ha_run():
    drv = _small()
    assert drv.rollback() is False
    assert drv.chaos_corrupt_weights() is False
    assert drv.kill_primary() is False


# -- the obs surface ---------------------------------------------------------------------------


def test_membership_failover_record_and_event():
    from tpu_sgd_torch.obs import spans
    from tpu_sgd_torch.obs.timeseries import EVENT_FANOUT, SPAN_FANOUT

    assert EVENT_FANOUT.get("replica.failover") == "new_primary"
    assert SPAN_FANOUT.get("replica.step") == "worker"
    m = ReplicaMembership()
    sink = ListSink()
    spans.enable_tracing(sink)
    try:
        m.failover("s0", "s1", 1, 7)
    finally:
        spans.disable_tracing()
    assert m.failover_records() == [{"old_primary": "s0",
                                     "new_primary": "s1", "epoch": 1,
                                     "gap_replayed": 7,
                                     "cold_recovery": False}]
    evs = [p for k, p in sink.records
           if k == "trace_event" and p["name"] == "replica.failover"]
    assert len(evs) == 1
    assert evs[0]["new_primary"] == "s1" and evs[0]["gap"] == 7


def test_driver_windows_carry_the_per_worker_series():
    from tpu_sgd_torch.obs import counters, spans, timeseries

    X, y, w0 = data(n=64, d=6)
    spans.enable_tracing(ListSink())
    counters.enable()
    timeseries.enable(width_s=60.0)
    try:
        drv = _driver(workers=2, tau=1, iters=10)
        drv.optimize_with_history((X, y), w0)
    finally:
        timeseries.disable()
        counters.disable()
        spans.disable_tracing()
    series = set()
    for win in drv.last_windows_snapshot:
        series |= set(win["series"])
    assert {"replica.step[w0]", "replica.step[w1]",
            "replica.push.staleness", "replica.join[w0]"} <= series


def test_flight_recorder_ring_is_bounded_and_dump_replaces(tmp_path):
    from tpu_sgd_torch.obs.flightrec import FlightRecorder

    fr = FlightRecorder(str(tmp_path / "fr.jsonl"), capacity=8)
    for i in range(100):
        fr.record("trace_event", {"name": "e", "i": i})
    assert fr.trigger("first") is not None
    recs = JsonLinesEventLog.read(fr.path)
    assert len(recs) == 1 + 8
    assert [r["i"] for r in recs[1:]] == list(range(92, 100))
    fr.record("trace_event", {"name": "e", "i": 100})
    fr.trigger("second", detail="why")
    recs = JsonLinesEventLog.read(fr.path)
    assert recs[0]["reason"] == "second"
    assert recs[0]["dump_ordinal"] == 2
    assert recs[-1]["i"] == 100
    assert fr.dumps == 2


def test_flight_recorder_dumps_like_the_jax_package(tmp_path):
    """Exact but for the timestamps: the same records, error span and
    window source give the JAX package's dump, line for line."""
    from tpu_sgd.obs.flightrec import FlightRecorder as JaxRecorder
    from tpu_sgd.obs.flightrec import TeeSink as JaxTee
    from tpu_sgd_torch.obs.flightrec import FlightRecorder, TeeSink

    windows = lambda: [{"index": 0, "series": {"a": {"count": 1}}}]  # noqa
    dumps = []
    for Rec, Tee, name in ((FlightRecorder, TeeSink, "port"),
                           (JaxRecorder, JaxTee, "jax")):
        rec = Rec(str(tmp_path / f"{name}.jsonl"), capacity=4,
                  window_source=windows)
        tee = Tee(ListSink(), rec, error_dump_interval_s=3600.0)
        for i in range(6):
            tee.emit("trace_event", {"name": "e", "i": i})
        tee.emit("trace_span", {"name": "s", "error": "ValueError"})
        tee.emit("trace_span", {"name": "s", "error": "ValueError"})
        assert rec.dumps == 1  # the second error is debounced
        dumps.append([{k: v for k, v in r.items() if k != "ts"}
                      for r in JsonLinesEventLog.read(rec.path)])
    assert dumps[0] == dumps[1]
    assert dumps[0][0]["reason"] == "span-error:s"
    assert dumps[0][-1]["kind"] == "obs_window"


def test_flight_recorder_module_switch(tmp_path):
    from tpu_sgd_torch.obs import flightrec

    assert not flightrec.is_enabled()
    assert flightrec.trigger("nothing") is None
    rec = flightrec.enable(str(tmp_path / "fr.jsonl"))
    try:
        assert flightrec.is_enabled()
        rec.record("trace_event", {"name": "x"})
        assert flightrec.trigger("why", "detail") == rec.path
    finally:
        flightrec.disable()
    assert not flightrec.is_enabled()
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(str(tmp_path / "x"), capacity=0)


# -- lock discipline (the JAX package's runtime instrumentation, with the
# port's declarations) --------------------------------------------------------


def test_failover_lock_discipline_and_order_validated_at_runtime():
    """A kill-primary failover under FULL lock instrumentation
    (supervisor + both stores + delta log + client, one shared
    recorder): no unguarded access, no Eraser race, and the observed
    acquisition order -- including the ``set_replication(log.append)``
    callback edge -- replays clean against the committed order."""
    from tpu_sgd.analysis import runtime

    _failover_lock_run(runtime)


def test_failover_lock_discipline_and_order_validated_by_the_port_runtime():
    """The same failover under the port's own runtime checkers, replayed
    against the port's committed lock order."""
    from tpu_sgd_torch.analysis import runtime

    _failover_lock_run(runtime)


def _failover_lock_run(runtime):
    LocksetRecorder = runtime.LocksetRecorder
    assert_lock_order = runtime.assert_lock_order
    instrument_object = runtime.instrument_object
    from tpu_sgd_torch.replica import ha as ha_mod
    from tpu_sgd_torch.replica import store as store_mod

    _, _, w0 = data(n=32, d=8)
    primary, standby, sup = _store_pair(_cfg(num_iterations=200), w0, tau=2)
    # quiesce the standby applier while its locks are swapped
    sup._standbys[1].halt()
    rec = LocksetRecorder()
    instrument_object(sup._log, ha_mod.GRAFTLINT_LOCKS["DeltaLog"], rec)
    for st in (primary, standby):
        instrument_object(
            st, store_mod.GRAFTLINT_LOCKS["ParameterStore"], rec,
            owner="ParameterStore")
    sup._standbys[1].start()
    # the supervisor LAST: the restart above reads sup._standbys
    instrument_object(sup, ha_mod.GRAFTLINT_LOCKS["StoreSupervisor"], rec)
    client = sup.client()
    instrument_object(client, ha_mod.GRAFTLINT_LOCKS["StoreClient"], rec)
    client.register_worker("w0", 0)
    client.register_worker("w1", 1)

    ok = [0, 0]

    def pusher(i):
        for _ in range(30):
            try:
                pulled = client.pull(f"w{i}")
                res = client.push(f"w{i}", pulled.version, *_ones(),
                                  basis_epoch=pulled.epoch)
                ok[i] += bool(res.accepted)
            except Exception:
                pass  # transient mid-promotion refusals are protocol
            time.sleep(0.001)

    threads = [threading.Thread(target=pusher, args=(i,), name=f"push{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    assert sup.kill_primary()  # the failover, mid-traffic
    for t in threads:
        t.join(timeout=60)
    sup.stop()
    assert sup.epoch == 1
    assert sum(ok) > 0
    assert rec.checked_accesses > 0
    assert rec.violations == []
    assert rec.races() == []
    assert ("ParameterStore._cond", "DeltaLog._cond") in rec.order_pairs
    assert_lock_order(rec)


def test_supervisor_lock_discipline_validated_at_runtime():
    """The StoreSupervisor declaration, validated dynamically on a live
    run with a mid-run failover."""
    from tpu_sgd.analysis.runtime import instrument_object

    _supervisor_lock_run(instrument_object)


def test_supervisor_lock_discipline_validated_by_the_port_runtime():
    from tpu_sgd_torch.analysis.runtime import instrument_object

    _supervisor_lock_run(instrument_object)


def _supervisor_lock_run(instrument_object):
    from tpu_sgd_torch.replica import ha as ha_mod

    X, y, w0 = data(n=64, d=6)
    cfg = _cfg(num_iterations=30, step_size=0.2, mini_batch_fraction=0.5)
    primary, standby, sup = _store_pair(cfg, w0, tau=1)
    recorder = instrument_object(
        sup, ha_mod.GRAFTLINT_LOCKS["StoreSupervisor"])
    client = sup.client()
    shards = shard_rows(X, y, 2)
    workers = [ReplicaWorker(f"w{s}", s, client, tst.LeastSquaresGradient(),
                             cfg, *shards[s], device="cpu")
               for s in range(2)]
    for s in range(2):
        client.register_worker(f"w{s}", s)
    killer = threading.Timer(0.1, sup.kill_primary)
    killer.start()
    _run_threads(workers)
    killer.cancel()
    sup.stop()
    assert sup.primary().version == 30
    assert recorder.checked_accesses > 0
    assert recorder.violations == []


# -- the detectors on failover windows (obs/detect.py) -------------------------


def _win(idx, series):
    return {"index": idx, "t_start": float(idx),
            "t_end": float(idx) + 1.0, "series": series}


def _cnt(n):
    return {"count": n, "sum": 0.0, "mean": 0.0, "max": None, "bytes": 0}


def test_failover_detector_trips_on_failover_window_only():
    from tpu_sgd_torch.obs.detect import (DetectorEngine, FailoverDetector,
                                          default_detectors)

    assert "failover" in {d.rule for d in default_detectors()}
    eng = DetectorEngine([FailoverDetector()])
    eng.on_window_close(_win(0, {"replica.step[w0]": _cnt(5)}))
    assert eng.trip_counts() == {}
    eng.on_window_close(_win(1, {"replica.failover": _cnt(1)}))
    assert eng.trip_counts() == {"failover": 1}
    # stays-tripped dedup + re-arm after a clean window
    eng.on_window_close(_win(2, {"replica.failover": _cnt(1)}))
    assert eng.trip_counts() == {"failover": 1}
    eng.on_window_close(_win(3, {}))
    eng.on_window_close(_win(4, {"replica.failover": _cnt(1)}))
    assert eng.trip_counts() == {"failover": 2}


def test_straggler_roster_survives_failover_window():
    """The failover window resets the straggler deficits, so the healed
    fleet never false-trips, while a worker still silent AFTER the
    failover keeps accumulating and trips."""
    from tpu_sgd_torch.obs.detect import DetectorEngine, StragglerDetector

    eng = DetectorEngine([StragglerDetector(min_fleet_steps=6)])
    eng.on_window_close(_win(0, {"replica.step[w0]": _cnt(3),
                                 "replica.step[w1]": _cnt(3)}))
    eng.on_window_close(_win(1, {"replica.step[w0]": _cnt(4)}))
    assert eng.trip_counts() == {}
    eng.on_window_close(_win(2, {"replica.failover": _cnt(1),
                                 "replica.step[w0]": _cnt(4)}))
    assert eng.trip_counts() == {}
    eng.on_window_close(_win(3, {"replica.step[w0]": _cnt(4)}))
    assert eng.trip_counts() == {"replica-straggler": 1}


def test_failover_under_the_armed_detectors_trips_once_and_dumps(tmp_path):
    """The HA driver killed mid-run under ``obs.enable(detect=True,
    flightrec=...)``: bitwise the fault-free run, exactly one ``failover``
    trip per failover, and the flight recorder's dump names it; the
    fault-free run under the same enable trips nothing."""
    from tpu_sgd_torch import obs
    from tpu_sgd_torch.obs import report

    X, y, w0 = data(n=512, d=10, seed=8)
    kw = dict(tau=0, iters=200, frac=0.5, step=0.2, reg=0.01, workers=2,
              standbys=1)
    trace, fr = str(tmp_path / "t.jsonl"), str(tmp_path / "fr.jsonl")
    obs.enable(str(tmp_path / "clean.jsonl"), detect=True, window_s=0.05,
               flightrec=str(tmp_path / "clean_fr.jsonl"))
    try:
        free_w, free_h = _driver(**kw).optimize_with_history((X, y), w0)
        obs.flush_windows()
        assert obs.detector_engine().trip_counts() == {}
    finally:
        obs.disable()
    assert not os.path.exists(tmp_path / "clean_fr.jsonl")
    obs.enable(trace, detect=True, window_s=0.05, flightrec=fr)
    try:
        drv = _driver(**kw)
        # the kill waits until the run is live and past version 5 (a
        # loaded host may start the run late); 200 rounds are its runway
        t = threading.Thread(target=lambda: (
            _wait_live(drv, 5) and drv.kill_primary()))
        t.start()
        w, h = drv.optimize_with_history((X, y), w0)
        t.join(timeout=60)
        obs.flush_windows()
        trips = obs.detector_engine().trip_counts()
    finally:
        obs.disable()
    fo = drv.last_failover_snapshot
    assert fo["failovers"] == 1
    assert trips.get("failover") == fo["failovers"]
    np.testing.assert_array_equal(w.numpy(), free_w.numpy())
    np.testing.assert_array_equal(h, free_h)
    meta = JsonLinesEventLog.read(fr)[0]
    assert meta["kind"] == "flightrec_meta"
    assert meta["reason"] == "alert:failover"
    stats = report.alert_stats(report.load_trace(trace))
    assert stats["by_rule"].get("failover") == 1
