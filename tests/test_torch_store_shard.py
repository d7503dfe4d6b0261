"""The sharded parameter store in the port (``tpu_sgd_torch/replica/
shard.py``): the twins of ``tests/test_store_shard.py`` on the CPU.  (The
SparCML merge's own twins are in ``tests/test_torch_sparse_wire.py``.)

Tolerances, by tier:

* exact — ``shard_offsets`` against the JAX package's, per-shard push,
  apply and replay counts, the tagged wire counters, the merged
  compressed combine against the JAX package's sharded store (both merge
  the same host segments in numpy);
* bitwise within the port — τ=0 through S ∈ {1, 2, 4} pipelines equals
  the rank-order reference (and so S = 1); a sharded standby equals its
  primary at every version; a sharded τ=0 run with the primary killed
  equals the fault-free unsharded run;
* across frameworks — weights after the same compressed pushes through
  the two packages' sharded stores at the gradient tier (rtol 2e-4 /
  atol 2e-3).

Every threaded run joins with a deadline.
"""

import threading

import numpy as np
import pytest
import torch

import tpu_sgd_torch as tst
from torch_replica_reference import data, full_objective, rank_order_reference
from tpu_sgd_torch.io.integrity import IntegrityError
from tpu_sgd_torch.reliability import failpoints as fp
from tpu_sgd_torch.reliability.retry import RetryPolicy
from tpu_sgd_torch.replica import (ReplicaDriver, ReplicaWorker,
                                   ShardedParameterStore, ShardPipeline,
                                   StoreFailed, StoreSupervisor,
                                   shard_offsets, shard_rows)
from tpu_sgd_torch.utils.events import CollectingListener


def _data(n=128, d=12, seed=1):
    return data(n=n, d=d, seed=seed)


def _driver(*, iters=12, frac=0.5, step=0.3, reg=0.1, workers=4, tau=0,
            store_shards=1, standbys=0):
    drv = (ReplicaDriver(tst.LeastSquaresGradient(), tst.SquaredL2Updater(),
                         device="cpu")
           .set_step_size(step).set_num_iterations(iters)
           .set_mini_batch_fraction(frac).set_convergence_tol(0.0)
           .set_reg_param(reg).set_workers(workers).set_staleness(tau))
    if store_shards > 1:
        drv.set_store_shards(store_shards)
    if standbys:
        drv.set_standbys(standbys)
    return drv


def _cfg(**kw):
    base = dict(step_size=0.2, num_iterations=20, mini_batch_fraction=1.0,
                convergence_tol=0.0, reg_param=0.01)
    base.update(kw)
    return tst.SGDConfig(**base)


def _sharded_pair(cfg, w0, *, n_shards=2, tau=0, primary_listener=None,
                  standby_listener=None):
    ef = {}
    primary = ShardedParameterStore(
        tst.SquaredL2Updater(), cfg, w0, n_shards=n_shards, staleness=tau,
        listener=primary_listener, ef_registry=ef, name="s0", device="cpu")
    standby = ShardedParameterStore(
        tst.SquaredL2Updater(), cfg, w0, n_shards=n_shards, staleness=tau,
        listener=standby_listener, ef_registry=ef, name="s1", device="cpu")
    return primary, standby, StoreSupervisor([primary, standby])


# -- shard layout ---------------------------------------------------------------------


def test_shard_offsets_equal_the_jax_package():
    from tpu_sgd.replica import shard_offsets as jax_offsets

    assert shard_offsets(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert shard_offsets(4, 8) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for dim in (1, 4, 12, 17, 1000):
        for s in (1, 2, 3, 4, 5, 8):
            offs = shard_offsets(dim, s)
            assert offs == jax_offsets(dim, s)
            assert offs[0][0] == 0 and offs[-1][1] == dim
            assert all(a[1] == b[0] for a, b in zip(offs, offs[1:]))


def test_the_merge_density_is_the_reference_default():
    store = ShardedParameterStore(tst.SimpleUpdater(), _cfg(),
                                  np.zeros(8, np.float32), n_shards=2,
                                  device="cpu")
    try:
        from tpu_sgd_torch.plan import DEFAULT_COST_MODEL

        assert DEFAULT_COST_MODEL.sparse_merge_density == 0.25
        assert store._merge_density == 0.25
    finally:
        store.stop()


# -- τ=0 bitwise, per shard count ----------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_tau0_bitwise_vs_rank_order_per_shard_count(n_shards):
    """τ=0 through S apply pipelines is BITWISE the rank-order reference
    (so every S is bitwise S = 1): per-shard slice accumulation in payload
    order is the same f32 add chain as the flattened combine, and the
    whole-vector apply is untouched."""
    X, y, w0 = _data()
    w_ref, h_ref = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        iters=12)
    drv = _driver(store_shards=n_shards)
    w, h = drv.optimize_with_history((X, y), w0)
    np.testing.assert_array_equal(w.numpy(), w_ref)
    np.testing.assert_array_equal(h, h_ref)
    snap = drv.last_store_snapshot
    if n_shards > 1:
        assert snap["store_shards"] == n_shards
        # dense pushes touch every shard: 12 versions x 4 workers
        assert snap["shard_pushes"] == [48] * n_shards
        assert snap["shard_applies"] == [12] * n_shards


@pytest.mark.parametrize("n_shards", [2, 4])
def test_tau2_sharded_run_meets_the_objective(n_shards):
    X, y, w0 = _data(n=512, d=10, seed=11)
    w_ref, _ = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        iters=160, frac=1.0, step=0.2, reg=0.01, workers=4)
    drv = _driver(tau=2, iters=160, frac=1.0, step=0.2, reg=0.01,
                  store_shards=n_shards)
    w, h = drv.optimize_with_history((X, y), w0)
    assert len(h) == 160
    assert drv.last_store_snapshot["max_accepted_staleness"] <= 2
    assert full_objective(X, y, w.numpy(), 0.01) <= full_objective(
        X, y, w_ref, 0.01) * 1.01


# -- HA composition --------------------------------------------------------------------------


def test_sharded_standby_bitwise_at_every_version():
    X, y, w0 = _data(n=128, d=8, seed=3)
    cfg = _cfg(num_iterations=16, mini_batch_fraction=0.5, step_size=0.3)
    p_lis, s_lis = CollectingListener(), CollectingListener()
    primary, standby, sup = _sharded_pair(
        cfg, w0, n_shards=2, tau=0, primary_listener=p_lis,
        standby_listener=s_lis)
    client = sup.client()
    shards = shard_rows(X, y, 2)
    workers = [ReplicaWorker(f"w{s}", s, client, tst.LeastSquaresGradient(),
                             cfg, *shards[s], device="cpu")
               for s in range(2)]
    for s in range(2):
        client.register_worker(f"w{s}", s)
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    sup.stop()
    np.testing.assert_array_equal(standby.loss_history(),
                                  primary.loss_history())
    np.testing.assert_array_equal(standby.weights.numpy(),
                                  primary.weights.numpy())
    assert len(p_lis.iterations) == len(s_lis.iterations) == 16
    for pe, se in zip(p_lis.iterations, s_lis.iterations):
        assert (pe.iteration, pe.loss, pe.weight_delta_norm) == (
            se.iteration, se.loss, se.weight_delta_norm)
    assert standby.snapshot()["shard_replays"] == [16, 16]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_tau0_kill_primary_sharded_bitwise_across_failover(n_shards):
    X, y, w0 = _data()
    w_ref, h_ref = _driver().optimize_with_history((X, y), w0)
    drv = (_driver(store_shards=n_shards, standbys=1)
           .set_retry(RetryPolicy(max_attempts=400, base_backoff_s=0.01,
                                  max_backoff_s=0.05, seed=7)))
    with fp.inject_faults({"replica.store_fail":
                           fp.fail_nth(48, exc=StoreFailed)}):
        w, h = drv.optimize_with_history((X, y), w0)
    assert drv.last_failover_snapshot["failovers"] == 1
    np.testing.assert_array_equal(w.numpy(), w_ref.numpy())
    np.testing.assert_array_equal(h, h_ref)
    snap = drv.last_store_snapshot
    assert snap["store_shards"] == n_shards
    assert all(r > 0 for r in snap["shard_replays"])


def test_single_shard_failover_replays_only_its_gap():
    d = 16
    cfg = _cfg(num_iterations=10, step_size=0.1)
    primary, standby, sup = _sharded_pair(cfg, np.zeros(d, np.float32),
                                          n_shards=2, tau=2)
    assert primary.shard_layout() == [(0, 8), (8, 16)]
    client = sup.client()
    for s in range(2):
        client.register_worker(f"w{s}", s)
    rng = np.random.default_rng(5)

    def push_lower(wid):
        pulled = client.pull(wid)
        idx = np.asarray([0, 2, 5], np.int32)  # shard 0 only
        vals = rng.normal(size=3).astype(np.float32)
        assert client.push_compressed(wid, pulled.version, idx, vals,
                                      0.5, 64.0).accepted

    for _ in range(3):
        push_lower("w0")
        push_lower("w1")
    assert sup.kill_primary()
    for _ in range(2):
        push_lower("w0")
        push_lower("w1")
    sup.stop()
    promoted = sup.primary()
    assert promoted is standby
    snap = promoted.snapshot()
    assert snap["version"] == 10
    assert snap["shard_replays"][0] >= 1
    assert snap["shard_replays"][1] == 0
    assert snap["shard_pushes"][1] == 0
    rec = sup.snapshot()["records"][0]
    assert rec["new_primary"] == "s1" and not rec["cold_recovery"]


# -- compressed wire through the shards -----------------------------------------------------


def test_rejected_sharded_compressed_push_restores_ef_per_shard():
    d = 16
    cfg = _cfg(num_iterations=10, step_size=0.1)
    store = ShardedParameterStore(tst.SquaredL2Updater(), cfg,
                                  np.zeros(d, np.float32), n_shards=2,
                                  staleness=1, device="cpu")
    try:
        store.register_worker("w0", 0)
        store.register_worker("w1", 1)
        ef = store.error_feedback("w0", 0.5)
        rng = np.random.default_rng(9)
        update = rng.normal(size=d).astype(np.float32)
        idx, vals = ef.compress(update.copy())
        g = rng.normal(size=d).astype(np.float32)
        assert store.push("w1", 0, g, 0.5, 8.0).accepted
        assert store.push("w0", 0, g, 0.5, 8.0).accepted
        res = store.push_compressed("w0", 0, idx, vals, 0.5, 8.0)
        assert not res.accepted and res.staleness > 1
        (a0, b0), (a1, b1) = store.shard_layout()
        m0 = (idx >= a0) & (idx < b0)
        ef.restore_segment(idx[m0], vals[m0])
        np.testing.assert_allclose(ef.acc[a0:b0], update[a0:b0], rtol=1e-5)
        ef.restore_segment(idx[~m0], vals[~m0])
        np.testing.assert_allclose(ef.acc, update, rtol=1e-5)
    finally:
        store.stop()


def test_sharded_compressed_pushes_match_the_jax_sharded_store():
    """The same compressed pushes into both packages' sharded stores:
    the merged combine is exact (numpy in both), the applied weights at
    the gradient tier, versions and counters exact."""
    from tpu_sgd.config import SGDConfig
    from tpu_sgd.ops.updaters import SquaredL2Updater
    from tpu_sgd.replica import ShardedParameterStore as JaxSharded

    d = 24
    kw = dict(step_size=0.1, num_iterations=12, mini_batch_fraction=1.0,
              convergence_tol=0.0, reg_param=0.01)
    ours = ShardedParameterStore(tst.SquaredL2Updater(), tst.SGDConfig(**kw),
                                 np.zeros(d, np.float32), n_shards=3,
                                 staleness=0, device="cpu")
    theirs = JaxSharded(SquaredL2Updater(), SGDConfig(**kw),
                        np.zeros(d, np.float32), n_shards=3, staleness=0)
    rng = np.random.default_rng(3)
    try:
        for store in (ours, theirs):
            store.register_worker("w0", 0)
        for v in range(12):
            idx = rng.choice(d, size=6, replace=False).astype(np.int32)
            vals = rng.normal(size=6).astype(np.float32)
            segs = []
            for a, b in ours.shard_layout():
                m = (idx >= a) & (idx < b)
                segs.append(((idx[m] - a).astype(np.int32), vals[m])
                            if m.any() else None)
            payload = [("stopk", tuple(segs), 0.5, 8.0)]
            g_ours, _, _ = ours._combine_topk_locked(payload)
            g_theirs, _, _ = theirs._combine_topk_locked(payload)
            np.testing.assert_array_equal(g_ours.numpy(),
                                          np.asarray(g_theirs))
            for store in (ours, theirs):
                assert store.push_compressed("w0", v, idx, vals, 0.5,
                                             8.0).accepted
        assert ours.version == theirs.version == 12
        np.testing.assert_allclose(ours.weights.numpy(),
                                   np.asarray(theirs.weights), rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(ours.loss_history(),
                                   theirs.loss_history(), rtol=2e-4)
        assert ours.snapshot()["shard_pushes"] == \
            theirs.snapshot()["shard_pushes"]
    finally:
        ours.stop()
        theirs.stop()


def test_sharded_compressed_driver_run_and_the_shard_seals():
    """A compressed sharded τ=1 run meets the objective; a push whose
    shard seals disagree with the store's split is refused typed."""
    X, y, w0 = _data(n=512, d=16, seed=13)
    w_ref, _ = rank_order_reference(
        tst.LeastSquaresGradient(), tst.SquaredL2Updater(), X, y, w0,
        iters=200, frac=1.0, step=0.2, reg=0.01, workers=2)
    drv = (_driver(tau=1, iters=200, frac=1.0, step=0.2, reg=0.01,
                   workers=2, store_shards=2)
           .set_wire_compress("topk:0.25"))
    w, _ = drv.optimize_with_history((X, y), w0)
    assert full_objective(X, y, w.numpy(), 0.01) <= full_objective(
        X, y, w_ref, 0.01) * 1.01
    store = ShardedParameterStore(tst.SimpleUpdater(), _cfg(),
                                  np.zeros(8, np.float32), n_shards=2,
                                  staleness=1, device="cpu")
    try:
        store.register_worker("w0", 0)
        idx = np.asarray([1, 6], np.int32)
        vals = np.ones(2, np.float32)
        with pytest.raises(ValueError, match="shard seals"):
            store.push_compressed("w0", 0, idx, vals, 1.0, 2.0,
                                  shard_seals=(1,))
        with pytest.raises(IntegrityError):
            store.push_compressed("w0", 0, idx, vals, 1.0, 2.0,
                                  shard_seals=(1, 2))
        assert store.version == 0
    finally:
        store.stop()


# -- the pipeline --------------------------------------------------------------------------------


def test_shard_pipeline_concurrent_shutdown_and_post_shutdown_submit():
    p = ShardPipeline(0, 0, 4)
    p.submit(lambda: 41 + 1)
    assert p.collect() == 42
    worker = p._thread
    assert worker is not None and worker.is_alive()
    closers = [threading.Thread(target=p.shutdown) for _ in range(4)]
    for t in closers:
        t.start()
    for t in closers:
        t.join(timeout=10)
    assert not worker.is_alive()
    assert p._thread is None
    with pytest.raises(RuntimeError, match="shut down"):
        p.submit(lambda: 0)


def test_shard_pipeline_reraises_a_job_error_and_refuses_a_busy_slot():
    p = ShardPipeline(1, 0, 4)
    try:
        p.submit(lambda: 1 // 0)
        with pytest.raises(ZeroDivisionError):
            p.collect()
        gate = threading.Event()
        p.submit(gate.wait)
        with pytest.raises(RuntimeError, match="busy"):
            p.submit(lambda: 0)
        gate.set()
        assert p.collect() is True
        assert p.applies == 2
    finally:
        p.shutdown()


# -- the obs surface -----------------------------------------------------------------------------


def test_record_wire_shard_tag_fans_out_counter_series():
    from tpu_sgd_torch.obs import counters as obs_counters

    obs_counters.enable()
    obs_counters.reset()
    try:
        obs_counters.record_wire("dense-f32", 128, 128, tag="s0")
        obs_counters.record_wire("dense-f32", 128, 64, tag="s1")
        snap = obs_counters.snapshot()
    finally:
        obs_counters.disable()
    tagged = {n for n in snap
              if ".wire.dense-f32[" in n and not n.endswith(".logical")}
    assert len(tagged) == 2
    ratios = obs_counters.wire_ratios(snap)
    by_tag = {n[n.index("["):]: r for n, r in ratios.items() if "[" in n}
    assert by_tag["[s0]"]["physical_bytes"] == 128
    assert by_tag["[s1]"]["physical_bytes"] == 64
    assert by_tag["[s1]"]["logical_bytes"] == 128


def test_sharded_pushes_emit_per_shard_events():
    from tpu_sgd_torch.obs import spans
    from tpu_sgd_torch.obs.timeseries import EVENT_FANOUT
    from torch_replica_reference import ListSink

    assert EVENT_FANOUT["replica.shard.push"] == "shard"
    store = ShardedParameterStore(tst.SimpleUpdater(), _cfg(),
                                  np.zeros(8, np.float32), n_shards=2,
                                  staleness=1, device="cpu")
    sink = ListSink()
    spans.enable_tracing(sink)
    try:
        store.register_worker("w0", 0)
        store.push("w0", 0, torch.ones(8), torch.tensor(1.0),
                   torch.tensor(4.0))
        store.push_compressed("w0", 1, np.asarray([0], np.int32),
                              np.ones(1, np.float32), 1.0, 4.0)
    finally:
        spans.disable_tracing()
        store.stop()
    shards = [p["shard"] for k, p in sink.records
              if k == "trace_event" and p["name"] == "replica.shard.push"]
    assert shards == ["s0", "s1", "s0"]


# -- lock discipline and the shard-balance detector ------------------------------


def test_sharded_store_lock_discipline_validated_at_runtime():
    """The store's and every pipeline's lock declarations, validated
    dynamically on a live sharded run with the JAX package's runtime
    instrumentation: the two-level discipline (store ``_cond`` ->
    pipeline ``_cond``, never the reverse) holds under real worker
    concurrency, and the observed order replays clean."""
    from tpu_sgd.analysis import runtime

    _sharded_store_lock_run(runtime)


def test_sharded_store_lock_discipline_validated_by_the_port_runtime():
    """The same run under the port's own runtime checkers, replayed
    against the port's committed lock order."""
    from tpu_sgd_torch.analysis import runtime

    _sharded_store_lock_run(runtime)


def _sharded_store_lock_run(runtime):
    LocksetRecorder = runtime.LocksetRecorder
    assert_lock_order = runtime.assert_lock_order
    instrument_object = runtime.instrument_object
    from tpu_sgd_torch.replica import shard as shard_mod
    from tpu_sgd_torch.replica import store as store_mod

    X, y, w0 = data(n=64, d=6)
    cfg = _cfg(num_iterations=20, step_size=0.2, mini_batch_fraction=0.5)
    store = ShardedParameterStore(tst.SquaredL2Updater(), cfg, w0,
                                  n_shards=2, staleness=1, device="cpu")
    rec = LocksetRecorder()
    instrument_object(store, store_mod.GRAFTLINT_LOCKS["ParameterStore"],
                      rec, owner="ParameterStore")
    for p in store._pipes:
        instrument_object(p, shard_mod.GRAFTLINT_LOCKS["ShardPipeline"],
                          rec, owner="ShardPipeline")
    shards = shard_rows(X, y, 2)
    workers = [ReplicaWorker(f"w{s}", s, store, tst.LeastSquaresGradient(),
                             cfg, *shards[s], device="cpu")
               for s in range(2)]
    for s in range(2):
        store.register_worker(f"w{s}", s)
    threads = [threading.Thread(target=w.run) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    store.stop()
    assert store.version == 20
    assert rec.checked_accesses > 0
    assert rec.violations == []
    assert rec.races() == []
    assert ("ParameterStore._cond",
            "ShardPipeline._cond") in rec.order_pairs
    assert_lock_order(rec)


def test_shard_imbalance_detector_trips_on_lagging_shard_only():
    from tpu_sgd_torch.obs.detect import (DetectorEngine,
                                          ShardImbalanceDetector,
                                          default_detectors)

    assert "shard-imbalance" not in {d.rule for d in default_detectors()}

    def _win(idx, series):
        return {"index": idx, "t_start": float(idx),
                "t_end": float(idx) + 1.0, "series": series}

    def _cnt(n):
        return {"count": n, "sum": 0.0, "mean": 0.0, "max": None,
                "bytes": 0}

    eng = DetectorEngine([ShardImbalanceDetector()])
    eng.on_window_close(_win(0, {"replica.shard.push[s0]": _cnt(20),
                                 "replica.shard.push[s1]": _cnt(18)}))
    assert eng.trip_counts() == {}
    eng.on_window_close(_win(1, {"replica.shard.push[s0]": _cnt(20),
                                 "replica.shard.push[s1]": _cnt(2)}))
    assert eng.trip_counts() == {"shard-imbalance": 1}
    eng2 = DetectorEngine([ShardImbalanceDetector()])
    eng2.on_window_close(_win(0, {"replica.shard.push[s0]": _cnt(4),
                                  "replica.shard.push[s1]": _cnt(0)}))
    assert eng2.trip_counts() == {}
    eng2.on_window_close(_win(1, {"replica.shard.push[s0]": _cnt(50)}))
    assert eng2.trip_counts() == {}
