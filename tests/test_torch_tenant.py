"""Multi-tenant plane of the PyTorch port (``tpu_sgd_torch/tenant``) on
the CPU: the twins of ``tests/test_tenant.py`` (its scenario cases belong
to the scenario harness, not ported; ``test_choose_slab_capacity`` is
twinned in ``tests/test_torch_plan.py``), and parity with the JAX package
(``tpu_sgd/tenant``).

The pins: an M=1 (and any uniform) slab batch is BITWISE the single-model
``PredictEngine`` path; the ops and padded shapes a mixed batch runs are
independent of tenant count; the LRU admission/eviction ledger is exact
(and the JAX package's); a hot reload of tenant i leaves tenant j's row
bitwise unchanged, also for a predict that snapshotted the slab before
the swap; slab state rides CRC-sealed checkpoint frames that either
package reads and both refuse when tampered.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import tpu_sgd.tenant as jtenant
from tpu_sgd.utils import CheckpointManager as JCheckpointManager
from tpu_sgd_torch.models import LinearRegressionModel
from tpu_sgd_torch.serve import MicroBatcher, Overloaded, PredictEngine
from tpu_sgd_torch.tenant import (SlabFullError, TenantMissingError,
                                  TenantModelStore, TenantPredictEngine,
                                  TenantServer, WeightSlab)
from tpu_sgd_torch.utils import CheckpointManager

D = 12
CPU = "cpu"


def _store(tmp_path, rng, n_tenants=8, capacity=4, d=D, name="tenants",
           **kw):
    store = TenantModelStore(str(tmp_path / name), capacity=capacity, d=d,
                             device=CPU, **kw)
    weights = rng.normal(size=(n_tenants, d)).astype(np.float32)
    for t in range(n_tenants):
        store.publish(t, weights[t], intercept=0.125 * t)
    return store, weights


def _model(w, b):
    return LinearRegressionModel(w, b, device=CPU)


class _OpCount(TorchDispatchMode):
    """Counts the aten ops a region dispatches (the port's counterpart of
    the JAX package's dispatch count)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# -- (a) the bitwise M=1 pin ------------------------------------------------
def test_m1_slab_predict_bitwise_matches_predict_engine(tmp_path, rng):
    store, weights = _store(tmp_path, rng, n_tenants=1, capacity=1)
    tengine = TenantPredictEngine(store)
    sengine = PredictEngine(device=CPU)
    model = _model(weights[0], 0.0)
    for n in (1, 3, 8, 17):
        X = rng.normal(size=(n, D)).astype(np.float32)
        np.testing.assert_array_equal(
            tengine.predict_batch(np.zeros(n, np.int64), X),
            sengine.predict_batch(model, X))


def test_uniform_batch_of_many_tenant_slab_is_still_bitwise(tmp_path, rng):
    store, weights = _store(tmp_path, rng, n_tenants=6, capacity=6)
    tengine = TenantPredictEngine(store)
    sengine = PredictEngine(device=CPU)
    X = rng.normal(size=(5, D)).astype(np.float32)
    for t in (0, 3, 5):
        np.testing.assert_array_equal(
            tengine.predict_batch(np.full(5, t), X),
            sengine.predict_batch(_model(weights[t], 0.125 * t), X))


def test_mixed_batch_matches_reference_to_tolerance(tmp_path, rng):
    store, weights = _store(tmp_path, rng, n_tenants=6, capacity=6)
    tengine = TenantPredictEngine(store)
    tids = np.array([0, 3, 5, 3, 1])
    X = rng.normal(size=(5, D)).astype(np.float32)
    got = tengine.predict_batch(tids, X)
    want = np.array([X[i] @ weights[t] + 0.125 * t
                     for i, t in enumerate(tids)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- (b) LRU admission/eviction ledger --------------------------------------
def test_lru_ledger_exactness(rng):
    slab = WeightSlab(2, D, device=CPU)
    w = rng.normal(size=(4, D)).astype(np.float32)
    assert slab.put(10, w[0]) == (0, None, "admitted")
    assert slab.put(11, w[1]) == (1, None, "admitted")
    assert slab.put(10, w[2]) == (0, None, "swapped")
    assert slab.put(12, w[3]) == (1, 11, "admitted")
    assert slab.resident() == (10, 12)
    assert slab.evictions == [(11, 1, 12)]
    slab.snapshot_for([10])
    assert slab.put(13, w[0]) == (1, 12, "admitted")
    assert slab.ledger_snapshot() == {
        "admitted": 4, "evicted": 2, "swapped": 1,
        "hits": 1, "misses": 0, "resident": 2, "capacity": 2}
    assert slab.staleness_s(12) == float("inf")
    assert slab.staleness_s(10) < 60.0


def test_store_admission_on_miss_and_thrash_guard(tmp_path, rng):
    store, _ = _store(tmp_path, rng, n_tenants=8, capacity=4)
    store.slots_for([0, 1, 2])
    assert sorted(store.slab.resident()) == [0, 1, 2]
    with pytest.raises(SlabFullError):
        store.slots_for(np.arange(8))
    with pytest.raises(TenantMissingError):
        store.load(99)


# -- (c) hot reload row isolation -------------------------------------------
def test_hot_reload_leaves_neighbor_rows_bitwise_unchanged(tmp_path, rng):
    store, weights = _store(tmp_path, rng, n_tenants=4, capacity=4)
    store.slots_for([0, 1, 2, 3])
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(6, D)).astype(np.float32)
    before = {t: tengine.predict_batch(np.full(6, t), X) for t in range(4)}
    mixed = np.array([0, 1, 3, 0, 1, 3])
    mixed_before = tengine.predict_batch(mixed, X)
    ledger0 = store.slab.ledger_snapshot()
    w_new = rng.normal(size=D).astype(np.float32)
    store.publish(2, w_new, intercept=-1.0)
    ledger1 = store.slab.ledger_snapshot()
    assert ledger1["swapped"] == ledger0["swapped"] + 1
    assert ledger1["admitted"] == ledger0["admitted"]
    assert ledger1["evicted"] == ledger0["evicted"]
    for t in (0, 1, 3):
        np.testing.assert_array_equal(
            tengine.predict_batch(np.full(6, t), X), before[t])
        w_t, _ = store.slab.host_row(t)
        np.testing.assert_array_equal(w_t, weights[t])
    np.testing.assert_array_equal(tengine.predict_batch(mixed, X),
                                  mixed_before)
    np.testing.assert_array_equal(
        tengine.predict_batch(np.full(6, 2), X),
        PredictEngine(device=CPU).predict_batch(_model(w_new, -1.0), X))


def test_snapshot_survives_a_swap_copy_on_write(tmp_path, rng):
    """The slab's thread contract: a ``(slots, W, b)`` snapshot taken
    before a swap still scores the old rows after it — the swap replaced
    the tensors, it never wrote the ones the snapshot holds."""
    from tpu_sgd_torch.ops.bucketed import bucketed_gather_matvec

    store, weights = _store(tmp_path, rng, n_tenants=3, capacity=3)
    tids = np.array([0, 1, 2, 1])
    slots, W, b = store.slots_for(tids)
    W0, b0 = W.clone(), b.clone()
    X = rng.normal(size=(4, D)).astype(np.float32)
    first = bucketed_gather_matvec(X, slots, W, b)
    store.publish(1, rng.normal(size=D).astype(np.float32), intercept=9.0)
    assert torch.equal(W, W0) and torch.equal(b, b0)
    np.testing.assert_array_equal(bucketed_gather_matvec(X, slots, W, b),
                                  first)
    _, W1, b1 = store.slots_for(tids)
    assert W1 is not W and float(b1[store.slab.slot_of(1)]) == 9.0


# -- (d) ops and shapes independent of tenant count -------------------------
def test_dispatch_count_flat_across_tenant_counts(tmp_path, rng):
    """A 32-row mixed batch runs the same aten ops and adds no padded
    shape whether it mixes 16 or 256 tenants (a uniform batch likewise
    at any tenant), and each batch is one engine pass."""
    from tpu_sgd.analysis import assert_compile_count

    store, _ = _store(tmp_path, rng, n_tenants=256, capacity=256)
    store.slots_for(np.arange(256))
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(32, D)).astype(np.float32)
    tengine.predict_batch(np.zeros(32, np.int64), X)
    tengine.predict_batch(np.arange(32) % 16, X)
    ops, passes = {}, {}
    with assert_compile_count(0, of=lambda: tengine.compile_count):
        for m in (1, 16, 256, 7):
            tids = (np.arange(32) * 31) % m if m != 7 else np.full(32, 7)
            before = tengine.dispatch_count
            with _OpCount() as oc:
                tengine.predict_batch(tids, X)
            ops[m], passes[m] = oc.n, tengine.dispatch_count - before
    assert ops[16] == ops[256], ops
    assert ops[1] == ops[7], ops
    assert set(passes.values()) == {1}, passes


def test_hot_reload_never_recompiles(tmp_path, rng):
    from tpu_sgd.analysis import assert_compile_count

    store, _ = _store(tmp_path, rng, n_tenants=8, capacity=4)
    store.slots_for([0, 1, 2, 3])
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(8, D)).astype(np.float32)
    tengine.predict_batch(np.array([0, 1, 2, 3] * 2), X)
    with assert_compile_count(0, of=lambda: tengine.compile_count):
        for i in range(8):
            store.publish(i % 4, rng.normal(size=D).astype(np.float32))
            tengine.predict_batch(np.array([0, 1, 2, 3] * 2), X)


# -- (e) multi-model (shadow/canary) batch ----------------------------------
def test_multi_version_batch_single_dispatch(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path / "versions"), keep=8)
    ws = rng.normal(size=(3, D)).astype(np.float32)
    for v in (1, 2, 3):
        mgr.save(v, ws[v - 1], 0.0, [],
                 extras={"intercept": np.float32(0.5 * v)})
    store = TenantModelStore(str(tmp_path / "slab"), capacity=4, d=D,
                             device=CPU)
    assert store.admit_versions(mgr) == (1, 2, 3)
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(5, D)).astype(np.float32)
    tengine.predict_all(X)  # warm
    before = tengine.dispatch_count
    scores, ids = tengine.predict_all(X)
    assert tengine.dispatch_count == before + 1
    assert scores.shape == (5, 3) and list(ids) == [1, 2, 3]
    for j, v in enumerate(ids):
        np.testing.assert_allclose(scores[:, j], X @ ws[v - 1] + 0.5 * v,
                                   rtol=1e-5, atol=1e-5)


# -- (f) slab state on CRC-sealed frames ------------------------------------
def test_slab_state_roundtrip_and_tamper_detection(tmp_path, rng):
    from tpu_sgd_torch.io.integrity import IntegrityError

    store, weights = _store(tmp_path, rng, n_tenants=6, capacity=4)
    store.slots_for([5, 1, 4])
    store.publish(1, weights[0])
    mgr = CheckpointManager(str(tmp_path / "slab_state"), keep=8)
    v = store.save_state(mgr)
    other = TenantModelStore(str(tmp_path / "other"), capacity=4, d=D,
                             device=CPU)
    assert other.restore_state(mgr) == v
    assert other.slab.resident() == store.slab.resident()
    np.testing.assert_array_equal(other.slab.state()["weights"],
                                  store.slab.state()["weights"])
    assert other.slab.version_of(1) == store.slab.version_of(1)
    ck = mgr.restore_version(v)
    bad_w = np.asarray(ck["weights"]).copy()
    bad_w[0, 0] += 1.0
    mgr.save(v + 1, bad_w, 0.0, [], config_key="tenant-slab",
             extras=dict(ck["extras"]))
    with pytest.raises(IntegrityError, match="tenant.slab"):
        other.restore_state(mgr)


# -- (g) per-tenant obs series ----------------------------------------------
class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, dict(payload)))


def test_per_tenant_obs_series(tmp_path, rng):
    from tpu_sgd_torch.obs import counters, spans, timeseries

    store, _ = _store(tmp_path, rng, n_tenants=6, capacity=2)
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(4, D)).astype(np.float32)
    spans.enable_tracing(_Sink())
    counters.enable()
    timeseries.enable(width_s=60.0)
    try:
        tengine.predict_batch(np.array([0, 1, 0, 1]), X)  # admits 0, 1
        tengine.predict_batch(np.full(4, 2), X)           # evicts one
        store.publish(2, rng.normal(size=D).astype(np.float32))  # swap
        wins = timeseries.snapshot()
    finally:
        timeseries.disable()
        counters.disable()
        spans.disable_tracing()
    names = {n for w in wins for n in w["series"]}
    assert {"tenant.admit", "tenant.admit[0]", "tenant.admit[1]",
            "tenant.evict", "tenant.swap[2]",
            "tenant.predict[2]", "tenant.predict.staleness_s",
            "tenant.batch"} <= names, names


def test_slab_thrash_detector_reads_the_ports_windows(tmp_path, rng):
    """The port's slab-thrash rule (``obs/detect.py``) on the port's
    windows, which carry the series it reads in its layout: a churning
    slab trips it, a fitting one does not."""
    from tpu_sgd_torch.obs.detect import SlabThrashDetector
    from tpu_sgd_torch.obs import counters, spans, timeseries

    det = SlabThrashDetector(max_evict_frac=0.5, min_admits=16)
    clock = {"t": 0.5}
    for capacity, trips in ((2, 1), (40, 0)):
        store, _ = _store(tmp_path, rng, n_tenants=40, capacity=capacity,
                          name=f"thrash{capacity}")
        store_ts = timeseries.WindowStore(width_s=1.0,
                                          clock=lambda: clock["t"])
        spans.enable_tracing(_Sink())
        counters.enable()
        timeseries.enable(width_s=1.0)
        timeseries._STORE = store_ts
        try:
            for t in range(40):
                store.slots_for([t])
            window = store_ts.snapshot()[-1]
        finally:
            timeseries.disable()
            counters.disable()
            spans.disable_tracing()
        assert len(det.evaluate(window, [])) == trips, (capacity, window)


def _thrash_window(series: dict) -> dict:
    return {"index": 0, "t_start": 0.0, "t_end": 1.0,
            "series": {k: {"count": v} for k, v in series.items()}}


def test_slab_thrash_detector_fixtures():
    from tpu_sgd.obs.detect import SlabThrashDetector as JSlabThrash
    from tpu_sgd_torch.obs.detect import SlabThrashDetector

    det = SlabThrashDetector(max_evict_frac=0.5, min_admits=16)
    jdet = JSlabThrash(max_evict_frac=0.5, min_admits=16)
    for series in ({"tenant.admit": 40, "tenant.evict": 10},  # healthy
                   {"tenant.admit": 64},                      # cold fill
                   {"tenant.admit": 8, "tenant.evict": 8}):   # low volume
        assert det.evaluate(_thrash_window(series), []) == []
    w = _thrash_window({"tenant.admit": 32, "tenant.evict": 30})
    alerts = det.evaluate(w, [])
    assert len(alerts) == 1
    a = alerts[0]
    assert a.rule == "slab-thrash" and a.series == "tenant.evict"
    assert a.value == 30.0 and a.bound == 16.0
    j, = jdet.evaluate(w, [])
    assert (a.rule, a.series, a.value, a.bound, a.detail) == (
        j.rule, j.series, j.value, j.bound, j.detail)


def test_slab_thrash_detector_is_opt_in():
    from tpu_sgd_torch.obs.detect import default_detectors

    assert "slab-thrash" not in {d.rule for d in default_detectors()}


# -- (h) vectorized burst admission -----------------------------------------
def test_submit_burst_one_lock_round_counted(rng):
    b = MicroBatcher(lambda X: np.zeros(len(X), np.float32),
                     max_batch=8, max_queue=256, shed_utilization={})
    X = rng.normal(size=(50, 4)).astype(np.float32)
    futs = b.submit_burst(list(X))
    assert len(futs) == 50
    assert b.admission_snapshot() == {"lock_rounds": 1, "priced": 50}
    for i in range(50):
        b.submit(X[i])
    assert b.admission_snapshot() == {"lock_rounds": 51, "priced": 100}
    b.stop()
    assert all(f.result(timeout=30) == 0.0 for f in futs)


def test_submit_burst_decision_equivalent_to_sequential(rng):
    X = rng.normal(size=(64, 4)).astype(np.float32)

    def mk():
        return MicroBatcher(lambda Z: np.zeros(len(Z), np.float32),
                            max_batch=8, max_queue=16,
                            shed_utilization={"batch": 0.5})

    seq = mk()
    seq_out = []
    for i in range(20):
        try:
            seq.submit(X[i], lane="batch")
            seq_out.append("admitted")
        except Overloaded as e:
            seq_out.append(e.reason)
    bur = mk()
    futs = bur.submit_burst(list(X[:20]), lane="batch")
    bur_out = ["admitted" if not f.done() else f.exception().reason
               for f in futs]
    assert bur_out == seq_out
    assert bur.lane_snapshot() == seq.lane_snapshot()
    full = MicroBatcher(lambda Z: np.zeros(len(Z), np.float32),
                        max_batch=8, max_queue=4, shed_utilization={})
    low = [full.submit(X[i], lane="batch") for i in range(4)]
    futs = full.submit_burst(list(X[:3]), lane="interactive")
    assert sum(1 for f in low if f.done()
               and isinstance(f.exception(), Overloaded)
               and f.exception().reason == "displaced") == 3
    assert all(not f.done() for f in futs)
    assert full.lane_snapshot()["batch"]["displaced"] == 3


def test_submit_burst_deadline_priced_in_one_pass(rng):
    b = MicroBatcher(lambda Z: np.zeros(len(Z), np.float32),
                     max_batch=4, max_queue=64, shed_utilization={})
    with b._cond:
        b._p99_wall = 0.1
    X = rng.normal(size=(10, 4)).astype(np.float32)
    futs = b.submit_burst(list(X), deadline_s=0.25)
    outcomes = ["admitted" if not f.done() else f.exception().reason
                for f in futs]
    assert outcomes == ["admitted"] * 8 + ["deadline"] * 2


# -- (i) shed thresholds from config ----------------------------------------
def test_shed_thresholds_from_config_and_runtime_actuation():
    from tpu_sgd_torch.config import (ServingConfig, serving_config,
                                      set_serving_config)

    assert serving_config().shed_utilization == {"batch": 0.75,
                                                 "shadow": 0.50}
    prev = set_serving_config(ServingConfig(shed_utilization={"batch": 0.25}))
    try:
        b = MicroBatcher(lambda Z: np.zeros(len(Z), np.float32),
                         max_batch=4, max_queue=8)
        assert b.shed_utilization == {"batch": 0.25}
        b.submit(np.zeros(4, np.float32), lane="batch")
        b.submit(np.zeros(4, np.float32), lane="batch")
        with pytest.raises(Overloaded, match="shed"):
            b.submit(np.zeros(4, np.float32), lane="batch")
        b.set_shed_utilization({"batch": 0.75})
        b.submit(np.zeros(4, np.float32), lane="batch")
        with pytest.raises(ValueError):
            b.set_shed_utilization({"nope": 0.5})
        with pytest.raises(ValueError):
            b.set_shed_utilization({"batch": 1.5})
    finally:
        set_serving_config(prev)
    with pytest.raises(ValueError):
        ServingConfig(shed_utilization={"batch": 0.0})
    with pytest.raises(TypeError):
        set_serving_config({"batch": 0.5})


# -- (j) the tenant server end to end ---------------------------------------
def test_tenant_server_routes_rows_to_their_tenants(tmp_path, rng):
    store, weights = _store(tmp_path, rng, n_tenants=6, capacity=6)
    with TenantServer(store, max_batch=16, max_latency_s=0.003) as srv:
        tids = [0, 5, 2, 5, 1, 0]
        xs = rng.normal(size=(6, D)).astype(np.float32)
        futs = [srv.submit(t, xs[i]) for i, t in enumerate(tids)]
        Xb = rng.normal(size=(4, D)).astype(np.float32)
        bfuts = srv.submit_burst([3, 4, 3, 4], Xb)
        got = [f.result(timeout=30) for f in futs + bfuts]
        hz = srv.healthz()
    want = [xs[i] @ weights[t] + 0.125 * t for i, t in enumerate(tids)] + [
        Xb[i] @ weights[t] + 0.125 * t for i, t in enumerate([3, 4, 3, 4])]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert hz["slab"]["resident"] == 6
    assert hz["engine"]["dispatches"] >= 1
    assert hz["admission"]["priced"] == 10
    assert hz["admission"]["lock_rounds"] == 7
    with pytest.raises(ValueError, match="2\\*\\*24"):
        srv.submit(1 << 24, np.zeros(D, np.float32))


# -- (k) publish-storm lock discipline (the JAX package's runtime twin) -----
def test_publish_storm_lock_discipline_validated_at_runtime(tmp_path, rng):
    """A publish/load storm on ONE tenant under the JAX package's runtime
    lock instrumentation, with the port's own declarations: every guarded
    access holds its declared lock, no Eraser race, the acquisition
    order replays clean against the committed order — and the per-tenant
    publish lock keeps the slab row and the latest checkpoint version in
    lockstep."""
    from tpu_sgd.analysis import runtime

    _publish_storm_lock_run(tmp_path, rng, runtime)


def test_publish_storm_lock_discipline_validated_by_the_port_runtime(
        tmp_path, rng):
    """The same storm under the port's own runtime checkers, replayed
    against the port's committed lock order."""
    from tpu_sgd_torch.analysis import runtime

    _publish_storm_lock_run(tmp_path, rng, runtime)


def _publish_storm_lock_run(tmp_path, rng, runtime):
    import threading

    LocksetRecorder = runtime.LocksetRecorder
    assert_lock_order = runtime.assert_lock_order
    instrument_object = runtime.instrument_object
    from tpu_sgd_torch.tenant import slab as slab_mod
    from tpu_sgd_torch.tenant import store as tenant_store_mod

    store = TenantModelStore(str(tmp_path / "storm"), capacity=4, d=D,
                             device=CPU)
    w = rng.normal(size=(24, D)).astype(np.float32)
    store.publish(7, w[0], intercept=0.5)
    rec = LocksetRecorder()
    instrument_object(
        store, tenant_store_mod.GRAFTLINT_LOCKS["TenantModelStore"], rec)
    instrument_object(store.slab, slab_mod.GRAFTLINT_LOCKS["WeightSlab"],
                      rec)

    def publisher():
        for i in range(1, 20):
            store.publish(7, w[i], intercept=0.5 * i)

    def loader():
        for _ in range(20):
            store.load(7)

    threads = [threading.Thread(target=publisher, name="publish"),
               threading.Thread(target=loader, name="load")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert rec.checked_accesses > 0
    assert rec.violations == []
    assert rec.races() == []
    assert_lock_order(rec)
    assert store.slab.version_of(7) == store._manager(7).latest_version()


# -- parity with the JAX package --------------------------------------------
_OPS = [("put", 10, 0), ("put", 11, 1), ("put", 10, 2), ("touch", 11),
        ("put", 12, 3), ("put", 13, 0), ("touch", 13), ("put", 14, 1),
        ("touch", 14, 12), ("put", 12, 2), ("put", 15, 3), ("put", 10, 0)]


def _drive_slab(slab, w):
    out = []
    for op in _OPS:
        if op[0] == "put":
            out.append(tuple(slab.put(op[1], w[op[2]], 0.1 * op[2])))
        else:
            try:
                slab.snapshot_for(list(op[1:]))
                out.append("hit")
            except KeyError as e:
                out.append(("miss", sorted(e.args[0])))
    return out, slab.resident(), slab.evictions, slab.ledger_snapshot()


def test_slab_lru_ledger_and_eviction_order_equal_the_jax_package(rng):
    w = rng.normal(size=(4, D)).astype(np.float32)
    got = _drive_slab(WeightSlab(3, D, device=CPU), w)
    want = _drive_slab(jtenant.WeightSlab(3, D), w)
    assert got == want
    assert got[2], "the script evicts"


def test_slab_put_then_resolve_equals_the_jax_package_puts_and_snapshot(rng):
    """One lock round of admissions and a resolve (the store's batch
    admission) gives what the JAX package's puts one by one and its
    ``snapshot_for`` give once the batch's resident rows are made the
    hottest first: the puts, the slots, the ledger and the eviction log.
    (The JAX package puts first, so its second round evicts tenant 10,
    a resident row of the batch being admitted, and misses it: the
    fault the port's round no longer has.)"""
    w = rng.normal(size=(6, D)).astype(np.float32)
    got, want = WeightSlab(3, D, device=CPU), jtenant.WeightSlab(3, D)
    for slab in (got, want):
        slab.put(20, w[5], 0.5, version=1)
    for rows, resolve in (([(10, w[0], 0.1, 3), (11, w[1], 0.2, 4)],
                           [10, 11, 10, 20]),
                          ([(12, w[2], 0.3, 5)], [12, 20, 10]),
                          ([(13, w[3], 0.4, 6), (10, w[4], 0.6, 7)], None)):
        puts, snap, missing = got.put_then_resolve(rows, resolve)
        for tid in dict.fromkeys(resolve or ()):
            if tid in want._lru:
                want._lru.move_to_end(tid)
        assert puts == [tuple(want.put(*r[:3], version=r[3])) for r in rows]
        if resolve is None:
            assert snap is None and missing is None
            continue
        slots, _, _ = want.snapshot_for(resolve)
        assert missing is None
        np.testing.assert_array_equal(snap[0], slots)
    assert got.resident() == want.resident()
    assert got.evictions == want.evictions
    assert got.ledger_snapshot() == want.ledger_snapshot()
    assert got.ledger_snapshot()["misses"] == 0
    assert got.evictions[0] == (11, 2, 12)  # 11 is not in the batch


def test_slab_admission_never_evicts_its_own_batch():
    """The eviction order behind the tenant-stress scenario's spurious
    SlabFullError, with no threads: a full slab whose coldest rows belong
    to the batch being admitted.  The batch's puts evict only rows outside
    it, so a batch that fits resolves in one round; one whose distinct
    tenants exceed the capacity still cannot."""
    slab = WeightSlab(4, D, device=CPU)
    row = np.zeros(D, np.float32)
    for tid in (1, 2, 3, 4):  # 1 is the coldest, then 2
        slab.put(tid, row)
    puts, snap, missing = slab.put_then_resolve(
        [(5, row, 0.0, 0), (6, row, 0.0, 0)], [1, 5, 2, 6, 1])
    assert missing is None and snap is not None
    assert [p[1] for p in puts] == [3, 4]  # never 1 or 2
    assert slab.resident() == (1, 2, 5, 6)
    assert slab.ledger_snapshot()["misses"] == 0
    _, snap, missing = slab.put_then_resolve(
        [(t, row, 0.0, 0) for t in (7, 8, 9)], [1, 2, 5, 6, 7, 8, 9])
    assert snap is None and missing  # 7 distinct tenants, 4 slots


def test_store_resolves_a_batch_that_fits_in_one_admission_round(tmp_path,
                                                                  rng):
    """The store's resolve over a full slab whose coldest rows are the
    batch's: one miss, one admission round, and no SlabFullError however
    the storm reorders the slab between batches; a batch wider than the
    slab still raises."""
    store, _ = _store(tmp_path, rng, n_tenants=8, capacity=4)
    store.slots_for([0, 1, 2, 3])
    for batch in ([0, 1, 4, 5], [2, 3, 6, 7], [4, 0, 7, 1]):
        cold = list(store.slab.resident())
        for tid in reversed(cold):  # the batch's rows become the coldest
            if tid not in batch:
                store.slab.snapshot_for([tid])
        before = store.slab.ledger_snapshot()["misses"]
        slots, _, _ = store.slots_for(batch)
        assert len(slots) == len(batch)
        missing = {t for t in batch if t not in cold}
        assert store.slab.ledger_snapshot()["misses"] - before == len(
            missing)
        assert set(batch) <= set(store.slab.resident())
    with pytest.raises(SlabFullError):
        store.slots_for(np.arange(6))


def test_store_admission_and_thrash_guard_equal_the_jax_package(tmp_path,
                                                                rng):
    """The same publishes and resolves against both stores: residency,
    the eviction log and the ledger after each step, the thrash guard's
    SlabFullError, and the mixed-batch scores (tight).  The JAX package's
    store admits a batch's missing tenants while the batch's resident
    rows may be the coldest, so it can evict its own batch (tenant 9 of
    ``[5, 5, 1, 0, 9, 9]``) and need another round; the port makes those
    rows the hottest first.  The JAX store here does the same, through a
    miss hook on its slab, so the two walk the same eviction log."""
    ws = rng.normal(size=(10, D)).astype(np.float32)
    tstore = TenantModelStore(str(tmp_path / "t"), capacity=4, d=D,
                              device=CPU)
    jstore = jtenant.TenantModelStore(str(tmp_path / "j"), capacity=4, d=D)
    jslab, jsnapshot = jstore.slab, jstore.slab.snapshot_for

    def snapshot_touching_on_miss(tenant_ids):
        try:
            return jsnapshot(tenant_ids)
        except KeyError:
            for tid in dict.fromkeys(np.asarray(tenant_ids).tolist()):
                if tid in jslab._lru:
                    jslab._lru.move_to_end(tid)
            raise

    jslab.snapshot_for = snapshot_touching_on_miss
    for s in (tstore, jstore):
        for t in range(10):
            s.publish(t, ws[t], intercept=0.25 * t)
    te, je = TenantPredictEngine(tstore), jtenant.TenantPredictEngine(jstore)
    X = rng.normal(size=(6, D)).astype(np.float32)
    for tids in ([0, 1, 2], [3, 0, 3], [9, 8, 7, 6], [5, 5, 1, 0, 9, 9],
                 [2, 2, 2, 2, 2, 2]):
        tids = np.asarray(tids)
        got = te.predict_batch(tids, X[:len(tids)])
        want = je.predict_batch(tids, X[:len(tids)])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        assert tstore.slab.resident() == jstore.slab.resident()
        assert tstore.slab.evictions == jstore.slab.evictions
        assert (tstore.slab.ledger_snapshot()
                == jstore.slab.ledger_snapshot())
    for s, err in ((tstore, SlabFullError), (jstore, jtenant.SlabFullError)):
        with pytest.raises(err):
            s.slots_for(np.arange(6))
    assert tstore.slab.ledger_snapshot() == jstore.slab.ledger_snapshot()


def test_uniform_and_mixed_scores_match_the_jax_package(tmp_path, rng):
    for act in (None, "sigmoid"):
        ws = rng.normal(size=(5, D)).astype(np.float32)
        tstore = TenantModelStore(str(tmp_path / f"t{act}"), capacity=8,
                                  d=D, activation=act, device=CPU)
        jstore = jtenant.TenantModelStore(str(tmp_path / f"j{act}"),
                                          capacity=8, d=D, activation=act)
        for s in (tstore, jstore):
            for t in range(5):
                s.publish(t, ws[t], intercept=-0.5 * t)
        te = TenantPredictEngine(tstore)
        je = jtenant.TenantPredictEngine(jstore)
        for n in (1, 7, 600):
            X = rng.normal(size=(n, D)).astype(np.float32)
            for tids in (np.full(n, 3), np.arange(n) % 5):
                want = je.predict_batch(tids, X)
                np.testing.assert_allclose(
                    te.predict_batch(tids, X), want, rtol=1e-5,
                    atol=1e-5 * np.abs(want).max())
        got, gids = te.predict_all(X[:9])
        want, wids = je.predict_all(X[:9])
        np.testing.assert_array_equal(gids, wids)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        single = PredictEngine(device=CPU).predict_batch(
            _model(ws[3], -1.5) if act is None else
            _logistic(ws[3], -1.5), X[:9])
        np.testing.assert_array_equal(te.predict_batch(np.full(9, 3), X[:9]),
                                      single)


def _logistic(w, b):
    from tpu_sgd_torch.models import LogisticRegressionModel

    return LogisticRegressionModel(w, b, device=CPU).clear_threshold()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sealed_slab_state_crosses_packages(tmp_path, rng, writer):
    """A sealed slab state saved by one package restores in the other
    (residency, rows, versions), and a tampered frame is refused by
    both with a typed IntegrityError."""
    from tpu_sgd.io.integrity import IntegrityError as JIntegrityError
    from tpu_sgd_torch.io.integrity import IntegrityError

    ws = rng.normal(size=(6, D)).astype(np.float32)
    tstore = TenantModelStore(str(tmp_path / "t"), capacity=4, d=D,
                              device=CPU)
    jstore = jtenant.TenantModelStore(str(tmp_path / "j"), capacity=4, d=D)
    src, dst = (tstore, jstore) if writer == "port" else (jstore, tstore)
    for t in range(6):
        src.publish(t, ws[t], intercept=0.5 * t)
    src.slots_for([5, 1, 4])
    src.publish(1, ws[0])
    mgr_cls = CheckpointManager if writer == "port" else JCheckpointManager
    mgr = mgr_cls(str(tmp_path / "state"), keep=8)
    v = src.save_state(mgr)
    assert dst.restore_state(mgr) == v
    assert dst.slab.resident() == src.slab.resident()
    np.testing.assert_array_equal(dst.slab.state()["weights"],
                                  src.slab.state()["weights"])
    assert dst.slab.version_of(1) == src.slab.version_of(1)
    ck = mgr.restore_version(v)
    bad_w = np.asarray(ck["weights"]).copy()
    bad_w[1, 2] += 1.0
    mgr.save(v + 1, bad_w, 0.0, [], config_key="tenant-slab",
             extras=dict(ck["extras"]))
    with pytest.raises(IntegrityError, match="tenant.slab"):
        tstore.restore_state(mgr)
    with pytest.raises(JIntegrityError, match="tenant.slab"):
        jstore.restore_state(mgr)


def test_slab_swaps_under_concurrent_scoring_stress(tmp_path, rng):
    """More scoring and publishing threads than cores, with a short
    switch interval: every mixed row scores under exactly one published
    version of its tenant, and the rows of one tenant in one batch under
    the same one (a swap never tears the snapshot a batch holds)."""
    import sys
    import threading

    store, weights = _store(tmp_path, rng, n_tenants=4, capacity=4)
    store.slots_for([0, 1, 2, 3])
    tengine = TenantPredictEngine(store)
    X = rng.normal(size=(16, D)).astype(np.float32)
    tids = np.arange(16) % 4
    seen, errors = [], []

    def publish(t):
        try:
            for v in range(1, 16):
                store.publish(t, weights[t] * (1.0 + v), intercept=float(v))
        except BaseException as e:
            errors.append(e)

    def score():
        try:
            for _ in range(20):
                seen.append(tengine.predict_batch(tids, X))
        except BaseException as e:
            errors.append(e)

    threads = ([threading.Thread(target=publish, args=(t,)) for t in (1, 3)]
               + [threading.Thread(target=score) for _ in range(4)])
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(seen) == 80
    base = (X.astype(np.float64) * weights[tids]).sum(1)
    for out in seen:
        chosen = {}
        for j, t in enumerate(tids):
            if t in (0, 2):  # never republished
                np.testing.assert_allclose(out[j], base[j] + 0.125 * t,
                                           rtol=1e-5, atol=1e-5)
                continue
            # version v scores base * (1 + v) + v (v = 0: the original)
            hits = [v for v in range(16)
                    if abs(out[j] - (base[j] * (1 + v)
                                     + (v if v else 0.125 * t)))
                    <= 1e-4 * (1 + abs(out[j]))]
            assert len(hits) == 1, (j, t, out[j], hits)
            assert chosen.setdefault(t, hits[0]) == hits[0]
