"""The port's windowed time series (``tpu_sgd_torch/obs/timeseries.py``)
and liveness plane (``tpu_sgd_torch/reliability/health.py``) on the CPU:
the twins of the JAX package's cases (``tests/test_obs.py``,
``tests/test_reliability.py``, ``tests/test_integrity.py``) and exact
parity with it — the window aggregates through ``WindowStore``'s
injectable clock, the heartbeat and straggler verdicts with
``time.monotonic`` patched the same way in both packages' ``health``
modules.  Nothing here sleeps or reads a wall clock for a verdict.
"""

import threading

import numpy as np
import pytest

import tpu_sgd.obs.timeseries as jts
import tpu_sgd.reliability.health as jhealth
from tpu_sgd.utils.events import CollectingListener as JCollectingListener
import tpu_sgd_torch.obs.timeseries as ts
import tpu_sgd_torch.reliability.health as health
from tpu_sgd_torch.obs import counters, spans
from tpu_sgd_torch.reliability import HealthMonitor, Heartbeat
from tpu_sgd_torch.utils.events import CollectingListener


class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, dict(payload)))


class _obs_on:
    """Tracing, counters and the live window store on, as the JAX
    package's ``obs.enable`` turns them on together."""

    def __init__(self, width_s=60.0):
        self.width_s = width_s

    def __enter__(self):
        spans.enable_tracing(_Sink())
        counters.enable()
        return ts.enable(width_s=self.width_s)

    def __exit__(self, *exc):
        ts.flush()
        ts.disable()
        counters.disable()
        spans.disable_tracing()


def _mk_store(mod=ts, width=1.0, **kw):
    clock = {"t": 0.0}
    store = mod.WindowStore(width_s=width, clock=lambda: clock["t"], **kw)
    return store, clock


def test_window_store_aggregates_and_nearest_rank_parity():
    from tpu_sgd_torch.serve.metrics import ServingMetrics

    store, clock = _mk_store()
    samples = [0.010, 0.012, 0.011, 0.200, 0.003, 0.050, 0.007]
    for v in samples:
        store.observe("serve.batch", value=v)
    clock["t"] = 1.5
    store.observe("serve.batch", value=1.0)
    w0 = store.snapshot()[0]
    assert w0["closed"] is True
    s = w0["series"]["serve.batch"]
    assert s["count"] == len(samples)
    assert s["sum"] == pytest.approx(sum(samples))
    assert s["max"] == 0.200
    metrics = ServingMetrics()
    metrics.record_batch(queue_depth=0, batch_size=len(samples),
                         padded_size=8, latencies=samples, reject_count=0)
    assert s["p50"] == metrics.latency_percentile(50)
    assert s["p99"] == metrics.latency_percentile(99)


def test_window_store_ring_and_sample_bounds_under_long_run():
    store, clock = _mk_store(max_windows=32, samples_per_series=64)
    for i in range(10_000):
        clock["t"] = float(i)
        store.observe("train.loss", value=float(i % 7))
    assert len(store._windows) == 32
    assert len(store.snapshot()) == 33
    store2, _ = _mk_store(samples_per_series=64)
    for i in range(10_000):
        store2.observe("x", value=float(i))
    s = store2.snapshot()[0]["series"]["x"]
    assert s["count"] == 10_000
    assert s["samples_capped"] is True
    assert s["max"] == 9999.0
    assert s["sum"] == pytest.approx(sum(range(10_000)))


def test_window_store_flush_and_late_records():
    store, clock = _mk_store()
    closed = []
    store.add_close_listener(lambda w: closed.append(w))
    clock["t"] = 5.5
    store.observe("a", value=1.0)
    store.observe("b", ts=4.2)  # late cross-thread record: folds in
    store.flush()
    assert len(closed) == 1
    assert closed[0]["series"]["a"]["count"] == 1
    assert closed[0]["series"]["b"]["count"] == 1
    assert store.snapshot() == [closed[0]]
    store.observe("a", value=2.0)
    store.flush()
    assert [w["index"] for w in store.snapshot()] == [5, 6]
    store.close()


def test_window_store_concurrent_close_joins_dispatch_thread():
    store, _ = _mk_store()
    store.add_close_listener(lambda snap: None)
    t = store._dispatch_thread
    assert t is not None and t.is_alive()
    closers = [threading.Thread(target=store.close, name=f"close{i}")
               for i in range(3)]
    for c in closers:
        c.start()
    for c in closers:
        c.join(timeout=30)
    assert not any(c.is_alive() for c in closers)
    assert not t.is_alive()


def test_raising_close_listener_is_dropped_not_fatal():
    store, clock = _mk_store()
    seen = []

    def boom(w):
        raise ValueError("listener exploded")

    store.add_close_listener(boom)
    store.add_close_listener(seen.append)
    store.observe("a", value=1.0)
    clock["t"] = 2.0
    store.observe("a", value=2.0)
    store.flush()
    assert [w["index"] for w in seen] == [0, 2]
    store.close()


def _feed(store, clock):
    """One fixed script of observations: values, counts with bytes, late
    records, window rolls and a mid-run flush."""
    rng = np.random.default_rng(3)
    for i in range(400):
        clock["t"] = 0.37 * i + 0.01
        store.observe(f"s{i % 3}", value=float(rng.normal()))
        if i % 5 == 0:
            store.observe("bytes", n=2, nbytes=64 * i)
        if i % 17 == 0:
            store.observe("late", value=1.0, ts=clock["t"] - 3.0)
        if i == 211:
            store.flush()
    return store.snapshot(), store.snapshot(prefix="s1", last=5)


def test_window_aggregates_equal_the_jax_package():
    """The same script through the port's and the JAX package's
    WindowStore on one synthetic clock: identical snapshots (indices,
    edges, count/sum/max/mean/bytes, p50/p99, capping)."""
    got = _feed(*_mk_store(ts, width=2.0, max_windows=16,
                           samples_per_series=7))
    want = _feed(*_mk_store(jts, width=2.0, max_windows=16,
                            samples_per_series=7))
    assert got == want


def test_module_hooks_feed_spans_events_counters_and_scalars():
    assert ts.snapshot() is None and not ts.is_enabled()
    ts.observe_scalar("x", 1.0)  # disabled: a no-op
    with _obs_on():
        with spans.span("serve.batch", batch=3):
            pass
        spans.event("tenant.predict", tenant=7, staleness_s=0.25)
        spans.event("tenant.evict", tenant=2, error="boom")
        counters.inc("serve.reject", 2, nbytes=10)
        ts.observe_scalar("train.loss", 0.5)
        wins = ts.snapshot()
    series = wins[-1]["series"]
    assert series["serve.batch"]["count"] == 1
    assert series["tenant.predict"]["count"] == 1
    assert series["tenant.predict[7]"]["count"] == 1
    assert series["tenant.predict.staleness_s"]["sum"] == 0.25
    assert series["tenant.evict.error[2]"]["count"] == 1
    assert series["serve.reject"]["count"] == 2
    assert series["serve.reject"]["bytes"] == 10
    assert series["train.loss"]["max"] == 0.5
    assert ts.snapshot() is None


def test_enable_twice_keeps_the_running_store():
    with _obs_on(width_s=60.0) as store:
        with pytest.warns(RuntimeWarning, match="already enabled"):
            assert ts.enable(width_s=5.0) is store
        assert ts.enable(width_s=60.0) is store


@pytest.mark.parametrize("path", ["stepwise", "superstep"])
def test_observed_sgd_feeds_the_training_series(path):
    """The observed drivers feed ``train.loss`` / ``train.weight_delta``
    from the host floats they already fetch: one sample an iteration,
    equal to the listener's values."""
    import tpu_sgd_torch as tst

    X, y, _ = tst.linear_data(300, 5, seed=2)
    listener = CollectingListener()
    opt = tst.GradientDescent(device="cpu").set_num_iterations(12) \
        .set_step_size(0.3).set_convergence_tol(0.0).set_listener(listener)
    if path == "superstep":
        opt.set_superstep(4)
    with _obs_on():
        opt.optimize((X, y), np.zeros(5, np.float32))
        wins = ts.snapshot(prefix="train")
    loss = wins[-1]["series"]["train.loss"]
    delta = wins[-1]["series"]["train.weight_delta"]
    events = listener.iterations
    assert loss["count"] == delta["count"] == len(events) == 12
    assert loss["sum"] == pytest.approx(sum(e.loss for e in events),
                                        rel=1e-12)
    assert delta["max"] == max(e.weight_delta_norm for e in events)


# -- the liveness plane -------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _verdicts(mod, clock, stall_after_s):
    """One fixed script of beats, clock moves and samples through a
    package's health module; returns every emitted event's (kind,
    source, value, detail) and the straggler count."""
    listener = (CollectingListener() if mod is health
                else JCollectingListener())
    mon = mod.HealthMonitor(listener=listener, stall_after_s=stall_after_s)
    feed = mon.watch_heartbeat(mod.Heartbeat("feed"))
    flush = mon.watch_heartbeat(mod.Heartbeat("flush"))
    depth = {"n": 3}
    mon.watch_queue("q", lambda: depth["n"])
    mon.watch_queue("dead", lambda: 1 // 0)
    out = [mon.sample_once()]  # before any beat: the queue only
    for step, (dt, beats) in enumerate(((1.0, "f"), (4.0, "fl"),
                                        (6.5, ""), (0.5, "l"), (11.0, "f"),
                                        (2.0, ""))):
        clock.t += dt
        for who in beats:
            (feed if who == "f" else flush).beat()
        depth["n"] = step
        out.append(mon.sample_once())
    mon.unwatch_heartbeat("flush")
    clock.t += 20.0
    out.append(mon.sample_once())
    return ([[(e.kind, e.source, e.value, e.detail) for e in evs]
             for evs in out], mon.straggler_count, len(listener.reliability))


def test_heartbeat_and_straggler_verdicts_equal_the_jax_package(
        monkeypatch):
    clock = _Clock()
    for mod in (health, jhealth):
        monkeypatch.setattr(mod.time, "monotonic", clock)
    got = _verdicts(health, clock, 5.0)
    clock.t = 100.0
    want = _verdicts(jhealth, clock, 5.0)
    assert got == want
    kinds = {k for evs in got[0] for k, *_ in evs}
    assert kinds == {"heartbeat", "straggler", "queue_depth"}
    assert got[1] > 0


def test_health_monitor_emits_heartbeat_queue_and_straggler_events(
        monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(health.time, "monotonic", clock)
    sink = CollectingListener()
    mon = HealthMonitor(listener=sink, stall_after_s=0.01)
    hb = mon.watch_heartbeat(Heartbeat("worker"))
    mon.watch_queue("q", lambda: 7)
    assert mon.sample_once() == list(sink.reliability)
    assert [e.kind for e in sink.reliability] == ["queue_depth"]
    assert sink.reliability[0].value == 7
    hb.beat()
    clock.t += 0.02  # past the stall threshold, without sleeping
    mon.sample_once()
    kinds = [e.kind for e in sink.reliability]
    assert "heartbeat" in kinds and "straggler" in kinds
    assert mon.straggler_count == 1
    assert hb.age_s() == pytest.approx(0.02)


def test_health_monitor_background_thread_lifecycle():
    """The interval thread samples until stopped (driven by an event the
    listener sets, not by sleeping), and stop() really ends it."""
    got_two = threading.Event()

    class _Counting(CollectingListener):
        def on_reliability(self, event):
            super().on_reliability(event)
            if len(self.reliability) >= 2:
                got_two.set()

    sink = _Counting()
    mon = HealthMonitor(listener=sink, interval_s=0.001)
    mon.watch_queue("q", lambda: 1)
    with mon:
        assert got_two.wait(timeout=30)
        t = mon._thread
    assert t is not None and not t.is_alive()
    n = len(sink.reliability)
    mon.sample_once()
    assert len(sink.reliability) == n + 1  # only the explicit sample
    with pytest.raises(ValueError):
        HealthMonitor(interval_s=0.0)


def test_health_monitor_watch_emits_roster_series():
    with _obs_on():
        mon = HealthMonitor()
        hb = Heartbeat("test-feed")
        mon.watch_heartbeat(hb)
        hb.beat()
        mon.unwatch_heartbeat("test-feed")
        snap = ts.snapshot()
    series = {name for w in snap for name in w["series"]}
    assert {"reliability.hb.watch[test-feed]",
            "reliability.heartbeat[test-feed]",
            "reliability.hb.unwatch[test-feed]"} <= series


def test_server_flush_heartbeat_ticks_per_batch(rng):
    """The batcher's flush thread beats once a batch: a monitor watching
    it sees a fresh heartbeat after traffic, and none before."""
    from tpu_sgd_torch.models import LinearRegressionModel
    from tpu_sgd_torch.serve import Server

    model = LinearRegressionModel(rng.normal(size=4).astype(np.float32),
                                  0.0, device="cpu")
    server = Server(model, max_latency_s=0.002, device="cpu")
    hb = server.batcher.heartbeat
    assert hb.age_s() is None and hb.count == 0
    with server:
        for _ in range(3):
            server.predict(rng.normal(size=4).astype(np.float32), timeout=30)
    assert hb.count == server.batcher.batch_count >= 1
    assert hb.age_s() is not None
