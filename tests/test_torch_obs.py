"""The port's observability layer (``tpu_sgd_torch/obs``) on the CPU: the
facade, the counting hooks, the detectors, the report and the watch CLI,
held against the JAX package's ``tpu_sgd/obs`` (the reference) and its
tests (``tests/test_obs.py``, whose names the twins here keep).

Three tiers, as the rest of the port's tests:

* exact parity -- the same window sequences through both packages'
  ``DetectorEngine`` give the same alerts in the same order; both
  packages' reports give equal output and exit codes on the same trace
  files, one written by each package's ``obs.enable``;
* twins of the JAX package's cases, on the port's objects;
* structural counts -- the JAX package witnesses dispatches and syncs
  with its analysis twins (``analysis.runtime.count_dispatches``), which
  see only JAX.  The port's witness is its own structure: the block
  runner's graph replays and the kernel wrappers' launch counts
  (``cuda_kernels.kernel_launch_counts``).  On the CPU there are neither
  (the runner replays nothing, the wrappers run their plain versions), so
  ``dispatch`` is 0 there and the card checks it in ``chip_smoke.py``;
  ``host_sync`` is exercised here by treating the CPU tensors as the
  card's (``counters._card`` patched), and held equal between the
  counting hooks alone and the whole layer.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_sgd import obs as jobs
from tpu_sgd.obs import detect as jdetect
from tpu_sgd.obs import report as jreport
from tpu_sgd.obs import watch as jwatch
from tpu_sgd_torch import obs
from tpu_sgd_torch.io.prefetch import PinnedRing
from tpu_sgd_torch.obs import counters as obs_counters
from tpu_sgd_torch.obs import detect
from tpu_sgd_torch.obs import report as obs_report
from tpu_sgd_torch.obs import spans as obs_spans
from tpu_sgd_torch.obs import timeseries
from tpu_sgd_torch.obs import watch as obs_watch
from tpu_sgd_torch.obs.spans import disable_tracing, enable_tracing
from tpu_sgd_torch.ops import _build
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.utils.events import JsonLinesEventLog, SGDListener

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


class ListSink:
    """In-memory sink on the ``emit(kind, payload)`` contract."""

    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, dict(payload)))

    def spans(self, name=None):
        return [p for k, p in self.records if k == "trace_span"
                and (name is None or p["name"] == name)]


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' layers off."""
    for layer, cnt in ((obs, obs_counters), (jobs, jobs.counters)):
        layer.disable()
        cnt.reset()
    ck.reset_launch_counts()
    yield
    for layer, cnt in ((obs, obs_counters), (jobs, jobs.counters)):
        layer.disable()
        cnt.reset()
    ck.reset_launch_counts()


@pytest.fixture
def as_card(monkeypatch):
    """Count the CPU tensors' reads and copies as the card's."""
    monkeypatch.setattr(obs_counters, "_card", lambda x: True)


# -- the counting hooks -------------------------------------------------------

def test_disabled_installs_zero_runtime_patches():
    """A process that never opts in runs the stock funnels: enabling
    installs the hooks, disabling restores the originals."""
    orig_item, orig_launch = torch.Tensor.item, ck.count_launch
    obs_counters.enable()
    try:
        assert torch.Tensor.item is not orig_item
        assert ck.count_launch is not orig_launch
    finally:
        obs_counters.disable()
    assert torch.Tensor.item is orig_item
    assert ck.count_launch is orig_launch
    assert "item" not in vars(torch.Tensor)  # inherited again, not copied


def test_cpu_tensors_never_count():
    enable_tracing(ListSink())
    obs_counters.enable()
    try:
        with obs_spans.span("train.superstep"):
            t = torch.arange(4.0)
            float(t[0]), t.tolist(), t.cpu(), t.numpy(), bool(t[1])
            np.asarray(t)
        snap = obs_counters.snapshot()
    finally:
        obs_counters.disable()
        disable_tracing()
    assert snap == {}


def test_counters_attribute_runtime_events_to_the_open_subsystem(
        as_card, monkeypatch):
    """Dispatches, compiles, syncs and h2d bytes land under the span tag
    of the thread that caused them.  The funnels are the port's: a kernel
    launch (``count_launch`` with a source), a graph replay
    (``add_replayed_launches``), a capture (``captured_launches``: the
    launches inside it are not dispatches), a build (``_build._start``
    starting ``nvcc``), a read of a card tensor, a ring send."""
    builds = iter([("proc", "tmp", "out"), None])
    monkeypatch.setattr(_build, "_start", lambda name: next(builds))
    enable_tracing(ListSink())
    obs_counters.enable()
    try:
        with obs_spans.span("train.superstep"):
            ck.count_launch(source="fused_sums")
            ck.count_launch(ck.fused_gradient_sums, route="fused_sums")
            with ck.captured_launches() as record:
                ck.count_launch(source="window_sums")
                ck.count_launch(ck.fused_window_sums)
            ck.add_replayed_launches(record)
            v = float(torch.full((2,), 3.0)[0])
            assert _build._start("fused_sums") is not None
            assert _build._start("fused_sums") is None  # already built
        with obs_spans.span("ingest.produce"):
            ring = PinnedRing({"x": ((4, 4), torch.float32)}, slots=2,
                              device=CPU)
            host = ring.host[0]["x"]
            host.copy_(torch.ones(4, 4))
            ring.send(0, [(torch.empty(4, 4), host)])  # 64 bytes
            ring.send(1, [(ring.dev[1]["x"], ring.host[1]["x"])])  # none
        snap = obs_counters.snapshot()
    finally:
        obs_counters.disable()
        disable_tracing()
    assert v == 3.0
    assert snap["train.dispatch"]["n"] == 2   # the launch + the replay
    assert snap["train.compile"]["n"] == 2    # the capture + one build
    assert snap["train.host_sync"]["n"] == 1  # the float() read
    assert snap["train.host_sync"]["bytes"] == 4
    assert snap["ingest.h2d"] == {"n": 1, "bytes": 64}
    assert not any(k.startswith("untagged.") for k in snap)


@contextlib.contextmanager
def _twin(owner, name, seen):
    """A second counter over one funnel, stacked over whatever is there
    and restored on exit: the shape of the JAX package's analysis twins."""
    orig = getattr(owner, name)

    def counted(*a, **kw):
        seen[name] = seen.get(name, 0) + 1
        return orig(*a, **kw)

    setattr(owner, name, counted)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def test_counters_enable_disable_roundtrip_under_twins(as_card):
    """Hooks nest LIFO: a twin stacked over the layer's hooks sees the
    same events the layer counts, and once both unwind the originals are
    back."""
    orig = (torch.Tensor.item, ck.add_replayed_launches)
    with ck.captured_launches() as record:  # an empty graph's record
        pass
    obs_counters.enable()
    try:
        seen = {}
        with _twin(torch.Tensor, "item", seen), \
                _twin(ck, "add_replayed_launches", seen):
            torch.ones(1).item()
            ck.add_replayed_launches(record)
            ck.add_replayed_launches(record)
        snap = obs_counters.snapshot()
    finally:
        obs_counters.disable()
    assert seen == {"item": 1, "add_replayed_launches": 2}
    assert snap["untagged.host_sync"]["n"] == 1  # no span open: untagged
    assert snap["untagged.dispatch"]["n"] == 2
    assert (torch.Tensor.item, ck.add_replayed_launches) == orig


# -- the facade ---------------------------------------------------------------

def test_facade_owns_trace_log_and_flushes_counters(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    obs.enable(path)
    with obs.span("train.superstep", i0=1):
        obs.inc("train.io_callback")
    obs.flush_counters()
    obs.disable()  # flushes once more + closes the owned log
    records = JsonLinesEventLog.read(path)
    kinds = [r["kind"] for r in records]
    assert "trace_span" in kinds
    assert kinds.count("metric_counters") == 2
    last = [r for r in records if r["kind"] == "metric_counters"][-1]
    assert last["counters"]["train.io_callback"]["n"] == 1


def test_facade_shares_a_listener_event_log(tmp_path):
    """Traces interleave with listener events on ONE JSONL stream (the
    caller keeps ownership)."""
    from tpu_sgd_torch.utils.events import IterationEvent

    path = str(tmp_path / "shared.jsonl")
    log = JsonLinesEventLog(path)
    obs.enable(log, with_counters=False)
    assert obs_counters._PATCHES is None  # tracing only: no hook
    log.on_iteration(IterationEvent(1, 0.5, 0.1, 32, 0.01))
    with obs.span("train.step", i=1):
        pass
    obs.disable()  # caller-owned: must NOT close it
    log.on_iteration(IterationEvent(2, 0.4, 0.1, 32, 0.01))
    log.close()
    kinds = [r["kind"] for r in JsonLinesEventLog.read(path)]
    assert kinds == ["iteration", "trace_span", "iteration"]


def test_reenable_with_new_path_closes_previous_owned_log(tmp_path):
    """A second enable() closes the first's owned log, drops its flight
    recorder, keeps the detector engine and rebinds its alert route."""
    a = str(tmp_path / "a.jsonl")
    b = str(tmp_path / "b.jsonl")
    obs.enable(a, detect=True, flightrec=str(tmp_path / "fr.jsonl"))
    first, engine = obs._OWNED_LOG, obs.detector_engine()
    route = engine.on_alert
    with obs.span("train.step", i=1):
        pass
    obs.enable(b)  # swap without an intervening disable()
    assert first._f.closed
    assert obs.detector_engine() is engine and engine.on_alert is not route
    assert not obs.flightrec.is_enabled()
    with obs.span("train.step", i=2):
        pass
    obs.disable()
    assert obs.detector_engine() is None
    ka = [r for r in JsonLinesEventLog.read(a) if r["kind"] == "trace_span"]
    kb = [r for r in JsonLinesEventLog.read(b) if r["kind"] == "trace_span"]
    assert [r["i"] for r in ka] == [1]
    assert [r["i"] for r in kb] == [2]


# -- the driver pins: the layer adds no dispatch and no sync -----------------

def _data(rng, n=400, d=6):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(-1, 1, d).astype(np.float32)
    y = (X @ w).astype(np.float32)
    return X, y


def _opt(iters=24, k=4, c=0):
    o = (GradientDescent(device=CPU).set_num_iterations(iters)
         .set_step_size(0.1).set_mini_batch_fraction(0.5)
         .set_sampling("sliced").set_convergence_tol(0.0).set_seed(7)
         .set_superstep(k).set_listener(SGDListener()))
    if c:
        o.set_residency(c)
    return o


def _runner(o):
    """The observed driver's cached block runner."""
    return o._observed_entry[1] if o._observed_entry else None


def _counted_run(o, X, y, w0, full):
    """One run under the counting hooks alone (``full=False``: the
    witness) or under the whole layer (tracing, windows, detectors);
    returns the counters' totals by kind, the trace, the windows and the
    structural dispatch count (graph replays + eager kernel launches)."""
    sink = ListSink()
    if full:
        obs.enable(sink, detect=True, window_s=0.05)
    else:
        obs_counters.enable()
    try:
        obs_counters.reset()
        ck.reset_launch_counts()
        r0 = _runner(o)
        replays0 = r0.replays if r0 is not None else 0
        w, h = o.optimize_with_history((X, y), w0)
        snap = obs_counters.snapshot()
        obs.flush_windows()
        wins = obs.windows_snapshot()
        trips = obs.detector_engine().trip_counts() if full else None
    finally:
        obs.disable()
    r1 = _runner(o)
    replays = (r1.replays - (replays0 if r1 is r0 else 0)
               if r1 is not None else 0)
    launches = sum(ck.kernel_launch_counts().values())

    def total(kind):
        return sum(v["n"] for k, v in snap.items()
                   if k.endswith("." + kind))

    return {"dispatch": total("dispatch"), "host_sync": total("host_sync"),
            "compile": total("compile"), "snap": snap, "sink": sink,
            "wins": wins, "trips": trips, "structural": replays + launches,
            "w": w, "h": np.asarray(h)}


def test_enabled_obs_superstep_driver_zero_added_runtime_events(
        rng, as_card):
    """The warmed superstep driver (K = 4, a listener) counts the same
    dispatches and host syncs under the whole layer as under the counting
    hooks alone, compiles nothing, equals the structural witness (graph
    replays + eager launches: 0 on the CPU), and is bitwise the run with
    the layer off.  The trace observed the run: one span a superstep and
    the loss series in the windows, with no detector tripped."""
    X, y = _data(rng)
    w0 = np.zeros(6, np.float32)
    o = _opt()
    w_off, h_off = o.optimize_with_history((X, y), w0)  # warm, layer off
    base = _counted_run(o, X, y, w0, full=False)
    full = _counted_run(o, X, y, w0, full=True)
    assert full["dispatch"] == base["dispatch"] == full["structural"] == 0
    assert full["host_sync"] == base["host_sync"] > 0
    assert full["compile"] == base["compile"] == 0
    for r in (base, full):
        assert np.array_equal(r["h"], np.asarray(h_off))
        assert np.array_equal(np.asarray(r["w"]), np.asarray(w_off))
    sups = full["sink"].spans("train.superstep")
    assert len(sups) == 24 // 4
    assert all(s["i0"] % 4 == 1 for s in sups)
    series = {name for w in full["wins"] for name in w["series"]}
    assert {"train.superstep", "train.loss", "train.host_sync"} <= series
    assert full["trips"] == {}


def test_enabled_obs_resident_driver_pins_one_dispatch_windows_syncs(
        rng, as_card):
    """The resident driver (K = 4, C = 2, 64 iterations: 8 windows) under
    the whole layer: one ``train.resident_dispatch`` span, one
    ``train.window`` span and one ``train.io_callback`` a window,
    dispatches equal to the structural witness, host syncs equal to the
    counting hooks alone, no compile, and every count under the ``train``
    tag but one: the read of the history's length after the run's last
    span has closed (``untagged``, 4 bytes)."""
    X, y = _data(rng)
    w0 = np.zeros(6, np.float32)
    iters, k, c = 64, 4, 2
    o = _opt(iters=iters, k=k, c=c)
    o.optimize_with_history((X, y), w0)  # warm
    windows = iters // (k * c)
    base = _counted_run(o, X, y, w0, full=False)
    full = _counted_run(o, X, y, w0, full=True)
    assert full["dispatch"] == base["dispatch"] == full["structural"]
    assert full["host_sync"] == base["host_sync"] > 0
    assert full["compile"] == 0
    snap = full["snap"]
    assert snap["train.io_callback"]["n"] == windows
    assert {n for n in snap if not n.startswith("train.")} == {
        "untagged.host_sync"}
    assert snap["untagged.host_sync"] == {"n": 1, "bytes": 4}
    wins = full["sink"].spans("train.window")
    assert len(wins) == windows
    assert len(full["sink"].spans("train.resident_dispatch")) == 1
    assert np.array_equal(full["h"], base["h"])


# -- detectors: the twins' fixtures ------------------------------------------

def _run_detector(detector, feeds, width=1.0):
    """Drive windows through a private store+engine: ``feeds`` is one
    dict per window, series -> list of observe kwargs."""
    clock = {"t": 0.5}
    store = timeseries.WindowStore(width_s=width, clock=lambda: clock["t"])
    engine = detect.DetectorEngine([detector])
    store.add_close_listener(engine.on_window_close)
    for wi, feed in enumerate(feeds):
        clock["t"] = wi + 0.5
        for series, obs_list in feed.items():
            for kw in obs_list:
                store.observe(series, **kw)
    store.flush()
    store.close()
    return engine


def _vals(v, n=1):
    return [{"value": v}] * n


def test_detector_loss_divergence_trip_and_no_trip():
    steady = [{"train.loss": _vals(1.0, 4)}] * 3
    eng = _run_detector(detect.LossDivergenceDetector(),
                        steady + [{"train.loss": _vals(10.0, 4)}])
    assert eng.trip_counts() == {"loss-divergence": 1}
    eng = _run_detector(detect.LossDivergenceDetector(), [
        {"train.loss": _vals(1.0 / (i + 1), 4)} for i in range(6)])
    assert eng.trip_counts() == {}


def test_detector_loss_plateau_trip_and_not_in_defaults():
    flat = [{"train.loss": _vals(0.5, 4)}] * 5
    eng = _run_detector(detect.LossPlateauDetector(), flat)
    assert eng.trip_counts() == {"loss-plateau": 1}
    falling = [{"train.loss": _vals(1.0 / (i + 1), 4)} for i in range(5)]
    eng = _run_detector(detect.LossPlateauDetector(), falling)
    assert eng.trip_counts() == {}
    assert "loss-plateau" not in {d.rule for d in detect.default_detectors()}


def test_detector_staleness_creep_trip_and_no_trip():
    eng = _run_detector(detect.StalenessCreepDetector(max_staleness=8),
                        [{"replica.push.staleness": _vals(2.0, 5)}])
    assert eng.trip_counts() == {}
    eng = _run_detector(detect.StalenessCreepDetector(max_staleness=8),
                        [{"replica.push.staleness": _vals(2.0, 5)},
                         {"replica.push.staleness": _vals(12.0, 1)}])
    assert eng.trip_counts() == {"staleness-creep": 1}


def test_detector_shed_rate_trip_no_trip_and_min_offered():
    def lane_feed(admitted, shed):
        return {"serve.admitted.interactive": [{}] * admitted,
                "serve.shed.interactive": [{}] * shed}

    eng = _run_detector(detect.LaneRejectionDetector(), [lane_feed(30, 30)])
    assert eng.trip_counts() == {"shed-rate": 1}
    eng = _run_detector(detect.LaneRejectionDetector(), [lane_feed(30, 2)])
    assert eng.trip_counts() == {}
    eng = _run_detector(detect.LaneRejectionDetector(), [lane_feed(1, 2)])
    assert eng.trip_counts() == {}


def _fleet(*counts, extra=None):
    d = {f"replica.step[w{i}]": _vals(0.01, c)
         for i, c in enumerate(counts) if c}
    d.update(extra or {})
    return d


def test_detector_straggler_trip_no_trip_and_fleet_silence():
    """Cumulative over fleet PROGRESS, not wall clock."""
    active = [_fleet(5, 5, 5)]

    def run(feeds):
        return _run_detector(detect.StragglerDetector(min_fleet_steps=10),
                             feeds).trip_counts()

    assert run(active + [_fleet(5, 0, 5)]) == {"replica-straggler": 1}
    assert run(active + [_fleet(1, 0, 1)] * 5) == {"replica-straggler": 1}
    assert run(active + [_fleet(2, 0, 2), _fleet(2, 1, 2)] * 3) == {}
    # the whole fleet goes silent (round ended): a tick keeps the
    # windows closing
    tick = {"tick": [{}]}
    assert run(active + [_fleet(0, 0, 0, extra=tick)] * 6) == {}


def test_detector_straggler_membership_events_drive_the_roster():
    """A CLEAN leave removes the worker, a death-leave keeps it hunting
    until the rejoin, a joined-but-never-stepped worker is tracked."""
    run_a_end = _fleet(4, 0, 4, extra={
        "replica.leave[w0]": [{}], "replica.leave[w1]": [{}],
        "replica.leave[w2]": [{}]})
    run_b = [_fleet(0, 0, 0, extra={f"replica.join[w{i}]": [{}]
                                    for i in range(3)}),
             _fleet(4, 0, 4), _fleet(2, 1, 2)]

    def run(feeds):
        return _run_detector(detect.StragglerDetector(min_fleet_steps=10),
                             feeds).trip_counts()

    assert run([_fleet(3, 3, 3), run_a_end] + run_b) == {}
    death = [_fleet(3, 3, 3),
             _fleet(3, 0, 3, extra={"replica.leave.error[w1]": [{}]}),
             _fleet(3, 0, 3)]
    assert run(death) == {"replica-straggler": 1}
    spawn_dead = [_fleet(0, 0, extra={"replica.join[w0]": [{}],
                                      "replica.join[w1]": [{}]}),
                  _fleet(6, 0), _fleet(6, 0)]
    assert run(spawn_dead) == {"replica-straggler": 1}


def test_detector_wire_ratio_collapse_trip_exempt_and_no_trip():
    def wire(fmt, phys, logical):
        return {f"replica.wire.{fmt}": [{"nbytes": phys}],
                f"replica.wire.{fmt}.logical": [{"nbytes": logical}]}

    def run(feed):
        return _run_detector(detect.WireRatioDetector(), [feed]).trip_counts()

    assert run(wire("topk", 100_000, 105_000)) == {"wire-ratio-collapse": 1}
    assert run(wire("topk", 10_000, 500_000)) == {}
    assert run(wire("dense-f32", 100_000, 100_000)) == {}
    assert run(wire("dense-f32[s0]", 100_000, 100_000)) == {}


def test_detector_dispatch_regression_trip_no_trip_and_floor():
    steady = [{"train.dispatch": [{"n": 100}]}] * 4
    eng = _run_detector(detect.DispatchRegressionDetector(),
                        steady + [{"train.dispatch": [{"n": 400}]}])
    assert eng.trip_counts() == {"dispatch-regression": 1}
    eng = _run_detector(detect.DispatchRegressionDetector(), steady * 2)
    assert eng.trip_counts() == {}
    tiny = [{"train.dispatch": [{"n": 2}]}] * 4
    eng = _run_detector(detect.DispatchRegressionDetector(),
                        tiny + [{"train.dispatch": [{"n": 12}]}])
    assert eng.trip_counts() == {}


def test_detector_engine_transition_dedup_and_rearm():
    hot = {"replica.push.staleness": _vals(12.0, 2)}
    cool = {"replica.push.staleness": _vals(1.0, 2)}
    eng = _run_detector(detect.StalenessCreepDetector(max_staleness=8),
                        [hot, hot, hot, cool, hot])
    assert eng.trip_counts() == {"staleness-creep": 2}


def test_detector_alert_is_typed_record_counter_and_flightrec(tmp_path):
    """Through the facade: a shed spike trips the rule; the trip is a
    typed obs_alert record, an obs.alert.<rule> counter, an active alert
    and a flight-recorder dump."""
    fr = str(tmp_path / "fr.jsonl")
    sink = ListSink()
    obs.enable(sink, detect=True, window_s=0.05, flightrec=fr)
    try:
        for _ in range(30):
            obs_counters.inc("serve.admitted.interactive")
            obs_counters.inc("serve.shed.interactive")
        time.sleep(0.06)
        obs_counters.inc("serve.admitted.interactive")
        obs.flush_windows()
        alerts = [p for k, p in sink.records if k == "obs_alert"]
        assert alerts and alerts[0]["rule"] == "shed-rate"
        assert alerts[0]["series"] == "serve.lane.interactive"
        assert obs_counters.snapshot()["obs.alert.shed-rate"]["n"] >= 1
        eng = obs.detector_engine()
        assert eng.trip_counts().get("shed-rate", 0) >= 1
        recs = JsonLinesEventLog.read(fr)
        assert recs[0]["kind"] == "flightrec_meta"
        assert recs[0]["reason"].startswith("alert:shed-rate")
        assert any(r["kind"] == "obs_window" for r in recs)
    finally:
        obs.disable()
    assert obs.detector_engine() is None


def test_clean_seeded_run_trips_no_detectors(rng):
    """A fault-free seeded train + serve flow under the DEFAULT detector
    set raises zero alerts."""
    from tpu_sgd_torch.models import LinearRegressionModel
    from tpu_sgd_torch.serve import Server

    X, y = _data(rng)
    w0 = np.zeros(6, np.float32)
    o = _opt()
    o.optimize_with_history((X, y), w0)
    sink = ListSink()
    obs.enable(sink, detect=True, window_s=0.25)
    try:
        w, _ = o.optimize_with_history((X, y), w0)
        model = LinearRegressionModel(torch.as_tensor(w), 0.0)
        with Server(model, max_latency_s=0.002, device=CPU) as srv:
            futs = [srv.submit(X[i]) for i in range(64)]
            for f in futs:
                f.result(timeout=30)
        obs.flush_windows()
        assert [k for k, _ in sink.records if k == "obs_alert"] == []
        assert obs.detector_engine().trip_counts() == {}
        names = {n for w_ in obs.windows_snapshot() for n in w_["series"]}
        assert "train.loss" in names
        assert any(n.startswith("serve.") for n in names)
    finally:
        obs.disable()


def test_replica_driver_windows_snapshot(rng):
    from tpu_sgd_torch.replica import ReplicaDriver

    X, y = _data(rng, n=64)
    w0 = np.zeros(6, np.float32)
    sink = ListSink()
    obs.enable(sink, window_s=0.05)
    try:
        drv = (ReplicaDriver(device=CPU).set_num_iterations(8)
               .set_step_size(0.1).set_mini_batch_fraction(1.0)
               .set_convergence_tol(0.0).set_seed(3).set_workers(2)
               .set_staleness(0))
        drv.optimize_with_history((X, y), w0)
        wins = drv.last_windows_snapshot
    finally:
        obs.disable()
    assert wins, "no replica windows recorded"
    names = {n for w in wins for n in w["series"]}
    assert any(n.startswith("replica.step[") for n in names)
    assert "replica.push.staleness" in names
    assert drv.windows() is None


# -- detectors: seeded parity with the JAX package ---------------------------

WORKERS = ("w0", "w1", "w2", "w3")
LANES = ("interactive", "batch")
BEATS = ("feed", "batcher")


def _feeds(seed, n_windows):
    """Random per-window observations over every series the rules read,
    membership events and failover windows included; each window's
    ``tick`` keeps it closing when nothing else lands."""
    rng = np.random.default_rng(seed)
    loss = float(rng.uniform(1, 5))
    flat = 0  # windows left on a plateau
    silent = {w: 0 for w in WORKERS}
    feeds = []
    for i in range(n_windows):
        f = {"tick": [{}]}
        if not flat and rng.random() < 0.1:
            flat = int(rng.integers(3, 7))
        if flat:
            flat -= 1
            f["train.loss"] = [{"value": loss}] * 2
        elif rng.random() < 0.8:
            loss *= float(rng.uniform(0.7, 1.05))
            spike = 12.0 if rng.random() < 0.1 else 1.0
            f["train.loss"] = [{"value": loss * spike * float(v)}
                               for v in rng.uniform(0.9, 1.1,
                                                    rng.integers(1, 5))]
            if rng.random() < 0.02:
                f["train.loss"].append({"value": float("nan")})
        if rng.random() < 0.5:
            f["replica.push.staleness"] = [
                {"value": float(v)} for v in rng.integers(0, 11, 3)]
        for lane in LANES:
            if rng.random() < 0.4:
                for kind, hi in (("admitted", 40), ("shed", 30),
                                 ("rejected", 8), ("displaced", 8)):
                    f[f"serve.{kind}.{lane}"] = [{}] * int(
                        rng.integers(0, hi))
        for w in WORKERS:
            if silent[w]:
                silent[w] -= 1
                continue
            if rng.random() < 0.08:
                silent[w] = int(rng.integers(1, 6))
                continue
            f[f"replica.step[{w}]"] = [{"value": 0.01}] * int(
                rng.integers(1, 6))
        for kind in ("join", "rejoin", "leave", "leave.error"):
            if rng.random() < 0.06:
                f[f"replica.{kind}[{rng.choice(WORKERS)}]"] = [{}]
        if rng.random() < 0.1:
            f["replica.failover"] = [{}]
        if rng.random() < 0.4:
            fmt = str(rng.choice(["topk", "topk[s0]", "dense-f32", "bf16"]))
            phys = int(rng.integers(1_000, 100_000))
            ratio = float(rng.choice([0.9, 1.05, 4.0, 50.0]))
            f[f"replica.wire.{fmt}"] = [{"nbytes": phys}]
            if rng.random() < 0.9:
                f[f"replica.wire.{fmt}.logical"] = [
                    {"nbytes": int(phys * ratio)}]
        if rng.random() < 0.8:
            n = 100 * (4 if rng.random() < 0.1 else 1)
            if rng.random() < 0.1:
                n = 3
            f["train.dispatch"] = [{"n": int(n + rng.integers(0, 20))}]
        if rng.random() < 0.1:
            f["integrity.corrupt.io.chunk"] = [{}] * int(rng.integers(1, 3))
        if i == 0 or rng.random() < 0.05:
            for b in BEATS:
                f[f"reliability.hb.watch[{b}]"] = [{}]
        if rng.random() < 0.04:
            f[f"reliability.hb.unwatch[{rng.choice(BEATS)}]"] = [{}]
        for b in BEATS:
            if rng.random() < (0.3 if b == "batcher" else 0.9):
                f[f"reliability.heartbeat[{b}]"] = [{"value": 1.0}] * int(
                    rng.integers(1, 4))
        if rng.random() < 0.5:
            busy = int(rng.integers(4, 30))
            for s in range(3):
                f[f"replica.shard.push[s{s}]"] = [{}] * int(
                    rng.integers(0, busy + 1))
        if rng.random() < 0.5:
            admits = int(rng.integers(0, 40))
            f["tenant.admit"] = [{}] * admits
            f["tenant.evict"] = [{}] * int(rng.integers(0, admits + 1))
        feeds.append(f)
    return feeds


def _windows(feeds):
    """The feeds through the port's WindowStore on a synthetic clock: the
    closed windows, in the time series' own layout."""
    clock = {"t": 0.5}
    store = timeseries.WindowStore(width_s=1.0, clock=lambda: clock["t"])
    out = []
    store.add_close_listener(out.append)
    for wi, feed in enumerate(feeds):
        clock["t"] = wi + 0.5
        for series, obs_list in feed.items():
            for kw in obs_list:
                store.observe(series, **kw)
    store.flush()
    store.close()
    return out


def _opt_in(mod):
    return mod.default_detectors() + [
        mod.LossPlateauDetector(), mod.ShardImbalanceDetector(),
        mod.SlabThrashDetector()]


def _alerts(mod, detectors, windows):
    got = []
    eng = mod.DetectorEngine(detectors, on_alert=got.append)
    for w in windows:
        eng.on_window_close(w)
    return [(a.rule, a.series, a.window_index, a.value, a.bound, a.detail)
            for a in got], eng.trip_counts()


def _same(a, b):
    """Alert tuples equal, a NaN value equal to a NaN value."""
    return len(a) == len(b) and all(
        x[:3] == y[:3] and x[4:] == y[4:]
        and (x[3] == y[3] or (x[3] != x[3] and y[3] != y[3]))
        for x, y in zip(a, b))


PARITY_SEEDS = range(16)


@pytest.mark.parametrize("rules", ["default", "opt_in"])
@pytest.mark.parametrize("seed", PARITY_SEEDS)
def test_detectors_match_the_jax_package_on_seeded_windows(seed, rules):
    """2-40 seeded windows over every series the rules read, through both
    packages' engines: the same alerts in the same order (rule, series,
    window index, value, bound, message) and the same trip counts."""
    n = 2 + seed * 38 // (len(PARITY_SEEDS) - 1)
    windows = _windows(_feeds(seed, n))
    assert 2 <= len(windows) <= 40
    pick = detect.default_detectors if rules == "default" else \
        lambda: _opt_in(detect)
    jpick = jdetect.default_detectors if rules == "default" else \
        lambda: _opt_in(jdetect)
    got, got_trips = _alerts(detect, pick(), windows)
    want, want_trips = _alerts(jdetect, jpick(), windows)
    assert _same(got, want), (got, want)
    assert got_trips == want_trips


def test_seeded_windows_trip_every_rule():
    """The parity cases are not vacuous: across the seeds every one of
    the 12 rules trips at least once."""
    rules = set()
    for seed in PARITY_SEEDS:
        n = 2 + seed * 38 // (len(PARITY_SEEDS) - 1)
        _, trips = _alerts(detect, _opt_in(detect),
                           _windows(_feeds(seed, n)))
        rules |= set(trips)
    assert rules == {d.rule for d in _opt_in(detect)}
    assert len(rules) == 12


def test_port_detectors_have_the_jax_packages_names_and_defaults():
    assert detect.__all__ == jdetect.__all__
    for name in jdetect.__all__:
        cls, jcls = getattr(detect, name), getattr(jdetect, name)
        if isinstance(jcls, type) and issubclass(jcls, jdetect.Detector) \
                and jcls is not jdetect.Detector:
            assert cls.rule == jcls.rule
            assert vars(cls()) == vars(jcls())
    assert [d.rule for d in detect.default_detectors()] == \
        [d.rule for d in jdetect.default_detectors()]
    assert detect.GRAFTLINT_LOCKS == jdetect.GRAFTLINT_LOCKS


# -- report: twins of the JAX package's cases ---------------------------------

def _mk_trace(tmp_path, name="t.jsonl"):
    """A small synthetic trace with spans, counters, a checkpoint save, a
    reload and an alert."""
    path = str(tmp_path / name)
    log = JsonLinesEventLog(path)
    log.emit("metric_counters", {"ts": 1.0, "counters": {
        "train.dispatch": {"n": 10, "bytes": 0},
        "serve.reject": {"n": 1, "bytes": 0}}})
    for i, dur in enumerate([0.010, 0.012, 0.011, 0.200]):
        log.emit("trace_span", {
            "name": "serve.batch", "ts": 10.0 + i, "t0_s": 1.0 + i,
            "dur_s": dur, "span_id": i + 1, "parent_id": 0,
            "thread": "flush", "error": None, "batch": 4})
    log.emit("trace_span", {
        "name": "checkpoint.save", "ts": 100.0, "t0_s": 50.0,
        "dur_s": 0.05, "span_id": 90, "parent_id": 0,
        "thread": "MainThread", "error": None, "iteration": 40})
    log.emit("trace_event", {
        "name": "reliability.retry", "ts": 101.0, "t0_s": 51.0,
        "thread": "MainThread", "subsystem": "ingest", "attempt": 1})
    log.emit("serve_reload", {"ts": 130.0, "event": "reloaded",
                              "version": 40, "previous_version": None})
    log.emit("obs_alert", {
        "ts": 131.0, "rule": "shed-rate", "series": "serve.lane.batch",
        "value": 0.6, "bound": 0.3, "window_index": 131,
        "t_start": 131.0, "t_end": 132.0, "detail": "test alert"})
    log.emit("metric_counters", {"ts": 200.0, "counters": {
        "train.dispatch": {"n": 25, "bytes": 0},
        "serve.reject": {"n": 1, "bytes": 0}}})
    log.close()
    return path


def test_report_span_stats_counters_and_staleness(tmp_path):
    records = obs_report.load_trace(_mk_trace(tmp_path))
    sb = obs_report.span_stats(records)["serve.batch"]
    assert sb["count"] == 4
    assert sb["p50_s"] == 0.011
    assert sb["p99_s"] == 0.200
    assert sb["max_s"] == 0.200
    assert obs_report.counter_deltas(records) == {
        "train.dispatch": {"n": 15, "bytes": 0}}
    stale, = obs_report.staleness_samples(records)
    assert stale == {"version": 40, "staleness_s": 30.0}


def test_report_chrome_trace_export(tmp_path):
    doc = obs_report.to_chrome_trace(
        obs_report.load_trace(_mk_trace(tmp_path)))
    evs = doc["traceEvents"]
    complete = [e for e in evs if e["ph"] == "X"]
    instants = [e for e in evs if e["ph"] == "i"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert len(complete) == 5 and len(instants) == 1
    assert {m["args"]["name"] for m in metas} == {"flush", "MainThread"}
    sb = [e for e in complete if e["name"] == "serve.batch"][0]
    assert sb["ts"] == pytest.approx(1.0 * 1e6)
    assert sb["dur"] == pytest.approx(0.010 * 1e6)
    assert sb["args"]["batch"] == 4
    assert json.dumps(doc)


def test_slo_evaluation_pass_fail_and_malformed(tmp_path):
    records = obs_report.load_trace(_mk_trace(tmp_path))
    verdicts = obs_report.evaluate_slos(records, {"slos": [
        {"name": "p50", "metric": "span_p50_s", "span": "serve.batch",
         "max": 0.05},
        {"name": "p99", "metric": "span_p99_s", "span": "serve.batch",
         "max": 0.05},
        {"name": "no-drops", "metric": "counter", "counter": "serve.reject",
         "max": 0},
        {"name": "fresh", "metric": "staleness_s", "max": 60.0},
        {"name": "absent-count", "metric": "span_count",
         "span": "never.fired", "max": 0},
        {"name": "absent-latency", "metric": "span_p99_s",
         "span": "never.fired", "max": 1.0},
    ]})
    by = {v["name"]: v for v in verdicts}
    assert by["p50"]["ok"] and not by["p99"]["ok"]
    assert by["no-drops"]["ok"]
    assert by["fresh"]["ok"] and by["fresh"]["value"] == 30.0
    assert by["absent-count"]["ok"]
    assert not by["absent-latency"]["ok"]
    for bad in ({"name": "typo", "metric": "span_p42_s", "span": "x",
                 "max": 1},
                {"name": "no-bound", "metric": "staleness_s"}):
        with pytest.raises(ValueError):
            obs_report.evaluate_slos(records, {"slos": [bad]})


def test_report_cli_exit_codes_and_chrome_file(tmp_path, capsys):
    trace = _mk_trace(tmp_path)
    slo_ok = tmp_path / "ok.json"
    slo_ok.write_text(json.dumps({"slos": [
        {"name": "p50", "metric": "span_p50_s", "span": "serve.batch",
         "max": 0.05}]}))
    slo_bad = tmp_path / "bad.json"
    slo_bad.write_text(json.dumps({"slos": [
        {"name": "p99", "metric": "span_p99_s", "span": "serve.batch",
         "max": 0.05}]}))
    chrome = str(tmp_path / "chrome.json")
    assert obs_report.main([trace, "--slo", str(slo_ok),
                            "--chrome", chrome]) == 0
    out = capsys.readouterr().out
    assert "SLO PASS: p50" in out and "per-stage breakdown" in out
    with open(chrome) as f:
        assert len(json.load(f)["traceEvents"]) > 0
    assert obs_report.main([trace, "--slo", str(slo_bad)]) == 1
    assert "SLO FAIL: p99" in capsys.readouterr().out
    assert obs_report.main([str(tmp_path / "missing.jsonl")]) == 2
    assert obs_report.main(
        [trace, "--chrome", str(tmp_path / "no_dir" / "t.json")]) == 2
    assert "cannot write Chrome trace" in capsys.readouterr().err
    garbage = tmp_path / "garbage.json"
    garbage.write_text("{not json")
    assert obs_report.main([trace, "--slo", str(garbage)]) == 2
    assert obs_report.main([trace, "--json", "--slo", str(slo_ok)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["spans"]["serve.batch"]["count"] == 4
    assert doc["slos"][0]["ok"] is True


def test_chaos_soak_default_slos_are_well_formed(both_traces):
    """The JAX package's chaos-soak SLO document (read here by the test;
    the port imports no script) evaluates without error in the port's
    report, verdict for verdict the JAX package's: on an empty trace the
    structural min-bounds fail, never error or pass vacuously, and on
    each package's own trace the two reports agree."""
    from scripts.chaos_soak import DEFAULT_SLOS

    verdicts = obs_report.evaluate_slos([], DEFAULT_SLOS)
    assert verdicts == jreport.evaluate_slos([], DEFAULT_SLOS)
    assert len(verdicts) == len(DEFAULT_SLOS["slos"])
    by = {v["name"]: v for v in verdicts}
    assert not by["train-windows-fired"]["ok"]
    assert not by["callback-windows-counted"]["ok"]
    for path in both_traces.values():
        recs = obs_report.load_trace(path)
        assert obs_report.evaluate_slos(recs, DEFAULT_SLOS) == \
            jreport.evaluate_slos(recs, DEFAULT_SLOS)


def test_report_tolerates_crash_torn_tail(tmp_path):
    trace = _mk_trace(tmp_path)
    with open(trace, "a") as f:
        f.write('{"kind": "trace_span", "name": "torn')
    records = obs_report.load_trace(trace)
    assert len(obs_report.span_stats(records)["serve.batch"]) > 0
    with open(trace, "a") as f:
        f.write('ed"}\n{"interior": garbage}\n{"kind": "x"}\n')
    with pytest.raises(json.JSONDecodeError):
        obs_report.load_trace(trace)


def test_report_windowed_stats_alerts_and_staleness_buckets(tmp_path):
    records = obs_report.load_trace(_mk_trace(tmp_path))
    by_idx = {w["index"]: w for w in obs_report.windowed_stats(records, 1.0)}
    for i in range(10, 14):
        assert by_idx[i]["spans"]["serve.batch"]["count"] == 1
    assert by_idx[131]["alerts"][0]["rule"] == "shed-rate"
    assert by_idx[130]["staleness"] == [
        {"version": 40, "staleness_s": 30.0}]
    txt = obs_report.render_windows(list(by_idx.values()))
    assert "window 10" in txt and "ALERT [shed-rate]" in txt
    stats = obs_report.alert_stats(records)
    assert stats["count"] == 1 and stats["by_rule"] == {"shed-rate": 1}
    weird = records + [{"kind": "obs_alert", "ts": 132.0,
                        "rule": "custom", "series": "x"}]
    assert "value=?" in obs_report.render_report(weird)
    assert "value=?" in obs_report.render_windows(
        obs_report.windowed_stats(weird, 1.0))


def test_report_window_slo_metrics_absent_is_violation(tmp_path):
    records = obs_report.load_trace(_mk_trace(tmp_path))
    by = {v["name"]: v for v in obs_report.evaluate_slos(records, {"slos": [
        {"name": "w-p99-bad", "metric": "window_span_p99_s",
         "span": "serve.batch", "window_s": 1.0, "max": 0.05},
        {"name": "w-p99-ok", "metric": "window_span_p99_s",
         "span": "serve.batch", "window_s": 1.0, "max": 0.5},
        {"name": "w-absent", "metric": "window_span_p99_s",
         "span": "never.fired", "window_s": 1.0, "max": 10.0},
        {"name": "w-gap", "metric": "window_span_count_min",
         "span": "serve.batch", "window_s": 1.0, "min": 1},
        {"name": "alerts-any", "metric": "alert_count", "max": 0},
        {"name": "alerts-rule", "metric": "alert_count",
         "rule": "shed-rate", "min": 1},
        {"name": "alerts-other", "metric": "alert_count",
         "rule": "replica-straggler", "max": 0},
    ]})}
    assert not by["w-p99-bad"]["ok"] and by["w-p99-bad"]["value"] == 0.200
    assert by["w-p99-ok"]["ok"]
    assert not by["w-absent"]["ok"] and by["w-absent"]["value"] is None
    assert not by["w-gap"]["ok"] and by["w-gap"]["value"] == 0
    assert not by["alerts-any"]["ok"]
    assert by["alerts-rule"]["ok"]
    assert by["alerts-other"]["ok"]
    with pytest.raises(ValueError):
        obs_report.evaluate_slos(records, {"slos": [
            {"name": "no-width", "metric": "window_span_p99_s",
             "span": "serve.batch", "max": 1.0}]})


def test_report_cli_window_flag_and_json(tmp_path, capsys):
    trace = _mk_trace(tmp_path)
    assert obs_report.main([trace, "--window", "1.0"]) == 0
    out = capsys.readouterr().out
    assert "time-bucketed tables" in out and "window 10" in out
    assert "alerts (1 typed obs_alert trips)" in out
    assert obs_report.main([trace, "--window", "1.0", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["alerts"]["by_rule"] == {"shed-rate": 1}
    assert any(w["index"] == 131 for w in doc["windows"])


# -- report: parity on each package's own traces ------------------------------

def _jax_trace(path, rng):
    """A trace written by the JAX package's ``obs.enable`` around its
    observed SGD driver, with a shed spike that trips a detector."""
    from tpu_sgd.optimize.gradient_descent import GradientDescent as JGD
    from tpu_sgd.utils.events import SGDListener as JListener

    X, y = _data(rng)
    o = (JGD().set_num_iterations(24).set_step_size(0.1)
         .set_mini_batch_fraction(0.5).set_sampling("sliced")
         .set_convergence_tol(0.0).set_seed(7).set_superstep(4)
         .set_listener(JListener()))
    jobs.enable(path, detect=True, window_s=0.05)
    try:
        o.optimize_with_history((X, y), np.zeros(6, np.float32))
        _shed_spike(jobs.counters)
    finally:
        jobs.disable()
    return path


def _port_trace(path, rng):
    X, y = _data(rng)
    obs.enable(path, detect=True, window_s=0.05)
    try:
        _opt().optimize_with_history((X, y), np.zeros(6, np.float32))
        _shed_spike(obs_counters)
    finally:
        obs.disable()
    return path


def _shed_spike(cnt):
    time.sleep(0.06)
    for _ in range(30):
        cnt.inc("serve.admitted.interactive")
        cnt.inc("serve.shed.interactive")
    time.sleep(0.06)
    cnt.inc("serve.admitted.interactive")


SLO_DOC = {"slos": [
    {"name": "superstep-p99", "metric": "span_p99_s",
     "span": "train.superstep", "max": 60.0},
    {"name": "supersteps", "metric": "span_count",
     "span": "train.superstep", "min": 6},
    {"name": "shed", "metric": "lane_shed_fraction", "lane": "interactive",
     "max": 0.9},
    {"name": "alerts", "metric": "alert_count", "rule": "shed-rate",
     "min": 1},
    {"name": "no-straggler", "metric": "alert_count",
     "rule": "replica-straggler", "max": 0},
    {"name": "window-count", "metric": "window_span_count_min",
     "span": "train.superstep", "window_s": 10.0, "min": 1},
    {"name": "tight", "metric": "span_max_s", "span": "train.superstep",
     "max": 0.0},
]}


@pytest.fixture(scope="module")
def both_traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    rng = np.random.default_rng(5)
    for layer in (obs, jobs):
        layer.disable()
    try:
        return {"jax": _jax_trace(str(d / "jax.jsonl"), rng),
                "port": _port_trace(str(d / "port.jsonl"), rng)}
    finally:
        for layer, cnt in ((obs, obs_counters), (jobs, jobs.counters)):
            layer.disable()
            cnt.reset()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_report_matches_the_jax_package_on_both_traces(both_traces, which):
    """Both packages' report functions on one trace: equal records,
    render, windows, SLO verdicts and Chrome export.  Each trace carries
    the shed-rate trip of its own package's detectors."""
    path = both_traces[which]
    recs, jrecs = obs_report.load_trace(path), jreport.load_trace(path)
    assert recs == jrecs
    assert obs_report.alert_stats(recs)["by_rule"].get("shed-rate", 0) >= 1
    assert len([r for r in recs if r.get("kind") == "trace_span"
                and r["name"] == "train.superstep"]) == 6
    assert obs_report.render_report(recs) == jreport.render_report(recs)
    wins = obs_report.windowed_stats(recs, 0.05)
    assert wins == jreport.windowed_stats(recs, 0.05)
    assert obs_report.render_windows(wins) == jreport.render_windows(wins)
    verdicts = obs_report.evaluate_slos(recs, SLO_DOC)
    assert verdicts == jreport.evaluate_slos(recs, SLO_DOC)
    assert [v["ok"] for v in verdicts] == [True] * 6 + [False]
    assert obs_report.to_chrome_trace(recs) == jreport.to_chrome_trace(recs)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_report_cli_exit_codes_and_json_match_the_jax_package(
        both_traces, which, tmp_path, capsys):
    """``main`` gives the JAX package's exit codes (0 pass, 1 violation, 2
    malformed) and the same JSON; the port's runs as ``python -m``."""
    path = both_traces[which]
    ok, bad, garbage = (tmp_path / n for n in ("ok.json", "bad.json",
                                               "garbage.json"))
    ok.write_text(json.dumps({"slos": SLO_DOC["slos"][:6]}))
    bad.write_text(json.dumps(SLO_DOC))
    garbage.write_text("{not json")
    for doc, code in ((ok, 0), (bad, 1), (garbage, 2)):
        args = [path, "--window", "0.05", "--slo", str(doc), "--json"]
        assert obs_report.main(args) == code
        got = capsys.readouterr().out
        assert jreport.main(args) == code
        assert got == capsys.readouterr().out
    cli = subprocess.run(
        [sys.executable, "-m", "tpu_sgd_torch.obs.report", path, "--window",
         "0.05", "--slo", str(bad), "--json"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=300)
    assert cli.returncode == 1, cli.stderr
    assert jreport.main([path, "--window", "0.05", "--slo", str(bad),
                         "--json"]) == 1
    assert json.loads(cli.stdout) == json.loads(capsys.readouterr().out)


def _own_names(mod):
    """The public functions and classes a module defines itself."""
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and getattr(v, "__module__", None) == mod.__name__}


def test_report_and_watch_have_the_jax_packages_names():
    assert _own_names(obs_report) == _own_names(jreport)
    assert _own_names(obs_watch) == _own_names(jwatch)
    assert obs.__all__ == jobs.__all__ + ["FlightRecorder", "TeeSink"]


# -- the watch CLI -------------------------------------------------------------

def test_watch_once_renders_windows_and_alerts(tmp_path, capsys):
    trace = _mk_trace(tmp_path)
    with open(trace, "a") as f:
        f.write('{"kind": "torn_mid')
    args = [trace, "--once", "--window", "1.0", "--active-s", "1000"]
    assert obs_watch.main(args) == 0
    out = capsys.readouterr().out
    assert "window 10" in out
    assert "ACTIVE ALERTS" in out and "shed-rate" in out
    assert "parse_errors" not in out
    assert jwatch.main(args) == 0
    assert capsys.readouterr().out == out  # the JAX package's render
    assert obs_watch.main([str(tmp_path / "missing.jsonl"), "--once"]) == 2


def test_watch_tail_is_incremental_and_tolerant(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        f.write('{"kind": "trace_event", "name": "a", "ts": 1.0}\n')
        f.write('{"kind": "trace_')
    tail = obs_watch.TraceTail(path)
    assert [r["name"] for r in tail.poll()] == ["a"]
    with open(path, "a") as f:
        f.write('event", "name": "b", "ts": 2.0}\n')
        f.write('garbage line\n')
        f.write('{"kind": "trace_event", "name": "c", "ts": 3.0}\n')
    assert [r["name"] for r in tail.poll()] == ["b", "c"]
    assert tail.parse_errors == 1
    assert tail.poll() == []
    tail.close()


def test_watch_state_matches_the_jax_package_on_a_live_trace(
        both_traces):
    """The watcher's state and screen over the port's own trace, polled
    in two halves as a live tail would: equal to the JAX package's."""
    path = both_traces["port"]
    screens = []
    for mod in (obs_watch, jwatch):
        tail = mod.TraceTail(path)
        state = mod.WatchState()
        recs = tail.poll()
        state.feed(recs[:len(recs) // 2])
        state.feed(recs[len(recs) // 2:])
        screens.append(mod.render(state, tail, 0.05, last=4, active_s=1e9))
        tail.close()
    assert screens[0] == screens[1]
    assert "shed-rate" in screens[0]


# -- a wedged feed, end to end ------------------------------------------------

def test_a_wedged_prefetch_feed_trips_the_heartbeat_stall_detector():
    """The Prefetcher's heartbeat under the whole layer: a watched feed
    that stops beating while its peer beats on trips ``heartbeat-stall``
    (the rule's windows driven by a synthetic clock)."""
    from tpu_sgd_torch.io import Prefetcher
    from tpu_sgd_torch.reliability.health import HealthMonitor, Heartbeat

    clock = {"t": 0.5}
    store = timeseries.WindowStore(width_s=1.0, clock=lambda: clock["t"])
    engine = detect.DetectorEngine(
        [detect.HeartbeatStallDetector(stall_windows=2)])
    store.add_close_listener(engine.on_window_close)
    timeseries.enable(width_s=1.0)  # the heartbeats' series, no tracing:
    timeseries._STORE = store       # every record on the synthetic clock
    try:
        mon = HealthMonitor()
        feed, peer = Heartbeat("feed"), Heartbeat("peer")
        mon.watch_heartbeat(feed)
        mon.watch_heartbeat(peer)
        for t in range(6):
            clock["t"] = t + 0.5
            if t < 2:  # the feed produces, then wedges
                list(Prefetcher(lambda i: i, range(3), depth=2,
                                heartbeat=feed))
            peer.beat()
        clock["t"] = 7.5
        peer.beat()
        store.flush()
    finally:
        timeseries.disable()
    assert feed.count == 6
    assert engine.trip_counts() == {"heartbeat-stall": 1}
    alert, = engine.active_alerts()
    assert alert.series == "reliability.heartbeat[feed]"
