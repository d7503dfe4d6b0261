"""The port's observability planes (``tpu_sgd_torch/utils/events.py``,
``obs/spans.py``, ``obs/counters.py``): the twins of ``tests/test_events.py``
— JSONL event log round trip, listener dispatch, ``StepTimer`` — plus span
tracing, the counter registry and the ``torch.profiler`` capture.  Event
records are checked exactly against the JAX package's writer on the same
events."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from tpu_sgd.utils import events as jev
from tpu_sgd_torch.obs import counters, spans
from tpu_sgd_torch.utils.events import (
    CollectingListener,
    IterationEvent,
    JsonLinesEventLog,
    ReliabilityEvent,
    RunEvent,
    ServeBatchEvent,
    ServeReloadEvent,
    StepTimer,
    profile_trace,
)


def _iteration(i=1):
    return IterationEvent(
        iteration=i, loss=0.5 / i, weight_delta_norm=0.1,
        mini_batch_size=128, wall_time_s=0.002,
    )


def _write_all(mod, path):
    """The same events through one package's log."""
    cfg = dataclasses.make_dataclass("Cfg", [("step_size", float)])(0.5)
    log = mod.JsonLinesEventLog(path)
    log.on_run_start(cfg)
    for i in (1, 2):
        log.on_iteration(mod.IterationEvent(
            iteration=i, loss=0.5 / i, weight_delta_norm=0.1,
            mini_batch_size=128, wall_time_s=0.002))
    log.on_run_end(mod.RunEvent(event="run_completed", num_iterations=2,
                                final_loss=0.25, wall_time_s=0.01))
    log.on_serve_batch(mod.ServeBatchEvent(
        queue_depth=3, batch_size=8, padded_size=8,
        latency_s=0.004, reject_count=0, model_version=7,
    ))
    log.on_serve_reload(mod.ServeReloadEvent(
        event="reloaded", version=7, previous_version=6,
    ))
    log.on_reliability(mod.ReliabilityEvent(kind="retry", source="t",
                                            value=2.0))
    log.close()
    return [json.loads(line) for line in open(path)]


def test_jsonl_event_log_round_trip(tmp_path):
    events = _write_all(__import__("tpu_sgd_torch.utils.events",
                                   fromlist=["x"]),
                        str(tmp_path / "events.jsonl"))
    kinds = [e["kind"] for e in events]
    assert kinds == ["run_started", "iteration", "iteration",
                     "run_completed", "serve_batch", "serve_reload",
                     "reliability_retry"]
    assert all("ts" in e for e in events)
    assert events[0]["config"] == {"step_size": 0.5}
    assert events[1]["iteration"] == 1 and events[1]["loss"] == 0.5
    assert events[3]["final_loss"] == 0.25
    assert events[4]["batch_size"] == 8 and events[4]["model_version"] == 7
    assert events[5]["event"] == "reloaded"
    assert events[5]["previous_version"] == 6
    assert events[6]["source"] == "t" and events[6]["value"] == 2.0


def test_jsonl_records_match_the_jax_writer(tmp_path):
    """The two packages write the same records (timestamps aside), so one
    replay tool reads both."""
    ours = _write_all(__import__("tpu_sgd_torch.utils.events",
                                 fromlist=["x"]), str(tmp_path / "t.jsonl"))
    theirs = _write_all(jev, str(tmp_path / "j.jsonl"))
    for rec in ours + theirs:
        rec.pop("ts")
    assert ours == theirs


def test_jsonl_event_log_appends(tmp_path):
    path = str(tmp_path / "events.jsonl")
    for i in range(2):
        log = JsonLinesEventLog(path)
        log.on_iteration(_iteration(i + 1))
        log.close()
    events = [json.loads(line) for line in open(path)]
    assert [e["iteration"] for e in events] == [1, 2]


def test_event_log_written_by_either_package_reads_in_the_other(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    log = jev.JsonLinesEventLog(path)
    log.on_iteration(jev.IterationEvent(3, 0.25, 0.1, 64, 0.01))
    log.close()
    log = JsonLinesEventLog(path)
    log.on_iteration(_iteration(4))
    log.close()
    ours, theirs = JsonLinesEventLog.read(path), jev.JsonLinesEventLog.read(
        path)
    assert ours == theirs
    assert [e["iteration"] for e in ours] == [3, 4]


def test_collecting_listener_buffers_all_event_families():
    listener = CollectingListener()
    listener.on_run_start(None)
    listener.on_iteration(_iteration())
    listener.on_run_end(RunEvent(event="run_completed", num_iterations=1))
    listener.on_serve_batch(ServeBatchEvent(
        queue_depth=0, batch_size=1, padded_size=1,
        latency_s=0.001, reject_count=0, model_version=-1,
    ))
    listener.on_serve_reload(ServeReloadEvent(event="load_failed",
                                              version=3, error="torn"))
    listener.on_reliability(ReliabilityEvent(kind="heartbeat",
                                             source="t"))
    assert len(listener.iterations) == 1
    assert [r.event for r in listener.runs] == ["run_started",
                                                "run_completed"]
    assert listener.serve_batches[0].batch_size == 1
    assert listener.serve_reloads[0].error == "torn"
    assert listener.reliability[0].kind == "heartbeat"


def test_event_dataclasses_match_the_jax_package():
    for name in ("IterationEvent", "RunEvent", "ServeBatchEvent",
                 "ServeReloadEvent", "ReliabilityEvent"):
        ours = [(f.name, f.default) for f in dataclasses.fields(
            getattr(__import__("tpu_sgd_torch.utils.events",
                               fromlist=["x"]), name))]
        theirs = [(f.name, f.default) for f in dataclasses.fields(
            getattr(jev, name))]
        assert ours == theirs, name


def test_step_timer_timed_call_records():
    timer = StepTimer()
    out = timer.timed_call(lambda a: torch.as_tensor(a) * 2.0,
                           np.ones(4, np.float32))
    np.testing.assert_array_equal(out.numpy(), np.full(4, 2.0, np.float32))
    assert len(timer.times) == 1 and timer.times[0] > 0
    assert timer.mean_s == pytest.approx(timer.times[0])


def test_step_timer_walks_nested_outputs():
    """Nested tuples, lists and dicts of tensors pass through the wait
    untouched (on the CPU there is nothing to wait for)."""
    timer = StepTimer()
    out = timer.timed_call(lambda: {"a": (torch.ones(2), [torch.zeros(1)]),
                                    "b": 3})
    assert out["b"] == 3 and len(timer.times) == 1


def test_step_timer_records_failed_calls():
    timer = StepTimer()

    def boom():
        time.sleep(0.01)
        raise ValueError("exploded")

    with pytest.raises(ValueError):
        timer.timed_call(boom)
    with pytest.raises(ValueError):
        with timer.time():
            boom()
    # both failures still spent wall clock; dropping them would skew mean_s
    assert len(timer.times) == 2
    assert all(t >= 0.01 for t in timer.times)


def test_step_timer_context_manager_measures_block():
    timer = StepTimer()
    with timer.time():
        time.sleep(0.005)
    with timer.time():
        time.sleep(0.005)
    assert len(timer.times) == 2
    assert timer.mean_s >= 0.005
    assert StepTimer().mean_s == 0.0  # empty timer: no ZeroDivisionError


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(64) @ torch.ones(64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)


class _Sink:
    def __init__(self):
        self.records = []

    def emit(self, kind, payload):
        self.records.append((kind, payload))


def test_spans_nest_and_emit_through_the_sink():
    sink = _Sink()
    spans.enable_tracing(sink)
    try:
        with spans.span("train.run", n=2):
            assert spans.current_subsystem() == "train"
            with spans.span("checkpoint.save", iteration=3) as sp:
                sp.set(extra=1)
            spans.event("reliability.retry", attempt=1)
    finally:
        spans.disable_tracing()
    assert spans.current_subsystem() == "untagged"
    kinds = [(k, p["name"]) for k, p in sink.records]
    assert kinds == [("trace_span", "checkpoint.save"),
                     ("trace_event", "reliability.retry"),
                     ("trace_span", "train.run")]
    inner, ev, outer = (p for _, p in sink.records)
    assert inner["parent_id"] == outer["span_id"] and outer["parent_id"] == 0
    assert inner["iteration"] == 3 and inner["extra"] == 1
    assert ev["subsystem"] == "train" and ev["attempt"] == 1


def test_disabled_spans_are_a_shared_noop():
    assert not spans.is_enabled()
    a, b = spans.span("x"), spans.span("y", k=1)
    assert a is b
    with a as s:
        assert s.set(z=2) is s
    spans.event("x")  # nothing to emit to, nothing raised


def test_span_profile_dir_writes_a_trace(tmp_path):
    spans.enable_tracing(_Sink())
    try:
        with spans.span("train.run", profile_dir=str(tmp_path / "p")):
            torch.ones(8).sum()
    finally:
        spans.disable_tracing()
    assert len(os.listdir(tmp_path / "p")) == 1


def test_counters_registry_counts_only_when_enabled():
    counters.reset()
    counters.inc("train.io_callback")
    assert counters.snapshot() == {}
    counters.enable()
    try:
        with counters.deltas() as d:
            counters.inc("train.io_callback")
            counters.inc("train.io_callback", nbytes=10)
        assert d.get() == {"train.io_callback": {"n": 2, "bytes": 10}}
    finally:
        counters.disable()
        counters.reset()
    assert counters.snapshot() == {}


def test_counters_forward_failure_is_dropped():
    reg = counters.RuntimeCounters()

    def boom(*a):
        raise RuntimeError("no")

    reg.forward = boom
    reg.inc("a", 2)
    assert reg.snapshot() == {"a": {"n": 2, "bytes": 0}}
