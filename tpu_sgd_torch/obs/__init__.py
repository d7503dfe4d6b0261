"""tpu_sgd_torch.obs: the port's observability layer (the port of
``tpu_sgd/obs/__init__.py``).

Six pieces, one opt-in switch:

* **span tracing** (:mod:`tpu_sgd_torch.obs.spans`) -- hierarchical,
  thread-aware ``span("train.superstep")`` regions and instant
  ``event(...)`` records, emitted as ``trace_*`` JSONL records on the
  shared ``JsonLinesEventLog`` contract;
* **runtime counters** (:mod:`tpu_sgd_torch.obs.counters`) -- named
  counts and bytes, and, while enabled, hooks on the port's own funnels
  that count graph replays and kernel launches (``dispatch``), captures
  and kernel builds (``compile``), device-to-host reads (``host_sync``)
  and staged host-to-device bytes (``h2d``), tagged by the subsystem
  whose span caused them;
* **windowed time-series** (:mod:`tpu_sgd_torch.obs.timeseries`) -- a
  bounded ring of fixed-width windows over the span / counter / event
  streams; on by default whenever the layer is enabled;
* **anomaly detectors** (:mod:`tpu_sgd_torch.obs.detect`) -- declarative
  rules evaluated per window close, each trip a typed ``obs_alert``
  record on the one event stream plus an ``obs.alert.<rule>`` counter;
* **the flight recorder** (:mod:`tpu_sgd_torch.obs.flightrec`) -- a
  bounded ring of recent trace records dumped to a standalone file on
  any alert, error unwind, or explicit trigger;
* **the report pipeline** (:mod:`tpu_sgd_torch.obs.report`) --
  ``python -m tpu_sgd_torch.obs.report trace.jsonl`` renders per-stage
  breakdowns, alerts, Chrome trace-event JSON and SLO verdicts with
  CI-able exit codes; ``python -m tpu_sgd_torch.obs.watch`` tails a
  RUNNING trace live.

Quickstart::

    from tpu_sgd_torch import obs

    obs.enable("run_trace.jsonl")        # tracing + counters + windows
    obs.enable("t.jsonl", detect=True,   # + detectors + flight recorder
               flightrec="flightrec.jsonl")
    ...                                   # train / serve as usual
    obs.disable()                         # flushes windows+counters, closes log
    # then: python -m tpu_sgd_torch.obs.report run_trace.jsonl --slo slo.json
    # live: python -m tpu_sgd_torch.obs.watch run_trace.jsonl

Disabled (the default) every hook is one module-global load and a falsy
branch, and no counting hook is installed.  Enabled, the layer costs
host time only: it adds no launch, capture or host sync of its own, and
span timestamps never synchronize the card.  None of it touches a device
itself, so it behaves the same on the card and on the CPU.
"""

from __future__ import annotations

from typing import Optional

from tpu_sgd_torch.obs import counters
from tpu_sgd_torch.obs import detect
from tpu_sgd_torch.obs import flightrec
from tpu_sgd_torch.obs import spans
from tpu_sgd_torch.obs import timeseries
from tpu_sgd_torch.obs.counters import RuntimeCounters, deltas, inc, snapshot
from tpu_sgd_torch.obs.flightrec import FlightRecorder, TeeSink
from tpu_sgd_torch.obs.spans import (current_subsystem, disable_tracing,
                                     enable_tracing, event, span)
from tpu_sgd_torch.obs.timeseries import observe_scalar

__all__ = [
    "span", "event", "inc", "snapshot", "deltas", "RuntimeCounters",
    "enable", "disable", "flush_counters", "flush_windows", "is_enabled",
    "enable_tracing", "disable_tracing", "current_subsystem",
    "observe_scalar", "windows_snapshot", "detector_engine",
    "spans", "counters", "timeseries", "detect", "flightrec",
    "FlightRecorder", "TeeSink",
]

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: EMPTY on purpose -- the facade owns GIL-atomic module references only
#: (``_OWNED_LOG``/``_ENGINE``); all guarded state lives in the
#: submodules.
GRAFTLINT_LOCKS: dict = {}

_OWNED_LOG = None  # a JsonLinesEventLog this facade opened (and closes)
_ENGINE = None     # the live DetectorEngine (when detect was requested)


def enable(trace=None, *, with_counters: bool = True,
           fsync: bool = False, timeseries: bool = True,
           window_s: float = 1.0, max_windows: int = 64,
           detect: bool = False, detectors=None,
           flightrec: Optional[str] = None,
           flightrec_capacity: int = 512) -> None:
    """Turn the observability layer on.

    ``trace`` is a JSONL path (a ``JsonLinesEventLog`` is opened and
    owned -- ``disable()`` closes it) or any sink with ``emit(kind,
    payload)`` (e.g. an event log shared with training/serving records;
    the caller keeps ownership).  ``None`` enables counters only.
    ``with_counters=False`` installs no counting hook (tracing only).

    The windowed time-series ride along by default (``timeseries=True``;
    ``window_s``/``max_windows`` shape the bounded ring).
    ``detect=True`` (or an explicit ``detectors`` list) registers the
    anomaly-detector engine on window closes; ``flightrec=<path>`` arms
    the flight recorder -- the trace sink is teed through its ring, and
    every detector alert and error-closing span triggers a dump there."""
    # the boolean/path kwargs shadow the submodule names by design (the
    # caller-facing spelling is `obs.enable(log, detect=True,
    # flightrec="f.jsonl")`); alias the modules locally
    from tpu_sgd_torch.obs import detect as _detect
    from tpu_sgd_torch.obs import flightrec as _flightrec
    from tpu_sgd_torch.obs import timeseries as _timeseries

    global _OWNED_LOG, _ENGINE
    sink = owned = None
    if trace is not None:
        if hasattr(trace, "emit"):
            sink = trace
        else:
            from tpu_sgd_torch.utils.events import JsonLinesEventLog

            sink = owned = JsonLinesEventLog(str(trace), fsync=fsync)
    want_detect = detect or detectors is not None
    if want_detect and sink is None:
        import warnings

        warnings.warn(
            "obs.enable(detect=True) without a trace sink: the span/"
            "event-fed series (replica.step fanout, push staleness) "
            "never record — straggler and staleness rules cannot fire; "
            "only counter-fed rules (shed-rate, dispatch, wire) work",
            RuntimeWarning, stacklevel=2)
    store = None
    if timeseries or want_detect:  # detectors presuppose windows
        store = _timeseries.enable(width_s=window_s,
                                   max_windows=max_windows)
    rec = None
    if flightrec is not None:
        rec = _flightrec.enable(flightrec,
                                capacity=flightrec_capacity,
                                window_source=_timeseries.snapshot)
        if sink is not None:
            sink = _flightrec.TeeSink(sink, rec)
    else:
        # a re-enable that does NOT arm a flight recorder must drop a
        # previous enable's: its ring stops being fed at the sink swap,
        # so later alert dumps would overwrite the preserved incident
        # with a stale tail (no-op on a first enable)
        _flightrec.disable()

    def _on_alert(a, _rec=rec):
        if _rec is not None:
            _rec.trigger(f"alert:{a.rule}", detail=a.series)

    if want_detect and _ENGINE is None:
        _ENGINE = _detect.DetectorEngine(detectors, on_alert=_on_alert)
        store.add_close_listener(_ENGINE.on_window_close)
    elif _ENGINE is not None:
        # the engine (and its detector state) survives a re-enable, but
        # alert dumps must route to THIS enable's flight recorder (or
        # nowhere), never a closure over the previous one
        _ENGINE.on_alert = _on_alert
    if sink is not None:
        enable_tracing(sink)
        # re-enable with a NEW sink: close the log a previous enable()
        # opened (records already route to the new sink above) -- a
        # second enable must not leak the first's file handle
        prev, _OWNED_LOG = _OWNED_LOG, owned
        if prev is not None and prev is not sink:
            prev.close()
    if with_counters:
        counters.enable()


def flush_counters() -> None:
    """Write the cumulative counter snapshot as one ``metric_counters``
    record on the trace sink (no-op without both sides enabled).  The
    report pipeline diffs consecutive flushes into window deltas."""
    sink = spans._SINK
    if sink is None or not counters.is_enabled():
        return
    import time

    try:
        sink.emit("metric_counters", {"ts": time.time(),
                                      "counters": counters.snapshot()})
    except Exception:
        import logging

        logging.getLogger("tpu_sgd_torch.obs").warning(
            "trace sink raised; counter flush dropped", exc_info=True)


def flush_windows() -> None:
    """Close the open time-series window NOW so its data is visible to
    snapshots and the detectors evaluate it -- the trailing window of a
    finished phase never sees a later observation otherwise.
    ``disable()`` calls this first."""
    timeseries.flush()


def windows_snapshot(prefix: Optional[str] = None,
                     last: Optional[int] = None):
    """The live windowed time-series (``None`` when off) -- the facade
    spelling of ``timeseries.snapshot`` that ``healthz`` probes use."""
    return timeseries.snapshot(prefix=prefix, last=last)


def detector_engine():
    """The live :class:`~tpu_sgd_torch.obs.detect.DetectorEngine` (or
    ``None``): ``active_alerts()``/``trip_counts()`` scrape surface."""
    return _ENGINE


def disable() -> None:
    """Turn everything off: evaluate the trailing window, flush counters
    into the trace (if both were on), remove the counting hooks, drop the
    time-series/detector/flight-recorder hooks, close an owned trace log.
    Idempotent."""
    global _OWNED_LOG, _ENGINE
    flush_windows()  # detectors see the trailing window BEFORE teardown
    flush_counters()
    counters.disable()
    disable_tracing()
    timeseries.disable()
    flightrec.disable()
    _ENGINE = None
    owned, _OWNED_LOG = _OWNED_LOG, None
    if owned is not None:
        owned.close()


def is_enabled() -> bool:
    return (spans.is_enabled() or counters.is_enabled()
            or timeseries.is_enabled())
