"""The flight recorder: a bounded ring of recent trace records dumped
whole on trouble (the port of ``tpu_sgd/obs/flightrec.py``; pure host
code).

A production trace can run to millions of records; the forensics that
matter are the LAST few hundred — what the system was doing when the
alert tripped, the SLO broke, or the error unwound.  The flight
recorder keeps exactly that: a bounded in-memory ring of every record
the observability layer emits (spans, instant events, counter flushes,
alerts — it tees the trace sink, so the ring is byte-for-byte the
trace's tail), and on any **trigger** writes a standalone
``flightrec.jsonl``:

* record 0: a ``flightrec_meta`` header — trigger reason, timestamp,
  dump ordinal, ring size;
* the ring, oldest first, each record's original ``kind`` preserved;
* one ``obs_window`` record per live time-series window snapshot
  (``tpu_sgd_torch.obs.timeseries``) — the windowed tables a
  post-mortem renders without replaying the full trace.

Triggers: every detector alert transition (wired by the
``tpu_sgd_torch.obs.enable`` facade), every span that closes with an
error (the tee sees ``error`` on the ``trace_span`` record), and
explicit :func:`trigger` calls (the replica rollback fires one).
``obs.enable(trace, flightrec=path)`` installs one and tees the trace
sink through it; by hand, :func:`enable` it and route the sink through a
:class:`TeeSink` (``obs.spans.enable_tracing(TeeSink(sink, rec))``).  Each dump REPLACES the file via an
atomic rename — the newest incident wins, and a reader never sees a
half-written dump.

Cost: ring appends are O(1) deque ops under one lock; a dump is file
IO on the triggering thread (errors and alert transitions are rare by
definition — steady state pays only the append).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

__all__ = ["FlightRecorder", "enable", "disable", "is_enabled",
           "trigger", "TeeSink"]

logger = logging.getLogger("tpu_sgd_torch.obs")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the ring is appended by every emitting thread and drained by dumps;
#: the dump counter rides the same lock.  ``_REC`` is a GIL-atomic module
#: reference (the ``obs.spans`` ``_SINK`` pattern).
GRAFTLINT_LOCKS = {
    "FlightRecorder": {
        "_ring": "_lock",
        "_dumps": "_lock",
        # the rate-limit clock: an undeclared read-modify-write lets
        # two concurrent triggers both pass the min-interval check and
        # dump twice
        "_last_dump_t": "_lock",
    },
}

_REC: Optional["FlightRecorder"] = None


class FlightRecorder:
    """See module docstring."""

    def __init__(self, path: str, capacity: int = 512,
                 window_source: Optional[Callable[[], Optional[list]]]
                 = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = str(path)
        self.capacity = int(capacity)
        self.window_source = window_source
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._dumps = 0
        self._last_dump_t = float("-inf")

    def record(self, kind: str, payload: dict) -> None:
        with self._lock:
            self._ring.append((kind, dict(payload)))

    def trigger(self, reason: str, detail: str = "",
                min_interval_s: Optional[float] = None) -> Optional[str]:
        """Dump the ring + live window snapshots to ``self.path``
        (atomic rename; the newest dump wins).  Returns the path, or
        ``None`` when the dump failed OR was rate-limited (logged,
        never raised — the recorder must not kill the path that
        triggered it).

        ``min_interval_s`` debounces ROUTINE trigger classes: under
        fault injection, error-closing spans are a per-retry
        occurrence, and serializing the whole ring on the stressed
        thread for each — then overwriting the incident that mattered
        — would make the recorder worse than useless.  Alert
        transitions and explicit triggers pass ``None`` and always
        dump; a skipped dump still leaves its records in the ring for
        the next one."""
        with self._lock:
            now = time.monotonic()
            if (min_interval_s is not None
                    and now - self._last_dump_t < min_interval_s):
                return None
            self._last_dump_t = now
            records = list(self._ring)
            self._dumps += 1
            ordinal = self._dumps
        windows = None
        if self.window_source is not None:
            try:
                windows = self.window_source()
            except Exception:
                logger.warning("flight recorder window source raised",
                               exc_info=True)
        tmp = f"{self.path}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "kind": "flightrec_meta", "ts": time.time(),
                    "reason": reason, "detail": detail,
                    "dump_ordinal": ordinal, "records": len(records),
                    "windows": len(windows) if windows else 0,
                }, default=float) + "\n")
                for kind, payload in records:
                    f.write(json.dumps({"kind": kind, **payload},
                                       default=float) + "\n")
                for w in windows or ():
                    f.write(json.dumps({"kind": "obs_window", **w},
                                       default=float) + "\n")
            os.replace(tmp, self.path)
        except OSError:
            logger.warning("flight recorder dump to %r failed",
                           self.path, exc_info=True)
            return None
        return self.path

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps


class TeeSink:
    """Wraps a trace sink: every record passes through to the inner
    sink AND lands in the flight recorder's ring; a span record closing
    with an ``error`` triggers a dump (the error-unwind forensics
    contract), DEBOUNCED to one per ``error_dump_interval_s`` — under
    fault injection error spans are routine, and a per-retry full-ring
    dump on the stressed thread (each overwriting the last incident)
    would defeat the recorder.  The ring append happens FIRST so a
    dump includes the record that triggered it, and skipped dumps'
    records survive in the ring for the next trigger."""

    def __init__(self, inner, recorder: FlightRecorder,
                 error_dump_interval_s: float = 5.0):
        self.inner = inner
        self.recorder = recorder
        self.error_dump_interval_s = float(error_dump_interval_s)

    def emit(self, kind: str, payload: dict) -> None:
        self.recorder.record(kind, payload)
        if kind == "trace_span" and payload.get("error"):
            self.recorder.trigger(
                f"span-error:{payload.get('name', '?')}",
                detail=str(payload["error"]),
                min_interval_s=self.error_dump_interval_s)
        self.inner.emit(kind, payload)


def enable(path: str, capacity: int = 512,
           window_source=None) -> FlightRecorder:
    """Install THE live flight recorder.  Tee the trace sink into it
    (:class:`TeeSink`) for the ring to fill; :func:`trigger` dumps it."""
    global _REC
    rec = FlightRecorder(path, capacity=capacity,
                         window_source=window_source)
    _REC = rec
    return rec


def disable() -> None:
    global _REC
    _REC = None


def is_enabled() -> bool:
    return _REC is not None


def trigger(reason: str, detail: str = "") -> Optional[str]:
    """Explicit trigger against the live recorder (the harness hook for
    invariant/SLO-gate failures); no-op returning ``None`` when off."""
    rec = _REC
    if rec is None:
        return None
    return rec.trigger(reason, detail=detail)
