"""Hierarchical span tracing: the port of ``tpu_sgd/obs/spans.py``.

A **span** is a named region with a monotonic start and duration, a
thread-local parent (so nested regions form a tree) and host-scalar
attributes, emitted as one ``trace_span`` record through the event-log
contract (``tpu_sgd_torch.utils.events.JsonLinesEventLog``)::

    from tpu_sgd_torch.obs.spans import span, event

    with span("train.superstep", i0=i0, steps=steps):
        ...                       # graph replay + host replay
    event("reliability.retry", attempt=2, error="FaultInjected")

Cost contract: DISABLED, the state a process runs in unless an operator
opts in, is ONE module-global load and a falsy branch; ``span(...)``
returns a shared no-op singleton, allocates nothing and formats nothing.
Enabling (:func:`enable_tracing`) routes records to a sink; a raising
sink drops the record and never kills the observed hot path.

Each thread keeps its own span stack.  The current span's first dotted
segment (``train.superstep`` -> ``train``) is published as the thread's
*subsystem tag* (:func:`current_subsystem`).

Timestamps time the HOST region only: a span never synchronizes the card
to "include device time", which would turn every traced loop back into
lockstep.  Span durations attribute where host wall clock went.

A ``torch.profiler`` capture rides the span API: ``span("train.run",
profile_dir=<dir>)`` brackets the region with a profiler and writes its
Chrome trace into ``<dir>`` on exit.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time

__all__ = ["span", "event", "enable_tracing", "disable_tracing",
           "is_enabled", "current_subsystem"]

logger = logging.getLogger("tpu_sgd_torch_torch.obs")

#: lock-discipline declaration (the JAX package's analyzer reads these): EMPTY on
#: purpose, and load-bearing as documentation.  All mutable tracing
#: state is either thread-local (the per-thread span stack and
#: subsystem tag in ``_TL``) or a GIL-atomic single reference
#: (``_SINK``, swapped whole by enable/disable; ``_IDS`` is an atomic
#: ``itertools.count``).  Record serialization is the SINK's problem —
#: ``JsonLinesEventLog`` already lock-serializes its writes.  Adding
#: shared mutable state to this module means adding a lock AND
#: declaring it here.
GRAFTLINT_LOCKS: dict = {}

#: fast-path gate: ``span()``/``event()`` read this ONE module global
#: and return when falsy — the entire disabled-mode cost (the
#: failpoints discipline)
_ENABLED = False

_SINK = None                  # object with .emit(kind, payload)
_IDS = itertools.count(1)     # process-wide span ids (atomic under GIL)
_TL = threading.local()       # .stack: list of _Span; .tag: str

#: the windowed time-series hooks (installed by ``obs/timeseries.py``'s
#: ``enable``): ``_ON_SPAN(name, dur_s, ts, attrs, error)`` fires on every
#: span close, ``_ON_EVENT(name, ts, attrs)`` on every instant event —
#: both GIL-atomic single references swapped whole like ``_SINK``, both
#: pure host work (the zero-added-runtime-events pin holds with the
#: time-series ON), and a raising hook is dropped, never propagated.
_ON_SPAN = None
_ON_EVENT = None


def _stack():
    st = getattr(_TL, "stack", None)
    if st is None:
        st = _TL.stack = []
    return st


def current_subsystem() -> str:
    """The accounting tag of the innermost open span on THIS thread
    (its first dotted name segment), or ``"untagged"`` — how
    ``obs.counters`` attributes patch-counted dispatches/syncs to the
    subsystem whose region caused them."""
    return getattr(_TL, "tag", "untagged")


class _NoopSpan:
    """The disabled-mode singleton: every ``span(...)`` call returns
    THIS object, so the disabled hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "ts", "t0",
                 "_profile_dir", "_profiler")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self._profile_dir = attrs.pop("profile_dir", None)
        self.attrs = attrs
        self.span_id = next(_IDS)
        self.parent_id = 0
        self.ts = 0.0
        self.t0 = 0.0

    def set(self, **attrs):
        """Attach host-scalar attributes after entry (e.g. a batch size
        known only mid-region).  NEVER pass device values: formatting
        one forces a device->host sync)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = _stack()
        self.parent_id = st[-1].span_id if st else 0
        st.append(self)
        _TL.tag = self.name.split(".", 1)[0]
        # epoch ts for cross-record joins (staleness SLOs), monotonic
        # t0 for durations and the Chrome trace timeline
        self.ts = time.time()
        if self._profile_dir is not None:
            try:
                from tpu_sgd_torch.utils.events import profile_trace

                self._profiler = profile_trace(self._profile_dir)
                self._profiler.__enter__()
            except Exception:
                logger.warning("torch.profiler failed to start; span "
                               "continues untraced", exc_info=True)
                self._profile_dir = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        # duration FIRST: the profiler stop below is not part of the
        # traced region's cost
        dur = time.perf_counter() - self.t0
        if self._profile_dir is not None:
            try:
                self._profiler.__exit__(None, None, None)
            except Exception:
                logger.warning("torch.profiler failed to stop",
                               exc_info=True)
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _TL.tag = st[-1].name.split(".", 1)[0] if st else "untagged"
        sink = _SINK
        if sink is not None:
            payload = {
                "name": self.name,
                "ts": self.ts,
                "t0_s": self.t0,
                "dur_s": dur,
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "thread": threading.current_thread().name,
                "error": (exc_type.__name__
                          if exc_type is not None else None),
            }
            payload.update(self.attrs)
            try:
                sink.emit("trace_span", payload)
            except Exception:  # observability must never kill hot paths
                logger.warning("trace sink raised; span record dropped",
                               exc_info=True)
        hook = _ON_SPAN
        if hook is not None:
            try:
                hook(self.name, dur, self.ts, self.attrs,
                     exc_type.__name__ if exc_type is not None else None)
            except Exception:
                logger.warning("time-series span hook raised; dropped",
                               exc_info=True)
        return False


def span(name: str, **attrs):
    """Open a trace span.  No-op singleton when tracing is disabled
    (one global load + branch); otherwise a context manager that emits
    one ``trace_span`` record on exit.

    ``attrs`` must be HOST scalars/strings — a device value here forces
    a sync when the record serializes.
    ``profile_dir=<dir>`` additionally brackets the region with
    a ``torch.profiler`` capture whose Chrome trace lands in that
    directory."""
    if not _ENABLED:
        return _NOOP
    return _Span(name, attrs)


def event(name: str, **attrs) -> None:
    """Emit one instant ``trace_event`` record (a point, not a region):
    retry attempts, breaker transitions, failpoint triggers, reload
    decisions.  Same cost/discipline contract as :func:`span`."""
    if not _ENABLED:
        return
    sink = _SINK
    if sink is None:
        return
    payload = {
        "name": name,
        "ts": time.time(),
        "t0_s": time.perf_counter(),
        "thread": threading.current_thread().name,
        "subsystem": current_subsystem(),
    }
    payload.update(attrs)
    try:
        sink.emit("trace_event", payload)
    except Exception:
        logger.warning("trace sink raised; event record dropped",
                       exc_info=True)
    hook = _ON_EVENT
    if hook is not None:
        try:
            hook(name, payload["ts"], attrs)
        except Exception:
            logger.warning("time-series event hook raised; dropped",
                           exc_info=True)


def enable_tracing(sink) -> None:
    """Route spans/events to ``sink`` (anything with ``emit(kind,
    payload)`` — a ``JsonLinesEventLog``) and open the gate."""
    global _SINK, _ENABLED
    _SINK = sink
    _ENABLED = True


def disable_tracing() -> None:
    """Close the gate and drop the sink reference (the caller owns the
    sink's lifecycle — a ``JsonLinesEventLog`` still needs ``close()``)."""
    global _SINK, _ENABLED
    _ENABLED = False
    _SINK = None


def is_enabled() -> bool:
    return _ENABLED
