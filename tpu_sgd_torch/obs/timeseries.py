"""Windowed time-series: the live half of the port's observability
(the port of ``tpu_sgd/obs/timeseries.py``).

Spans and counters (``obs/spans.py``, ``obs/counters.py``) make a run
legible after the fact; this module reads it *while it runs*: a **bounded
ring of fixed-width time windows** fed by the hooks those modules keep --

* **span closes** (``obs.spans``): every closed span lands its duration
  in the window as a value sample of the series named after the span
  (``serve.batch``, ``tenant.batch``), with a declared fan-out for
  per-actor series (:data:`SPAN_FANOUT`);
* **counter incs** (``obs.counters``): every explicit ``inc`` site lands
  its count and bytes under the counter's own name
  (``serve.shed.interactive``, ``tenant.evict``);
* **instant events** (``obs.spans.event``): counted per window, with a
  declared value extraction (:data:`EVENT_VALUES`: a ``tenant.predict``
  event's ``staleness_s`` becomes the ``tenant.predict.staleness_s``
  value series) and per-actor fan-out (:data:`EVENT_FANOUT`);
* **observed-loop scalars** (:func:`observe_scalar`): the per-step loss
  and weight-delta norm that the observed SGD drivers already hold as
  host floats become the ``train.loss`` / ``train.weight_delta`` series,
  with no added device sync.

Each window keeps per-series ``count`` / ``sum`` / ``max`` / ``bytes``
exactly, plus a BOUNDED sample buffer for p50/p99 (nearest-rank, through
the one shared rule ``serve.metrics.nearest_rank``).  Memory is bounded by
construction: ``max_windows`` closed windows in a ring plus one open
window, ``samples_per_series`` samples per series per window (beyond the
cap, count/sum/max stay exact and the percentile is over the first-cap
samples, flagged by ``samples_capped``).  Run length never grows the
store.

Cost contract: every hook is pure host work (dict updates under one lock,
no torch call, no device touch).  Disabled, each hook is one module-global
load and a falsy branch.

Window closes fire listeners on a DEDICATED daemon thread, never on the
observing thread: the observation that rolls a window may be a counter
inc fired while its caller holds a hot-path lock (the serve batcher's
``_cond`` during an admission decision).  The observer only enqueues the
closed window; :func:`flush` closes the open window AND waits for the
dispatch queue to drain.  A raising listener is dropped, never kills
anything.  The detectors (``obs/detect.py``) listen here, registered by
the ``obs.enable`` facade; the window dicts have the JAX package's
layout, so either package's detectors read them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["WindowStore", "enable", "disable", "is_enabled", "snapshot",
           "flush", "observe_scalar", "SPAN_FANOUT", "EVENT_VALUES"]

logger = logging.getLogger("tpu_sgd_torch.obs")

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the window ring and the open window are mutated by every observing
#: thread (training loop, prefetch worker, serving flush thread, the
#: counter forward) — all rolls/updates hold the lock.  Close listeners
#: fire OUTSIDE the lock on a popped window.  The module-level
#: ``_STORE``/``_ENABLED`` are GIL-atomic single references (the
#: ``obs.spans`` ``_SINK`` pattern).
GRAFTLINT_LOCKS = {
    "WindowStore": {
        "_windows": "_lock",
        "_current": "_lock",
        "_floor_index": "_lock",
        "_listeners": "_lock",
        # the close-dispatch queue rides its own condition: the worker
        # thread and every observing thread meet there, and it must
        # never nest inside ``_lock`` (enqueues happen after the roll
        # releases it)
        "_pending": "_dispatch_cv",
        "_dispatch_busy": "_dispatch_cv",
        "_dispatch_stop": "_dispatch_cv",
        # lazily spawned by add_close_listener(), snapshotted by
        # close(), both under the cv (an unlocked close-side read would
        # race the first-listener spawn)
        "_dispatch_thread": "_dispatch_cv",
    },
}

#: span names fanned out into per-actor sub-series by an attribute:
#: ``replica.step`` spans carry ``worker=``, so each replica worker gets
#: its own ``replica.step[w0]`` series, the per-worker progress signal
SPAN_FANOUT: Dict[str, str] = {
    "replica.step": "worker",
}

#: instant-event value extraction: ``{event name: ((attr, only_if),
#: ...)}`` — the named attr becomes the ``<event>.<attr>`` value
#: series, gated on a truthy ``only_if`` attr when given.
EVENT_VALUES: Dict[str, tuple] = {
    # an accepted push's staleness is the store's live version gap
    # (rejected pushes are left out: their gap was refused, not served)
    "replica.push": (("staleness", "accepted"),),
    # each tenant touched by a predict batch reports how stale its slab
    # row is — the per-tenant freshness feed (tenant.predict.
    # staleness_s value series; tenant/engine.py emits it)
    "tenant.predict": (("staleness_s", None),),
}

#: instant events fanned into per-actor count series by an attribute
#: (the event twin of :data:`SPAN_FANOUT`).  Convention: an event
#: carrying a truthy ``error`` attr lands in the ``<name>.error[actor]``
#: twin instead.
EVENT_FANOUT: Dict[str, str] = {
    # replica membership transitions (replica/membership.py), fanned by
    # worker: ``replica.join[w0]`` / ``replica.rejoin[w0]`` /
    # ``replica.leave[w0]`` (a death-leave lands in the ``.error`` twin)
    "replica.join": "worker",
    "replica.rejoin": "worker",
    "replica.leave": "worker",
    # a store failover, fanned by the promoted store
    "replica.failover": "new_primary",
    # the sharded store (replica/shard.py): one event per touched shard
    # per push, ``replica.shard.push[s0]``
    "replica.shard.push": "shard",
    # the tenant slab's residency transitions (tenant/store.py),
    # fanned by tenant id: ``tenant.admit[7]`` / ``tenant.evict[7]`` /
    # ``tenant.swap[7]`` count series are the per-tenant surface, and
    # the unfanned totals are what a slab-thrash rule reads;
    # ``tenant.predict`` fans each batch's touched tenants into
    # per-tenant serve-rate series next to them
    "tenant.admit": "tenant",
    "tenant.evict": "tenant",
    "tenant.swap": "tenant",
    "tenant.predict": "tenant",
}

#: fast-path gate (the failpoints discipline): every hook reads this
#: ONE module global and returns when falsy.
_ENABLED = False

_STORE: Optional["WindowStore"] = None


class _SeriesAgg:
    """One series' aggregate inside one window.  ``n``/``total``/
    ``vmax``/``nbytes`` are exact however many observations arrive;
    ``samples`` is bounded by the store's per-series cap (percentiles
    degrade to first-cap honesty, never memory growth)."""

    __slots__ = ("n", "total", "vmax", "nbytes", "samples", "capped")

    def __init__(self):
        self.n = 0
        self.total = 0.0
        self.vmax = None
        self.nbytes = 0
        self.samples: List[float] = []
        self.capped = False


class _Window:
    __slots__ = ("index", "t_start", "t_end", "series")

    def __init__(self, index: int, width_s: float):
        self.index = index
        self.t_start = index * width_s
        self.t_end = (index + 1) * width_s
        self.series: Dict[str, _SeriesAgg] = {}


def _percentile(xs: List[float], p: float) -> float:
    # lazy import: serve.metrics is leaf-light but importing it at
    # module top would drag serve/__init__.py (batcher, engine) into
    # every obs import
    from tpu_sgd_torch.serve.metrics import nearest_rank

    return nearest_rank(sorted(xs), p)


def _series_snapshot(agg: _SeriesAgg) -> dict:
    out = {
        "count": agg.n,
        "sum": agg.total,
        "max": agg.vmax,
        "mean": (agg.total / agg.n) if agg.n else 0.0,
        "bytes": agg.nbytes,
    }
    if agg.samples:
        out["p50"] = _percentile(agg.samples, 50)
        out["p99"] = _percentile(agg.samples, 99)
    if agg.capped:
        out["samples_capped"] = True
    return out


class WindowStore:
    """See module docstring.  ``clock`` is injectable (tests drive a
    synthetic long run through thousands of windows without sleeping);
    observations may also carry their own ``ts`` (a replay of a
    trace's record timestamps goes through the same windowing)."""

    def __init__(self, width_s: float = 1.0, max_windows: int = 64,
                 samples_per_series: int = 256,
                 clock: Callable[[], float] = time.time):
        if width_s <= 0:
            raise ValueError(f"width_s must be > 0, got {width_s}")
        if max_windows < 1:
            raise ValueError(f"max_windows must be >= 1, got {max_windows}")
        self.width_s = float(width_s)
        self.max_windows = int(max_windows)
        self.samples_per_series = int(samples_per_series)
        self._clock = clock
        self._lock = threading.Lock()
        # the ring: CLOSED windows only, bounded by construction; the
        # open window lives in _current until a later observation (or
        # flush) rolls past its edge
        self._windows: deque = deque(maxlen=self.max_windows)
        self._current: Optional[_Window] = None
        self._floor_index = 0  # flush() bumps it: no duplicate indices
        self._listeners: List[Callable[[dict], None]] = []
        # close-dispatch machinery (started lazily by the first
        # add_close_listener; plain time-series users never pay for it)
        self._dispatch_cv = threading.Condition()
        self._pending: deque = deque(maxlen=4 * self.max_windows)
        self._dispatch_busy = False
        self._dispatch_stop = False
        self._dispatch_thread: Optional[threading.Thread] = None

    # -- feeding -----------------------------------------------------------
    def observe(self, series: str, value: Optional[float] = None,
                n: int = 1, nbytes: int = 0,
                ts: Optional[float] = None) -> None:
        """The one entry point: count ``n`` (and ``nbytes``) into the
        window containing ``ts`` (default: now), and when ``value`` is
        given, fold it into sum/max and the bounded sample buffer.
        A ``ts`` older than the open window folds into the open window
        (late cross-thread records never reopen closed windows)."""
        if ts is None:
            ts = self._clock()
        idx = int(ts // self.width_s)
        with self._lock:
            if idx < self._floor_index:
                # a mid-run flush() already closed this index: the
                # remainder of the wall-clock window lands in the next
                # one rather than duplicating a ring index
                idx = self._floor_index
            cur = self._current
            if cur is None:
                cur = self._current = _Window(idx, self.width_s)
            elif idx > cur.index:
                self._windows.append(cur)
                # enqueue INSIDE the rolling critical section: rolls
                # are serialized by _lock, so the dispatch queue sees
                # closed windows in index order (enqueuing after the
                # release let a preempted thread's window N arrive
                # after another thread's N+1, feeding detectors
                # history out of order)
                self._enqueue_close_locked(cur)
                cur = self._current = _Window(idx, self.width_s)
            agg = cur.series.get(series)
            if agg is None:
                agg = cur.series[series] = _SeriesAgg()
            agg.n += n
            agg.nbytes += nbytes
            if value is not None:
                v = float(value)
                agg.total += v
                if agg.vmax is None or v > agg.vmax:
                    agg.vmax = v
                if len(agg.samples) < self.samples_per_series:
                    agg.samples.append(v)
                else:
                    agg.capped = True

    def flush(self, drain_timeout_s: float = 10.0) -> None:
        """Close the open window NOW and WAIT for the close-dispatch
        queue to drain (detectors have evaluated every closed window
        when this returns — the harnesses flush then read trip counts).
        The trailing window of a finished run never sees a later
        observation, so detectors would otherwise never evaluate it —
        ``obs.disable`` calls this before tearing anything down."""
        with self._lock:
            closed, self._current = self._current, None
            if closed is not None:
                self._windows.append(closed)
                self._floor_index = closed.index + 1
                self._enqueue_close_locked(closed)
        if not self.drain(timeout_s=drain_timeout_s):
            logger.warning(
                "window-close dispatch did not drain within %.1fs — a "
                "listener is wedged; detector verdicts for the "
                "undispatched windows are MISSING, not clean",
                drain_timeout_s)

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Block until every enqueued window close has been dispatched
        (False on timeout — a wedged listener must not hang teardown
        forever)."""
        deadline = time.monotonic() + timeout_s
        with self._dispatch_cv:
            while self._pending or self._dispatch_busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._dispatch_cv.wait(timeout=remaining)
        return True

    def close(self) -> None:
        """Stop the close-dispatch thread (module ``disable()`` calls
        this).  Pending windows are dropped; flush first if they
        matter."""
        with self._dispatch_cv:
            self._dispatch_stop = True
            self._dispatch_cv.notify_all()
            # snapshot under the cv — add_close_listener() lazily
            # spawns the thread under it, and an unlocked read here
            # races that spawn; the join stays OUTSIDE the cv
            # (joining under the cv the dispatch loop's
            # finally-block needs would deadlock the close)
            t = self._dispatch_thread
        if t is not None:
            t.join(timeout=5.0)

    # -- consuming ---------------------------------------------------------
    def add_close_listener(self, fn: Callable[[dict], None]) -> None:
        """``fn(window_snapshot)`` fires on every window close, on the
        store's dedicated dispatch thread — NEVER on the observing
        thread, whose caller may hold a hot-path lock (the serve
        batcher's admission path incs counters under its condition; a
        detector sweep + flight dump inline there would stall every
        lane at the exact overloaded moment the rules trip).  A raising
        listener is logged and dropped."""
        with self._lock:
            self._listeners.append(fn)
        with self._dispatch_cv:
            if self._dispatch_thread is None:
                self._dispatch_thread = threading.Thread(
                    target=self._dispatch_loop, name="obs-window-close",
                    daemon=True)
                self._dispatch_thread.start()

    def _dispatch_loop(self) -> None:
        while True:
            with self._dispatch_cv:
                while not self._pending and not self._dispatch_stop:
                    self._dispatch_cv.wait()
                if self._dispatch_stop:
                    self._dispatch_cv.notify_all()
                    return
                w = self._pending.popleft()
                self._dispatch_busy = True
            try:
                snap = self.window_snapshot(w, True)
                with self._lock:
                    listeners = list(self._listeners)
                for fn in listeners:
                    try:
                        fn(snap)
                    except Exception:
                        logger.warning(
                            "window-close listener raised; dropped",
                            exc_info=True)
            finally:
                with self._dispatch_cv:
                    self._dispatch_busy = False
                    self._dispatch_cv.notify_all()

    def window_snapshot(self, w: "_Window", closed: bool,
                        prefix: Optional[str] = None) -> Optional[dict]:
        """One window as a plain dict, or ``None`` when the ``prefix``
        filter leaves no series (filtering happens BEFORE the
        percentile sorts — a ``healthz`` scrape of the serve series
        must not pay for every replica fanout series it throws away)."""
        names = [n for n in w.series
                 if prefix is None or n.startswith(prefix)]
        if prefix is not None and not names:
            return None
        return {
            "index": w.index,
            "t_start": w.t_start,
            "t_end": w.t_end,
            "closed": closed,
            "series": {n: _series_snapshot(w.series[n]) for n in names},
        }

    def snapshot(self, prefix: Optional[str] = None,
                 last: Optional[int] = None) -> List[dict]:
        """The ring as plain dicts (closed windows oldest-first, then
        the open window) — the ``healthz``/watch surface.  ``prefix``
        filters series names; ``last`` keeps only the newest N
        windows.  Windows left empty by the filter are dropped.

        The OPEN window's aggregates are snapshotted UNDER the lock
        (already prefix-filtered, so the held time is small): observer
        threads mutate its series dict concurrently, and an unlocked
        iteration would race them (dict-changed-size crashes out of a
        healthz scrape).  Closed windows are immutable and snapshotted
        outside, newest-first, stopping at ``last`` non-empty ones —
        never paying percentile sorts for windows the caller drops."""
        with self._lock:
            closed_wins = list(self._windows)
            open_snap = (None if self._current is None
                         else self.window_snapshot(self._current, False,
                                                   prefix))
        want = None if last is None else int(last)
        out = [] if open_snap is None else [open_snap]
        for w in reversed(closed_wins):
            if want is not None and len(out) >= want:
                break
            snap = self.window_snapshot(w, True, prefix)
            if snap is not None:
                out.append(snap)
        out.reverse()
        if want is not None:
            out = out[-want:]
        return out

    def _enqueue_close_locked(self, w: "_Window") -> None:
        """Enqueue a closed window for the dispatch thread — O(1),
        called with ``_lock`` HELD (the lock ordering is always
        ``_lock`` -> ``_dispatch_cv``; the dispatch thread takes them
        one at a time, never nested, so no inversion).  Snapshotting
        and listener calls happen on the worker; a closed window is
        immutable, so handing the raw object over is safe.  No
        listeners registered = nothing enqueued."""
        if not self._listeners:
            return
        with self._dispatch_cv:
            if len(self._pending) == self._pending.maxlen:
                # a wedged listener backed the queue up to its bound:
                # the eviction must be LOUD — an unevaluated window is
                # a missing verdict, not a clean one
                logger.warning(
                    "window-close queue full (%d); dropping the oldest "
                    "pending window undispatched", len(self._pending))
            self._pending.append(w)
            self._dispatch_cv.notify_all()


# -- the module-level live store + hook plumbing -----------------------------

def observe_scalar(series: str, value: float) -> None:
    """Hot-path hook for HOST scalars the observed loops already hold
    (the per-step loss / weight-delta the drivers already fetched).
    NEVER pass a device tensor: ``float()`` on one forces a device->host
    sync at the record site.
    Disabled cost: one module-global load + falsy branch."""
    if not _ENABLED:
        return
    st = _STORE
    if st is not None:
        st.observe(series, value=value)


def _on_span_close(name, dur_s, ts, attrs, error) -> None:
    st = _STORE
    if st is None:
        return
    st.observe(name, value=dur_s, ts=ts)
    if error:
        st.observe(name + ".error", ts=ts)
    key = SPAN_FANOUT.get(name)
    if key is not None:
        actor = attrs.get(key)
        if actor is not None:
            st.observe(f"{name}[{actor}]", value=dur_s, ts=ts)


def _on_event(name, ts, attrs) -> None:
    st = _STORE
    if st is None:
        return
    st.observe(name, ts=ts)
    for attr, only_if in EVENT_VALUES.get(name, ()):
        if only_if is not None and not attrs.get(only_if):
            continue
        v = attrs.get(attr)
        if v is not None:
            st.observe(f"{name}.{attr}", value=float(v), ts=ts)
    key = EVENT_FANOUT.get(name)
    if key is not None:
        actor = attrs.get(key)
        if actor is not None:
            fan = name + (".error" if attrs.get("error") else "")
            st.observe(f"{fan}[{actor}]", ts=ts)


def _forward_count(name, n, nbytes) -> None:
    st = _STORE
    if st is not None:
        st.observe(name, n=n, nbytes=nbytes)


def enable(width_s: float = 1.0, max_windows: int = 64,
           samples_per_series: int = 256) -> WindowStore:
    """Build THE live window store and attach it to the span-close /
    event / counter hooks.  Idempotent: a second enable keeps the
    running store (``obs.enable`` may be re-entered with a new trace
    path without losing windows).  Tracing (``obs.spans.enable_tracing``)
    and counters (``obs.counters.enable``) are enabled on their own:
    span and event hooks fire only while tracing is on, counter forwards
    only while counters are."""
    global _ENABLED, _STORE
    if _ENABLED and _STORE is not None:
        if (_STORE.width_s != float(width_s)
                or _STORE.max_windows != int(max_windows)):
            import warnings

            warnings.warn(
                "obs time-series already enabled with width_s="
                f"{_STORE.width_s}/max_windows={_STORE.max_windows}; "
                f"keeping the running store ({width_s}/{max_windows} "
                "ignored — disable() first to resize)",
                RuntimeWarning, stacklevel=3)
        return _STORE
    store = WindowStore(width_s=width_s, max_windows=max_windows,
                        samples_per_series=samples_per_series)
    _STORE = store
    from tpu_sgd_torch.obs import counters as _counters
    from tpu_sgd_torch.obs import spans as _spans

    _spans._ON_SPAN = _on_span_close
    _spans._ON_EVENT = _on_event
    _counters._GLOBAL.forward = _forward_count
    _ENABLED = True
    return store


def disable() -> None:
    """Detach every hook, stop the close-dispatch thread, and drop the
    store.  Idempotent.  Callers who want the trailing window evaluated
    flush FIRST (``obs.disable`` does)."""
    global _ENABLED, _STORE
    _ENABLED = False
    from tpu_sgd_torch.obs import counters as _counters
    from tpu_sgd_torch.obs import spans as _spans

    _spans._ON_SPAN = None
    _spans._ON_EVENT = None
    _counters._GLOBAL.forward = None
    store, _STORE = _STORE, None
    if store is not None:
        store.close()


def is_enabled() -> bool:
    return _ENABLED


def snapshot(prefix: Optional[str] = None,
             last: Optional[int] = None) -> Optional[List[dict]]:
    """The live store's window snapshots, or ``None`` when the
    time-series layer is off — the ``Server.healthz()`` /
    ``ReplicaDriver.windows()`` scrape surface."""
    st = _STORE
    if st is None:
        return None
    return st.snapshot(prefix=prefix, last=last)


def flush() -> None:
    """Close the open window of the live store (no-op when off)."""
    st = _STORE
    if st is not None:
        st.flush()
