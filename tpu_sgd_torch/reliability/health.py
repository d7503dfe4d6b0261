"""Liveness observability: heartbeats, stragglers, queue depth (the port
of ``tpu_sgd/reliability/health.py``).

The port has two places a silent stall can hide: the ingest
prefetcher's worker thread (a wedged host link leaves the consumer
blocked in ``Future.result``) and the serving batcher's flush thread (a
wedged predict leaves every client future pending).  A component ticks a
:class:`Heartbeat` on every unit of work, and a :class:`HealthMonitor`
turns those ticks plus queue-depth probes into ``reliability_*`` events
on the event-log contract (``tpu_sgd_torch.utils.events``).

The monitor is deliberately passive: it observes and emits, it never
kills.  Policy (retry, resume, degrade) lives in ``retry.py`` /
``supervisor.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from tpu_sgd_torch.obs.timeseries import observe_scalar
from tpu_sgd_torch.utils.events import ReliabilityEvent

#: lock-discipline declaration (the JAX package's analyzer reads these).
#: Heartbeat state is written by worker threads and read by the monitor; the
#: probe registries are mutated by user threads while the monitor
#: thread snapshots them.  ``count`` is ``:w``: the read side tolerates
#: a stale int (it rides into an event detail string), writes serialize.
GRAFTLINT_LOCKS = {
    "Heartbeat": {
        "_last": "_lock",
        "count": "_lock:w",
    },
    "HealthMonitor": {
        "_heartbeats": "_lock",
        "_queues": "_lock",
    },
}


class Heartbeat:
    """A monotonic last-alive marker a worker ticks per unit of work.

    ``beat()`` is two assignments under a lock — cheap enough for
    per-chunk / per-batch call sites.  ``age_s()`` is how long the
    component has been silent; the owner decides what silence means
    (an idle batcher is silent and healthy, a mid-build prefetcher
    silent for 10 s is a wedged feed)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._last: Optional[float] = None
        self.count = 0

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self.count += 1
        # the live windowed-series feed (obs/timeseries.py; one
        # module-global load + falsy branch when it is off): a stall
        # rule compares these per-component beat series across windows,
        # which is how a HANG becomes visible.  Outside the lock: the
        # window store has its own.
        observe_scalar(f"reliability.heartbeat[{self.name}]", 1.0)

    def age_s(self) -> Optional[float]:
        """Seconds since the last beat, or None before the first."""
        with self._lock:
            last = self._last
        return None if last is None else time.monotonic() - last


class HealthMonitor:
    """Samples registered probes and emits ``reliability_*`` events.

    Probes register by name: :meth:`watch_heartbeat` flags a component
    as a straggler when its beat age exceeds ``stall_after_s``;
    :meth:`watch_queue` samples a depth callable (batcher backlog,
    pending checkpoint parts).  :meth:`sample_once` takes one synchronous
    sample of everything — tests and soaks drive that directly;
    :meth:`start` runs it on a background interval for live deployments.
    """

    def __init__(self, listener=None, *, interval_s: float = 1.0,
                 stall_after_s: float = 10.0):
        if interval_s <= 0 or stall_after_s <= 0:
            raise ValueError("interval_s and stall_after_s must be > 0")
        self.listener = listener
        self.interval_s = float(interval_s)
        self.stall_after_s = float(stall_after_s)
        self._heartbeats: Dict[str, Heartbeat] = {}
        self._queues: Dict[str, Callable[[], int]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.straggler_count = 0

    # -- registration ------------------------------------------------------
    def watch_heartbeat(self, heartbeat: Heartbeat) -> Heartbeat:
        """Watching IS the stall roster: the
        ``reliability.hb.watch[...]`` observation admits this component
        to the series a stall rule reads (the JAX package's
        ``HeartbeatStallDetector``) — silence is only a STALL for
        components someone declared should be beating (an idle batcher
        is silent and healthy)."""
        with self._lock:
            self._heartbeats[heartbeat.name] = heartbeat
        observe_scalar(f"reliability.hb.watch[{heartbeat.name}]", 1.0)
        return heartbeat

    def unwatch_heartbeat(self, name: str) -> None:
        """Retire a component from the roster (a clean shutdown must
        not leave a phantom whose silence reads as a stall in the next
        run's windows)."""
        with self._lock:
            self._heartbeats.pop(name, None)
        observe_scalar(f"reliability.hb.unwatch[{name}]", 1.0)

    def watch_queue(self, name: str, depth_fn: Callable[[], int]) -> None:
        with self._lock:
            self._queues[name] = depth_fn

    # -- sampling ----------------------------------------------------------
    def sample_once(self) -> list:
        """One synchronous sample of every probe; returns the emitted
        events (also forwarded to the listener)."""
        with self._lock:
            beats = list(self._heartbeats.values())
            queues = list(self._queues.items())
        events = []
        for hb in beats:
            age = hb.age_s()
            if age is None:
                continue  # not started yet: silence is not a stall
            events.append(ReliabilityEvent(
                kind="heartbeat", source=hb.name, value=age,
                detail=f"beats={hb.count}"))
            if age > self.stall_after_s:
                self.straggler_count += 1
                events.append(ReliabilityEvent(
                    kind="straggler", source=hb.name, value=age,
                    detail=f"silent > {self.stall_after_s}s"))
        for name, fn in queues:
            try:
                depth = int(fn())
            except Exception:  # a dying component must not kill the monitor
                continue
            events.append(ReliabilityEvent(
                kind="queue_depth", source=name, value=depth))
        if self.listener is not None:
            for ev in events:
                try:
                    self.listener.on_reliability(ev)
                except Exception:
                    pass  # observability must never kill the observed
        return events

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="tpu-sgd-health", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def __enter__(self) -> "HealthMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
