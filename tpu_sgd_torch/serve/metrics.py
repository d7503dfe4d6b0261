"""Serving observability: rolling latency/throughput stats + event log
(the port of ``tpu_sgd/serve/metrics.py``).

Every coalesced batch emits a :class:`~tpu_sgd_torch.utils.events.
ServeBatchEvent` carrying queue depth, coalesced size, padded bucket,
oldest-request latency and the cumulative reject count, and every
hot-reload attempt a :class:`~tpu_sgd_torch.utils.events.ServeReloadEvent`;
attach a ``JsonLinesEventLog`` and the endpoint's behavior is replayable
offline.

On top of the raw event stream, :class:`ServingMetrics` keeps a bounded
rolling window of per-request latencies for p50/p99 (the numbers an SLO
is written against) and cheap counters for totals — ``snapshot()`` is the
scrape surface.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from tpu_sgd_torch.utils.events import ServeBatchEvent, ServeReloadEvent


def nearest_rank(xs: List[float], p: float) -> float:
    """THE nearest-rank percentile rule, defined once: the live scrape
    (:meth:`ServingMetrics.latency_percentile`) and the window store
    (``obs/timeseries.py``) both call this, so an SLO written against a
    live p99 means the same thing evaluated over a trace.  ``xs`` must
    already be sorted; empty means 0.0."""
    if not xs:
        return 0.0
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * len(xs))) - 1))
    return xs[k]


class ServingMetrics:
    """Thread-safe rolling serving stats; forwards events to a listener."""

    def __init__(self, listener=None, window: int = 4096):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.listener = listener
        self._lock = threading.Lock()
        self._latencies: deque = deque(maxlen=int(window))
        self.total_requests = 0
        self.total_batches = 0
        self.total_rejects = 0
        self.total_padded_rows = 0
        #: typed admission rejections by reason ("queue_full" /
        #: "deadline" / "shed" / "displaced") and by lane — the scrape
        #: twins of the batcher's own lane_counts
        self.rejects_by_reason: Dict[str, int] = {}
        self.rejects_by_lane: Dict[str, int] = {}
        #: resolves the serving model version at record time (set by the
        #: Server facade when a registry is attached)
        self.version_source: Optional[Callable[[], int]] = None

    def _version(self) -> int:
        try:
            return int(self.version_source()) if self.version_source else -1
        except Exception:
            return -1

    def record_reject(self, lane: str = "interactive",
                      reason: str = "queue_full"):
        with self._lock:
            self.total_rejects += 1
            self.rejects_by_reason[reason] = (
                self.rejects_by_reason.get(reason, 0) + 1)
            self.rejects_by_lane[lane] = (
                self.rejects_by_lane.get(lane, 0) + 1)

    def record_batch(
        self,
        *,
        queue_depth: int,
        batch_size: int,
        padded_size: int,
        latencies: List[float],
        reject_count: int,
        enqueue_depth: int = 0,
        deadline_slack_s: float = 0.0,
        lanes: Optional[dict] = None,
    ):
        """``enqueue_depth``/``deadline_slack_s`` are the
        admission-control inputs: the queue depth the batch's oldest
        request saw at its own enqueue, and the deadline slack left when
        the batch flushed (negative = missed).  ``lanes`` is
        the batch's lane composition — ``{lane: {n, max_latency_s}}`` —
        the record a per-lane p99 SLO evaluates over (the JAX package's
        ``obs.report``).  All default so older callers keep working; new records
        simply carry more keys."""
        with self._lock:
            self.total_batches += 1
            self.total_requests += batch_size
            self.total_padded_rows += padded_size
            self._latencies.extend(latencies)
        event = ServeBatchEvent(
            queue_depth=int(queue_depth),
            batch_size=int(batch_size),
            padded_size=int(padded_size),
            latency_s=float(max(latencies)) if latencies else 0.0,
            reject_count=int(reject_count),
            model_version=self._version(),
            enqueue_depth=int(enqueue_depth),
            deadline_slack_s=float(deadline_slack_s),
            lanes=lanes,
        )
        if self.listener is not None:
            self.listener.on_serve_batch(event)

    def record_reload(self, event: ServeReloadEvent):
        if self.listener is not None:
            self.listener.on_serve_reload(event)

    # -- scrape surface ----------------------------------------------------
    def latency_percentile(self, p: float) -> float:
        """Rolling-window latency percentile in seconds (nearest-rank)."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            xs = sorted(self._latencies)
        return nearest_rank(xs, p)

    def snapshot(self) -> dict:
        with self._lock:
            n_req = self.total_requests
            n_bat = self.total_batches
            padded = self.total_padded_rows
            rejects = self.total_rejects
            by_reason = dict(self.rejects_by_reason)
            by_lane = dict(self.rejects_by_lane)
        return {
            "total_requests": n_req,
            "total_batches": n_bat,
            "total_rejects": rejects,
            "rejects_by_reason": by_reason,
            "rejects_by_lane": by_lane,
            "mean_batch_size": n_req / n_bat if n_bat else 0.0,
            # padding efficiency: real rows per padded row actually scored
            "pad_efficiency": n_req / padded if padded else 0.0,
            "p50_latency_s": self.latency_percentile(50),
            "p99_latency_s": self.latency_percentile(99),
        }
