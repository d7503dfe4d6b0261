"""Multi-tenant serving facade: lanes + admission control, tenant-keyed
(the port of ``tpu_sgd/tenant/serve.py``).

A :class:`TenantServer` is the tenant-plane analogue of ``serve.Server``:
the SAME :class:`~tpu_sgd_torch.serve.batcher.MicroBatcher` (lanes,
deadline admission, shedding, displacement, burst admission) in front of
a :class:`~tpu_sgd_torch.tenant.engine.TenantPredictEngine`.

The batcher coalesces rows from MANY tenants into one flush, so the
tenant id must ride the row itself: it is packed as float32 COLUMN 0 of
a ``(1 + d)``-wide request row (exact for ids below 2**24 — enforced at
submit), and the flush callback splits ids from features before the
gathered pass.  The batcher, ``stack_rows``, and every admission rule
stay untouched — multi-tenant coalescing costs one column, not a second
request type.  The store's slab fixes the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tpu_sgd_torch.obs import timeseries as obs_timeseries
from tpu_sgd_torch.ops.bucketed import DEFAULT_BUCKETS
from tpu_sgd_torch.serve.batcher import MicroBatcher
from tpu_sgd_torch.tenant.engine import TenantPredictEngine

#: tenant ids must stay exact through the float32 feature row
_MAX_TENANT_ID = 1 << 24


def _check_tid(tenant_id: int) -> np.float32:
    tid = int(tenant_id)
    if not (0 <= tid < _MAX_TENANT_ID):
        raise ValueError(
            f"tenant_id must be in [0, 2**24) to ride a float32 row "
            f"exactly, got {tid}")
    return np.float32(tid)


class TenantServer:
    """Micro-batched multi-tenant predict endpoint over one slab."""

    def __init__(self, store, *, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 max_batch: int = 128, max_latency_s: float = 0.005,
                 max_queue: int = 1024, metrics=None, event_log=None,
                 shed_utilization=None):
        self.store = store
        self.engine = TenantPredictEngine(store, buckets)
        if metrics is None and event_log is not None:
            # same wiring as serve.Server: a listener event log buys the
            # per-batch latency records a lane p99 SLO reads
            from tpu_sgd_torch.serve.metrics import ServingMetrics

            metrics = ServingMetrics(listener=event_log)
        self.metrics = metrics
        self.batcher = MicroBatcher(
            self._predict_batch,
            max_batch=max_batch,
            max_latency_s=max_latency_s,
            max_queue=max_queue,
            metrics=metrics,
            padded_size_fn=lambda n: self.engine.bucket_for(n),
            shed_utilization=shed_utilization,
        )

    # -- flush side --------------------------------------------------------
    def _predict_batch(self, X):
        """Split the composite rows the batcher coalesced: column 0 is
        the tenant id (exact float32 integers), the rest the features."""
        Xh = np.asarray(X)
        tids = Xh[:, 0].astype(np.int64)
        return self.engine.predict_batch(tids, Xh[:, 1:])

    # -- client side -------------------------------------------------------
    def submit(self, tenant_id: int, x, lane: str = "interactive",
               deadline_s: Optional[float] = None):
        """Enqueue one ``(tenant_id, features)`` request; resolves to
        that tenant's score for the row.  Admission raises/answers
        exactly like the single-model server (typed ``Overloaded``)."""
        xb = np.asarray(x, np.float32).reshape(-1)
        row = np.concatenate(([_check_tid(tenant_id)], xb))
        return self.batcher.submit(row, lane=lane, deadline_s=deadline_s)

    def submit_burst(self, tenant_ids, X, lane: str = "interactive",
                     deadline_s: Optional[float] = None):
        """Admit a whole ``(tenant_ids, X)`` burst under one lock round
        (``MicroBatcher.submit_burst``); returns one future per row."""
        Xh = np.asarray(X, np.float32)
        tids = np.asarray(tenant_ids).reshape(-1)
        if Xh.ndim != 2 or Xh.shape[0] != tids.shape[0]:
            raise ValueError(
                f"X must be (n, d) with one tenant id per row, got "
                f"X{Xh.shape} for {tids.shape[0]} ids")
        col = np.empty((len(tids), 1), np.float32)
        for i, t in enumerate(tids):
            col[i, 0] = _check_tid(t)
        rows = np.concatenate([col, Xh], axis=1)
        return self.batcher.submit_burst(list(rows), lane=lane,
                                         deadline_s=deadline_s)

    def predict(self, tenant_id: int, x, timeout: Optional[float] = None,
                *, lane: str = "interactive",
                deadline_s: Optional[float] = None):
        return self.submit(tenant_id, x, lane=lane,
                           deadline_s=deadline_s).result(timeout)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.batcher.start()
        return self

    def stop(self, drain: bool = True):
        self.batcher.stop(drain=drain)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- ops ---------------------------------------------------------------
    def healthz(self) -> dict:
        """Tenant-plane ops probe: slab residency/eviction ledger, the
        admission-cost ledger, engine counters, and the
        per-tenant obs windows (``tenant.*`` series)."""
        return {
            "serving": self.batcher._thread is not None,
            "queue_depth": self.batcher.queue_depth,
            "batch_count": self.batcher.batch_count,
            "lanes": self.batcher.lane_snapshot(),
            "admission": self.batcher.admission_snapshot(),
            "slab": self.store.slab.ledger_snapshot(),
            "engine": {
                "calls": self.engine.call_count,
                "dispatches": self.engine.dispatch_count,
                "uniform": self.engine.uniform_count,
                "mixed": self.engine.mixed_count,
                "compiles": self.engine.compile_count,
            },
            "windows": obs_timeseries.snapshot(prefix="tenant", last=8),
        }
