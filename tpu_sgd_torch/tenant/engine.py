"""Tenant-aware bucketed predict: mixed-tenant batches in one pass (the
port of ``tpu_sgd/tenant/engine.py``).

The tenant counterpart of ``serve/engine.py``'s :class:`PredictEngine`,
with the same discipline and one extra input: each request row carries a
tenant id, and the batch scores against that tenant's slab row through
the gathered matvec (``ops.bucketed.bucketed_gather_matvec``) — the slot
vector and the slab are data, so the ops and shapes a batch runs are
independent of how many tenants appear in it.

Exactness split, deliberately explicit:

* a UNIFORM batch (every row the same tenant — the M=1 slab and the
  common per-tenant micro-batch) takes that tenant's host row and
  routes through the canonical :func:`bucketed_matvec` — the same ops at
  the same shape as ``model.predict`` and the single-model
  ``PredictEngine``, hence bitwise-identical to them;
* a MIXED batch runs the gathered dot — same math, another reduction,
  so ~1 ulp against the uniform path.

Both run on the slab's device, each batch one host-to-device copy of the
rows (and of the slot vector, mixed) and one copy of the scores back
(``ops.bucketed.fetch``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_sgd_torch.obs.spans import event as obs_event
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.ops.bucketed import (DEFAULT_BUCKETS, bucket_for,
                                        bucketed_gather_matvec,
                                        bucketed_matvec,
                                        bucketed_multi_matvec, fetch,
                                        program_cache_size,
                                        slab_program_cache_size)
from tpu_sgd_torch.tenant.slab import row_set_program_cache_size


class TenantPredictEngine:
    """Score ``(tenant_id, features)`` batches against a tenant store's
    slab.  Stateless with respect to residency: admission-on-miss and
    hot reloads happen inside the store; the engine only snapshots and
    scores."""

    def __init__(self, store, buckets: Tuple[int, ...] = DEFAULT_BUCKETS):
        self.store = store
        self.buckets = tuple(buckets)
        self.call_count = 0
        self.dispatch_count = 0
        self.uniform_count = 0
        self.mixed_count = 0

    @property
    def compile_count(self) -> int:
        """Every padded shape a tenant predict can reach: the shared
        single-model matvec shapes (uniform path), the slab gather/all
        shapes, and the slab's row-set (hot reload) shapes."""
        return (program_cache_size() + slab_program_cache_size()
                + row_set_program_cache_size())

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    def predict_batch(self, tenant_ids, X) -> np.ndarray:
        """Margin/score for each row of ``X`` under its own tenant's
        model — one scoring pass regardless of how many distinct tenants
        the batch mixes.  Emits a ``tenant.predict`` event per distinct
        tenant (its staleness attr feeds the per-tenant series)."""
        tids = np.asarray(tenant_ids, np.int64).reshape(-1)
        Xh = np.asarray(X)
        if Xh.ndim != 2 or Xh.shape[0] != tids.shape[0]:
            raise ValueError(
                f"X must be (n, d) with one tenant id per row, got "
                f"X{Xh.shape} for {tids.shape[0]} ids")
        self.call_count += 1
        uniq = np.unique(tids)
        act = self.store.activation
        with span("tenant.batch") as sp:
            if len(uniq) == 1:
                # uniform batch: the canonical single-model pass on the
                # tenant's host row — bitwise the PredictEngine path.
                # Bounded retry: a concurrent eviction storm can race the
                # row out between admission and read
                for _ in range(5):
                    try:
                        w, b = self.store.slab.host_row(int(uniq[0]))
                        break
                    except KeyError:
                        self.store.slots_for(uniq)  # admit from disk
                else:
                    raise KeyError(int(uniq[0]))
                w = torch.from_numpy(w).to(self.store.slab.device)
                out = fetch(bucketed_matvec(Xh, w, b, self.buckets,
                                            activation=act))
                self.uniform_count += 1
            else:
                slots, W, b = self.store.slots_for(tids)
                out = fetch(bucketed_gather_matvec(
                    Xh, slots, W, b, self.buckets, activation=act))
                self.mixed_count += 1
            self.dispatch_count += 1
            sp.set(rows=int(Xh.shape[0]), tenants=int(len(uniq)),
                   padded=self.bucket_for(int(Xh.shape[0])))
        for t in uniq:
            obs_event("tenant.predict", tenant=int(t),
                      staleness_s=self.store.staleness_s(int(t)))
        return out

    def predict_all(self, X):
        """Score every row of ``X`` against EVERY resident tenant in one
        pass — the shadow/canary multi-model batch (residents = the
        admitted registry versions).  Returns ``(scores, tenant_ids)``
        with ``scores[r, j]`` = row ``r`` under ``tenant_ids[j]``."""
        ids, slots, W, b = self.store.slab.snapshot_resident()
        if not ids:
            raise ValueError("predict_all on an empty slab")
        self.call_count += 1
        with span("tenant.batch") as sp:
            full = fetch(bucketed_multi_matvec(
                np.asarray(X), W, b, self.buckets,
                activation=self.store.activation))
            # column-select the resident slots host-side: the shape is
            # keyed on capacity alone, so admitting one more version adds
            # no shape
            scores = full[:, slots]
            self.dispatch_count += 1
            sp.set(rows=int(np.asarray(X).shape[0]), tenants=len(ids))
        return scores, np.asarray(ids, np.int64)
