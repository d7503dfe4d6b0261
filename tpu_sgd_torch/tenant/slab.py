"""Device-resident weight slab: M tenants' models as ONE ``(C, d)`` tensor
(the port of ``tpu_sgd/tenant/slab.py``).

Thousands of tenants each own a small GLM.  M separate device tensors
would mean M transfers and M scoring paths; instead every resident tenant
occupies one ROW of a fixed-capacity slab, and scoring gathers rows by a
slot vector (``ops.bucketed.bucketed_gather_matvec``), so the padded
shapes depend on the slab's SHAPE (capacity x width), never on which —
or how many — tenants are resident.

Residency is LRU: admitting a tenant into a full slab evicts the
least-recently-served one (its checkpoints remain on disk; the next
request for it re-admits).  A hot reload swaps ONE row — the neighbours'
rows, the LRU order and the shape keys are untouched.

Thread contract, and why it is safe: admissions, swaps and snapshot reads
serialize on one lock, and a published device tensor is NEVER written.
A swap is copy-on-write: under the lock it clones the current ``(C, d)``
weights and ``(C,)`` intercepts, writes the one row into the clones, and
replaces the references.  So a predict that took a ``(slots, W, b)``
snapshot under the lock keeps a consistent view however many swaps land
while it runs: it holds the old tensors, nobody writes them, and its
reference keeps their memory alive.  The old tensors' memory returns to
PyTorch's caching allocator when the last holder drops it; the allocator
hands such a block only to later allocations on the same stream, whose
kernels run after every kernel queued before on that stream — including
the predict's reads.  This needs every device op of the slab and of the
predict on one stream: each runs on the current stream of the slab's
device, and the port's serving threads keep the default one.  The cost
of a swap is one device copy of the slab (4 MB at C = 1,024, d = 1,000
in f32) and the row's host-to-device copy.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.device import resolve_device

#: lock-discipline declaration (the JAX package's analyzer reads these):
#: the host mirrors, the device references, the LRU map, and the ledger
#: are shared between serving threads (snapshot reads) and admission /
#: hot-reload callers — every touch holds the lock.  The device refs are
#: ``:w`` (atomic-reference swap: a reader that copied them out under the
#: lock keeps a consistent view of tensors nobody writes).
GRAFTLINT_LOCKS = {
    "WeightSlab": {
        "_host_w": "_lock",
        "_host_b": "_lock",
        "_dev_w": "_lock:w",
        "_dev_b": "_lock:w",
        "_lru": "_lock",
        "_free": "_lock",
        "_published_at": "_lock",
        "_versions": "_lock",
        "ledger": "_lock",
        "evictions": "_lock",
    },
}

#: row-set (hot reload) shapes used so far, as keys (capacity, d, dtype):
#: the slot index and the row are data, so ONE shape serves every row of
#: every tenant forever (the JAX package's row-set program count)
_ROW_SET_SHAPES: set = set()
#: memo-key declaration (tpu_sgd_torch/analysis): one row-set shape key
#: per slab shape, whatever the row or the tenant
GRAFTLINT_MEMO = {"_ROW_SET_SHAPES": ("capacity", "d", "dtype")}


def row_set_program_cache_size() -> int:
    return len(_ROW_SET_SHAPES)


class SlabFullError(RuntimeError):
    """Admission thrash: the working set churned a just-admitted tenant
    out before it could be served — capacity is too small for the
    concurrency."""


class WeightSlab:
    """Fixed-capacity ``(C, d)`` device slab + ``(C,)`` intercepts with
    LRU admission/eviction and per-row copy-on-write hot swap, on
    ``device`` (``None``: the card).

    Tenant ids are integers (they ride serving rows as a float32
    column — exact below 2**24; ``tenant/serve.py``).  The eviction
    ledger (``ledger`` counts + the ``evictions`` log) is exact by
    construction — tests pin it.
    """

    def __init__(self, capacity: int, d: int, dtype=np.float32,
                 device=None):
        if capacity < 1 or d < 1:
            raise ValueError(
                f"capacity and d must be >= 1, got ({capacity}, {d})")
        self.capacity = int(capacity)
        self.d = int(d)
        #: immutable after construction — safe to read lock-free
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._host_w = np.zeros((self.capacity, self.d), self.dtype)
        self._host_b = np.zeros((self.capacity,), np.float32)
        self._dev_w = torch.from_numpy(self._host_w).to(self.device,
                                                        copy=True)
        self._dev_b = torch.from_numpy(self._host_b).to(self.device,
                                                        copy=True)
        #: tenant_id -> slot, insertion order = recency (last = hottest)
        self._lru: "OrderedDict[int, int]" = OrderedDict()
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._published_at: Dict[int, float] = {}
        self._versions: Dict[int, int] = {}
        #: exact admission/eviction ledger (tests pin it): ``admitted``
        #: = tenants brought into the slab, ``evicted`` = LRU victims,
        #: ``swapped`` = hot reloads of a resident row,
        #: ``hits``/``misses`` = per-tenant residency outcomes of
        #: serving lookups
        self.ledger: Dict[str, int] = {
            "admitted": 0, "evicted": 0, "swapped": 0,
            "hits": 0, "misses": 0,
        }
        #: ordered eviction log: (evicted_tenant, slot, admitted_tenant)
        self.evictions: List[Tuple[int, int, int]] = []

    # -- residency ---------------------------------------------------------
    @property
    def resident_count(self) -> int:
        with self._lock:
            return len(self._lru)

    def resident(self) -> Tuple[int, ...]:
        """Tenant ids currently resident, coldest first."""
        with self._lock:
            return tuple(self._lru)

    def slot_of(self, tenant_id: int) -> Optional[int]:
        with self._lock:
            return self._lru.get(int(tenant_id))

    # -- admission / hot reload --------------------------------------------
    def put(self, tenant_id: int, weights, intercept: float = 0.0,
            version: int = 0):
        """Admit ``tenant_id`` (evicting the LRU tenant when full) or —
        when already resident — hot-swap its row: a copy-on-write of the
        slab with the one row written, neighbours' rows untouched.
        Returns ``(slot, evicted_tenant_or_None, "admitted"|"swapped")``."""
        with self._lock:
            return self._put_locked(tenant_id, weights, intercept, version)

    def put_then_resolve(self, rows, tenant_ids=None):
        """:meth:`put` each of ``rows`` (``(tenant_id, weights, intercept,
        version)``, in order) and then resolve ``tenant_ids`` as
        :meth:`snapshot_for` does, under ONE lock round: no other thread's
        admission can evict a row of this batch between its admission and
        the batch's resolve.  Returns ``(puts, snapshot, missing)``: each
        put's ``(slot, evicted, kind)``, then the snapshot, or ``None`` and
        the non-resident tenants (``tenant_ids=None``: puts only).

        The batch's resident rows are made the hottest before the puts
        (no ledger count: the resolve counts the batch's lookups), so the
        puts evict only rows outside the batch: a batch whose distinct
        tenants fit the slab resolves in this one round.  Put first, an
        admission could evict a resident row of its own batch, and under
        concurrent admissions the store's bounded retries then ended in a
        spurious ``SlabFullError``."""
        with self._lock:
            if tenant_ids is not None:
                for tid in dict.fromkeys(
                        np.asarray(tenant_ids).astype(np.int64).ravel()
                        .tolist()):
                    if tid in self._lru:
                        self._lru.move_to_end(tid)
            puts = [self._put_locked(*row) for row in rows]
            if tenant_ids is None:
                return puts, None, None
            try:
                return puts, self._snapshot_locked(tenant_ids), None
            except KeyError as e:
                return puts, None, e.args[0]

    def _put_locked(self, tenant_id, weights, intercept, version):
        tid = int(tenant_id)
        row = np.asarray(weights, self.dtype).reshape(self.d)
        bi = np.float32(intercept)
        evicted: Optional[int] = None
        slot = self._lru.get(tid)
        if slot is not None:
            kind = "swapped"
            self._lru.move_to_end(tid)
            self.ledger["swapped"] += 1
        else:
            kind = "admitted"
            if self._free:
                slot = self._free.pop()
            else:
                evicted, slot = self._lru.popitem(last=False)
                self._versions.pop(evicted, None)
                self._published_at.pop(evicted, None)
                self.ledger["evicted"] += 1
                self.evictions.append((evicted, slot, tid))
            self._lru[tid] = slot
            self.ledger["admitted"] += 1
        self._host_w[slot] = row
        self._host_b[slot] = bi
        _ROW_SET_SHAPES.add((self.capacity, self.d, str(self.dtype)))
        # copy-on-write: the published tensors are never written
        W, b = self._dev_w.clone(), self._dev_b.clone()
        W[slot].copy_(torch.from_numpy(self._host_w[slot]))
        b[slot] = float(bi)
        self._dev_w, self._dev_b = W, b
        self._versions[tid] = int(version)
        self._published_at[tid] = time.time()
        return slot, evicted, kind

    # -- serving reads -----------------------------------------------------
    def snapshot_for(self, tenant_ids):
        """Resolve a request batch's tenants to slab slots and return a
        CONSISTENT ``(slots, W, b)`` view: the slot vector plus the
        device tensors as of one locked instant (never written after —
        a concurrent swap replaces the references, never the snapshot).
        Touches LRU recency for every distinct tenant.  Raises
        ``KeyError`` carrying the set of non-resident tenants (the
        store's admission-on-miss hook)."""
        with self._lock:
            return self._snapshot_locked(tenant_ids)

    def _snapshot_locked(self, tenant_ids):
        tids = np.asarray(tenant_ids).astype(np.int64, copy=False)
        uniq = {int(t) for t in np.unique(tids)}
        missing = {t for t in uniq if t not in self._lru}
        if missing:
            self.ledger["misses"] += len(missing)
            self.ledger["hits"] += len(uniq) - len(missing)
            raise KeyError(missing)
        self.ledger["hits"] += len(uniq)
        for t in uniq:
            self._lru.move_to_end(t)
        lru = self._lru
        slots = np.fromiter((lru[int(t)] for t in tids), np.int32,
                            count=len(tids))
        return slots, self._dev_w, self._dev_b

    def host_row(self, tenant_id: int) -> Tuple[np.ndarray, float]:
        """One tenant's ``(weights, intercept)`` from the host mirror —
        the uniform-batch path scores it through the canonical
        ``bucketed_matvec`` for the single-model bitwise contract.
        Raises ``KeyError`` when not resident."""
        tid = int(tenant_id)
        with self._lock:
            slot = self._lru[tid]  # KeyError -> store admits and retries
            return self._host_w[slot].copy(), float(self._host_b[slot])

    def snapshot_resident(self):
        """``(tenant_ids, slots, W, b)`` for the multi-model / all-
        versions batch (``bucketed_multi_matvec``): every resident
        tenant's column, coldest first."""
        with self._lock:
            ids = tuple(self._lru)
            slots = np.fromiter((self._lru[t] for t in ids), np.int32,
                                count=len(ids))
            return ids, slots, self._dev_w, self._dev_b

    def staleness_s(self, tenant_id: int) -> float:
        """Seconds since this tenant's row was last published into the
        slab (admit or swap); ``inf`` when not resident."""
        with self._lock:
            t = self._published_at.get(int(tenant_id))
        return float("inf") if t is None else max(0.0, time.time() - t)

    def version_of(self, tenant_id: int) -> Optional[int]:
        with self._lock:
            return self._versions.get(int(tenant_id))

    # -- checkpoint state --------------------------------------------------
    def state(self) -> dict:
        """Host snapshot of the whole slab for checkpointing: the weight
        matrix, intercepts, and the residency map as parallel arrays
        (coldest first, so a restore rebuilds the same LRU order)."""
        with self._lock:
            ids = np.asarray(list(self._lru), np.int64)
            slots = np.asarray([self._lru[int(t)] for t in ids], np.int32)
            return {
                "weights": self._host_w.copy(),
                "intercepts": self._host_b.copy(),
                "tenant_ids": ids,
                "slots": slots,
                "versions": np.asarray(
                    [self._versions.get(int(t), 0) for t in ids], np.int64),
            }

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state` snapshot (same capacity/width)."""
        w = np.asarray(state["weights"], self.dtype)
        b = np.asarray(state["intercepts"], np.float32)
        if w.shape != (self.capacity, self.d):
            raise ValueError(
                f"slab state shape {w.shape} != ({self.capacity}, {self.d})")
        ids = np.asarray(state["tenant_ids"], np.int64)
        slots = np.asarray(state["slots"], np.int32)
        versions = np.asarray(state["versions"], np.int64)
        with self._lock:
            self._host_w = w.copy()
            self._host_b = b.copy()
            self._dev_w = torch.from_numpy(self._host_w).to(self.device,
                                                            copy=True)
            self._dev_b = torch.from_numpy(self._host_b).to(self.device,
                                                            copy=True)
            self._lru = OrderedDict(
                (int(t), int(s)) for t, s in zip(ids, slots))
            used = set(int(s) for s in slots)
            self._free = [s for s in range(self.capacity - 1, -1, -1)
                          if s not in used]
            now = time.time()
            self._published_at = {int(t): now for t in ids}
            self._versions = {int(t): int(v)
                              for t, v in zip(ids, versions)}

    def ledger_snapshot(self) -> dict:
        with self._lock:
            return {**self.ledger, "resident": len(self._lru),
                    "capacity": self.capacity}
