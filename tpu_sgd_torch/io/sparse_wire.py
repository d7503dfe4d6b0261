"""Compressed sparse wire: top-k + error feedback, and fixed-shape CSR
batches: the port of ``tpu_sgd/io/sparse_wire.py``.

* **top-k + error feedback**: an update vector is reduced to its ``k``
  largest-magnitude entries; the dropped mass is carried in a persistent
  error-feedback accumulator that is added back before the next
  selection, so every coordinate's contribution eventually ships.  The
  host-side selection (:class:`ErrorFeedback`) runs in numpy; the card's
  (``optimize/gradient_descent.py`` ``make_compressed_step``) uses
  :func:`topk_indices`, a deterministic selection with a fixed ``k``.

* **fixed-shape CSR batches**: the host-streamed sparse feed
  (``optimize/streamed_sparse.py``) moves each sampled batch as CSR
  components ``(crow, col, val)`` padded to ONE ``(row_cap, nse_cap)``
  shape per run (:func:`plan_sparse_batches` + :func:`stage_sparse_batch`),
  so the card's captured step sees fixed addresses and shapes, and an
  RCV1-shaped batch ships ~100x fewer bytes than its dense f32 rows.
  The JAX package ships BCOO ``(data, (row, col))`` with null entries at
  (0, 0); here the padding entries sit at the end of the LAST row, column
  0, value 0.0, which adds exact zeros to both products.

Error feedback is OPTIMIZER STATE: it changes which update reaches the
weights, so it lives in the checkpoint (``extras={"ef": ...}``) and in
the device state a block carries.

``wire_compress`` spec format: ``"topk:<frac>"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.io.integrity import seal, verify
from tpu_sgd_torch.obs.counters import record_wire
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint


def parse_wire_compress(spec) -> Optional[float]:
    """Validate a ``wire_compress`` spec; returns the top-k fraction or
    None (no compression).  Accepted: ``None``, ``"topk:<frac>"`` with
    ``0 < frac <= 1``; anything else raises."""
    if spec is None:
        return None
    if not isinstance(spec, str) or not spec.startswith("topk:"):
        raise ValueError(
            f"wire_compress must be 'topk:<frac>' or None, got {spec!r}")
    try:
        frac = float(spec[len("topk:"):])
    except ValueError:
        raise ValueError(
            f"wire_compress fraction is not a number: {spec!r}") from None
    if not 0.0 < frac <= 1.0:
        raise ValueError(
            f"wire_compress fraction must be in (0, 1], got {frac}")
    return frac


def topk_nnz(dim: int, frac: float) -> int:
    """Entries kept per compressed update: ``ceil(frac * dim)``, at least
    1, at most ``dim``."""
    return int(max(1, min(int(dim), int(np.ceil(int(dim) * float(frac))))))


def topk_select(v: np.ndarray, k: int) -> np.ndarray:
    """Host-numpy indices of the ``k`` largest-|v| entries (int32,
    unordered)."""
    v = np.asarray(v)
    k = int(min(k, v.shape[0]))
    if k >= v.shape[0]:
        return np.arange(v.shape[0], dtype=np.int32)
    return np.argpartition(np.abs(v), -k)[-k:].astype(np.int32)


def topk_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest-|v| entries of a 1-D tensor, the same
    on every run: a stable descending sort of ``|v|``, so of equal
    magnitudes the LOWER index wins (``lax.top_k``'s tie rule;
    ``torch.topk`` on the card promises no order).  ``k`` is fixed by the
    run, so a block that calls it is capturable."""
    return torch.sort(v.abs(), descending=True, stable=True).indices[:int(k)]


class ErrorFeedback:
    """Persistent host-side error-feedback accumulator for one wire (the
    JAX package's class, host numpy).

    ``compress(update)`` folds the update into the accumulator, extracts
    the top-k ``(indices, values)`` segment, and KEEPS the rest.
    ``state()``/``load_state()`` round-trip the accumulator through a
    checkpoint."""

    def __init__(self, dim: int, frac: float, dtype=np.float32):
        self.dim = int(dim)
        self.frac = float(frac)
        self.k = topk_nnz(self.dim, self.frac)
        self.acc = np.zeros((self.dim,), dtype)

    def compress(self, update: np.ndarray, record: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """``(indices int32, values)`` of the top-k of accumulator +
        update; the selected coordinates are zeroed in the accumulator.
        Passes the ``io.sparse_wire`` failpoint and ships the segment as a
        checksummed frame through the ``io.segment`` corrupting failpoint;
        nothing mutates until every check passes.  ``record=False``
        counts no wire bytes: the caller moved the update another way
        (``parallel.gram_parallel``'s merge of gathered carries)."""
        failpoint("io.sparse_wire")
        update = np.asarray(update).reshape(-1)
        if update.shape[0] != self.dim:
            raise ValueError(
                f"update has {update.shape[0]} entries, accumulator has "
                f"{self.dim}")
        folded = np.add(self.acc, update).astype(self.acc.dtype,
                                                 copy=False)
        idx = topk_select(folded, self.k)
        vals = folded[idx].copy()
        ck = seal(idx, vals)
        idx, vals = corruptpoint("io.segment", (idx, vals))
        verify("io.segment", ck, idx, vals)
        self.acc = folded
        self.acc[idx] = 0.0
        if record:
            record_wire("topk", logical_nbytes=int(update.nbytes),
                        physical_nbytes=int(vals.nbytes + idx.nbytes))
        return idx, vals

    def restore_segment(self, idx: np.ndarray, vals: np.ndarray) -> None:
        """Fold an extracted-but-NOT-delivered segment back into the
        accumulator — the rejected-push path of the bounded-staleness
        wire (``tpu_sgd_torch/replica``): a stale push is discarded whole,
        and discarding must return the selected mass to the accumulator or
        the rejection silently drops gradient.  Scatter-ADD, not set:
        later updates may have deposited new mass on the same coordinates
        since the extraction."""
        np.add.at(self.acc, np.asarray(idx, np.int64),
                  np.asarray(vals, self.acc.dtype))

    def residual(self) -> np.ndarray:
        """Copy of the still-unsent mass."""
        return self.acc.copy()

    def state(self) -> np.ndarray:
        return self.acc.copy()

    def load_state(self, acc: np.ndarray) -> None:
        acc = np.asarray(acc).reshape(-1)
        if acc.shape[0] != self.dim:
            raise ValueError(
                f"checkpointed accumulator has {acc.shape[0]} entries, "
                f"this wire needs {self.dim}")
        self.acc = acc.astype(self.acc.dtype, copy=True)


# -- SparCML stream aggregation (arXiv:1802.08021) ---------------------------

def _merge_pair(a, b):
    """Two sparse ``(indices, values)`` segments merged into one without
    duplicates: concatenated, stably sorted by index, and each run of
    equal indices summed by ``np.add.reduceat`` in concatenation order,
    so the merge is a deterministic function of its inputs."""
    idx = np.concatenate([a[0], b[0]])
    vals = np.concatenate([a[1], b[1]])
    order = np.argsort(idx, kind="stable")
    idx = idx[order]
    vals = vals[order]
    starts = np.flatnonzero(np.r_[True, idx[1:] != idx[:-1]])
    return idx[starts], np.add.reduceat(vals, starts)


def merge_sparse_segments(segments, dim: int,
                          density_crossover: float = 0.25) -> np.ndarray:
    """SparCML stream aggregation of top-k ``(indices, values)``
    contributions, host numpy: the segments merge pairwise up a tree
    (each round halves their count while the merged segments stay
    sparse) until any merged segment's density ``nnz / dim`` passes
    ``density_crossover``; then the remaining segments are added into a
    dense accumulator in list order.  Returns the dense f32 ``(dim,)``
    sum.  Deterministic in the segment ORDER (callers pass them in shard
    order), which keeps a primary and its standby bitwise alike.
    Segments may be empty; duplicate indices within a segment add."""
    dim = int(dim)
    segs = []
    for si, sv in segments:
        si = np.asarray(si, np.int64).reshape(-1)
        sv = np.asarray(sv, np.float32).reshape(-1)
        if si.size:
            segs.append((si, sv))
    if not segs:
        return np.zeros((dim,), np.float32)
    nnz_cap = max(1, int(np.ceil(float(density_crossover) * dim)))
    while len(segs) > 1:
        merged = [_merge_pair(segs[j], segs[j + 1])
                  for j in range(0, len(segs) - 1, 2)]
        if len(segs) % 2:
            merged.append(segs[-1])
        segs = merged
        if any(si.size > nnz_cap for si, _ in segs):
            # the density crossover: finish in one dense accumulator
            out = np.zeros((dim,), np.float32)
            for si, sv in segs:
                np.add.at(out, si, sv)
            return out
    out = np.zeros((dim,), np.float32)
    si, sv = segs[0]
    np.add.at(out, si, sv)
    return out


# -- fixed-shape sparse batches ----------------------------------------------

def plan_sparse_batches(indptr: np.ndarray, sample_rows, num_iterations: int,
                        row_cap: int) -> int:
    """Fixed nse cap covering EVERY batch of a deterministic sampled run:
    one host pre-pass over ``sample_rows(i)`` (iteration ``i``'s row ids,
    truncated to ``row_cap`` as the producer truncates) for ``i = 1 ..
    num_iterations``.  A resumed run plans over the same range, so its cap
    matches the uninterrupted run's.  Returns ``nse_cap >= 1``."""
    row_nnz = np.diff(np.asarray(indptr)).astype(np.int64)
    cap = 1
    for i in range(1, int(num_iterations) + 1):
        rows = np.asarray(sample_rows(i))[:row_cap]
        nse = int(row_nnz[rows].sum())
        if nse > cap:
            cap = nse
    return cap


def gather_csr_rows(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    rows: np.ndarray):
    """Host-numpy CSR row gather: entries of ``rows`` (in order) with
    LOCAL row ids ``0 .. len(rows) - 1``.  Returns ``(lrows, lcols,
    lvals)`` flat entry arrays (vectorized, no per-row loop)."""
    rows = np.asarray(rows)
    starts = indptr[rows]
    counts = (indptr[rows + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                np.zeros((0,), vals.dtype))
    base = np.repeat(starts, counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    pos = base + within
    lrows = np.repeat(np.arange(rows.shape[0], dtype=np.int32), counts)
    return lrows, cols[pos].astype(np.int32), vals[pos]


def sparse_batch_index_dtype(row_cap: int, nse_cap: int, d: int):
    """The index dtype of a staged batch: int32 when the entry count and
    both dimensions fit (the CSR kernel takes both)."""
    from tpu_sgd_torch.ops.sparse import index_dtype

    return index_dtype(int(nse_cap), int(row_cap) + 1, int(d))


def stage_sparse_batch(indptr: np.ndarray, cols: np.ndarray,
                       vals: np.ndarray, rows: np.ndarray, row_cap: int,
                       nse_cap: int, out=None):
    """Assemble one fixed-shape CSR batch on the host.

    Returns ``(crow (row_cap + 1,), col (nse_cap,), val (nse_cap,), valid
    (row_cap,) bool)`` CPU tensors: the entries of ``rows`` at local row
    ids, padded to ``nse_cap`` entries at the end of the last row (column
    0, value 0.0: exact zeros in both products) and to ``row_cap`` empty
    rows.  ``out`` (four CPU tensors of those shapes, e.g. a pinned
    staging slot) receives the batch in place.  Passes the
    ``io.sparse_wire`` failpoint."""
    failpoint("io.sparse_wire")
    rows = np.asarray(rows)
    counts = np.diff(np.asarray(indptr))[rows]
    lrows, lcols, lvals = gather_csr_rows(indptr, cols, vals, rows)
    nse = lvals.shape[0]
    if nse > nse_cap:
        raise ValueError(
            f"batch carries {nse} entries but the plan capped nse at "
            f"{nse_cap} (the pre-pass and the producer must share one "
            "sample rule)")
    if rows.shape[0] > row_cap:
        raise ValueError(f"{rows.shape[0]} rows do not fit row_cap "
                         f"{row_cap}")
    if out is None:
        idt = sparse_batch_index_dtype(row_cap, nse_cap, indptr.shape[0])
        out = (torch.empty((row_cap + 1,), dtype=idt),
               torch.empty((nse_cap,), dtype=idt),
               torch.empty((nse_cap,), dtype=torch.from_numpy(
                   lvals[:0]).dtype),
               torch.empty((row_cap,), dtype=torch.bool))
    crow, col, val, valid = out
    crow_np = np.zeros((row_cap + 1,), np.int64)
    crow_np[1:rows.shape[0] + 1] = np.cumsum(counts)
    crow_np[rows.shape[0] + 1:] = nse
    crow_np[-1] = nse_cap  # the padding entries close the last row
    crow.copy_(torch.from_numpy(crow_np))
    col[:nse].copy_(torch.from_numpy(lcols))
    col[nse:].zero_()
    val[:nse].copy_(torch.from_numpy(np.ascontiguousarray(lvals)))
    val[nse:].zero_()
    valid.zero_()
    valid[:rows.shape[0]] = True
    return crow, col, val, valid


def csr_host(X):
    """Host CSR arrays ``(indptr int64, cols int32, vals, (n, d))`` of a
    sparse tensor of any layout (the one-time relayout the streamed
    sparse feed samples from); a CSR tensor on the CPU is read in
    place."""
    from tpu_sgd_torch.ops.sparse import to_csr

    X = to_csr(X)
    if X.is_cuda:
        raise ValueError(
            "host streaming takes host data; this sparse tensor already "
            "lies on the card")
    n, d = X.shape
    indptr = X.crow_indices().numpy().astype(np.int64)
    cols = X.col_indices().numpy().astype(np.int32)
    vals = X.values().numpy()
    return indptr, cols, vals, (int(n), int(d))
