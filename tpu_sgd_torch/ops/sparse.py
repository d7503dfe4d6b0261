"""Sparse features, trained undensified: the port of ``tpu_sgd/ops/sparse.py``
(a data mesh's row blocks: ``parallel/sparse_parallel.py``).

The JAX package keeps sparse features as a BCOO matrix; here they are a
torch sparse CSR tensor.  Any non-strided layout (CSR, CSC, COO, BSR)
counts as sparse (:func:`is_sparse`); the optimizer turns it into CSR with
:func:`to_csr`.  The fused gradient keeps the dense path's factorization

    margins  = X @ w          # CSR x vector
    coeff, l = pointwise(margins, y)
    grad_sum = Xt @ coeff     # CSR x vector on the transposed copy

Both products are row-major CSR x vector.  ``coeff @ X`` straight from
the row layout would scatter into ``d`` slots with float atomics, which on
RCV1's Zipf-headed columns are contended and give a different sum each
run; instead :func:`transpose_csr` builds the transposed CSR once per
dataset, which doubles the matrix's memory.

Indices are int32 whenever the entry count and both dimensions fit
(:func:`index_dtype`): torch's CSR product takes int32 indices on the CPU
and on CUDA, and they halve the index bytes that every product reads.

The host-side helpers (:func:`host_entries`, :func:`take_rows`, the
generators and the loader) build CPU tensors, like the numpy arrays of the
dense generators; the optimizer moves them to its device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_INT32_MAX = np.iinfo(np.int32).max


def is_sparse(X) -> bool:
    """True when ``X`` is a sparse tensor of any layout (CSR, CSC, COO,
    BSR): the one test of the port (``Tensor.is_sparse`` is True for COO
    only)."""
    return isinstance(X, Tensor) and X.layout != torch.strided


def index_dtype(nnz: int, *dims: int) -> torch.dtype:
    """int32 when the entry count and every dimension fit in it, else
    int64."""
    return torch.int32 if max(nnz, *dims) <= _INT32_MAX else torch.int64


def _csr(crow, col, vals, shape) -> Tensor:
    """A CSR tensor from components the caller has validated."""
    return torch.sparse_csr_tensor(crow, col, vals, size=tuple(shape),
                                   check_invariants=False)


def to_csr(X: Tensor) -> Tensor:
    """``X`` (any sparse layout) as CSR with :func:`index_dtype` indices;
    a CSR tensor with those indices is returned as it is."""
    if X.layout not in (torch.sparse_csr, torch.sparse_csc):
        X = X.to_sparse_coo().coalesce()  # COO, BSR, BSC
    if X.layout != torch.sparse_csr:
        X = X.to_sparse_csr()
    n, d = X.shape
    idt = index_dtype(X._nnz(), n, d)
    crow, col = X.crow_indices(), X.col_indices()
    if crow.dtype == idt and col.dtype == idt:
        return X
    return _csr(crow.to(idt), col.to(idt), X.values(), X.shape)


def row_ids(X: Tensor) -> Tensor:
    """The row of each stored entry of a CSR ``X`` (its expanded
    ``crow_indices``), in X's index dtype and place."""
    crow = X.crow_indices()
    n = X.shape[0]
    return torch.repeat_interleave(
        torch.arange(n, dtype=crow.dtype, device=crow.device),
        torch.diff(crow.to(torch.int64)), output_size=X._nnz())


def transpose_csr(X: Tensor) -> Tensor:
    """``X.T`` as CSR (``(d, n)``): entries sorted by column with a stable
    sort, so each column's rows stay in order.  Built once per dataset:
    it is a full second copy of the entries."""
    n, d = X.shape
    col = X.col_indices()
    order = torch.argsort(col, stable=True)
    crow = torch.zeros(d + 1, dtype=torch.int64, device=col.device)
    crow[1:] = torch.cumsum(torch.bincount(col, minlength=d), 0)
    return _csr(crow.to(col.dtype), row_ids(X)[order], X.values()[order],
                (d, n))


def transpose_csr_into(crow: Tensor, col: Tensor, vals: Tensor, d: int,
                       out_crow: Tensor, out_row: Tensor,
                       out_vals: Tensor) -> None:
    """:func:`transpose_csr` of the CSR components ``(crow, col, vals)``
    (``d`` columns) into fixed buffers (``out_crow (d + 1,)``, ``out_row``
    and ``out_vals`` of the entry count), with no host read: the streamed
    sparse feed builds each batch's transposed copy on the card this way,
    outside the captured step, into the slot the step reads.  The same
    stable order as :func:`transpose_csr`."""
    order = torch.argsort(col, stable=True)
    rows = torch.repeat_interleave(
        torch.arange(crow.numel() - 1, dtype=col.dtype, device=col.device),
        torch.diff(crow), output_size=col.numel())
    sorted_col = col[order]
    out_row.copy_(rows[order])
    out_vals.copy_(vals[order])
    out_crow.copy_(torch.searchsorted(
        sorted_col, torch.arange(d + 1, dtype=col.dtype, device=col.device),
        out_int32=col.dtype == torch.int32))


def csr_bytes(X: Tensor) -> int:
    """Bytes of a CSR tensor's three arrays."""
    return sum(t.numel() * t.element_size()
               for t in (X.crow_indices(), X.col_indices(), X.values()))


def row_matrix(x) -> Tensor:
    """A 1-D sparse vector (any layout) as a ``(1, d)`` CSR row matrix;
    a 2-D input is returned as it is."""
    if x.dim() != 1:
        return x
    x = x.to_sparse_coo().coalesce()
    col = x.indices()[0]
    (d,) = x.shape
    idt = index_dtype(col.numel(), d)
    crow = torch.tensor([0, col.numel()], dtype=idt, device=col.device)
    return _csr(crow, col.to(idt), x.values(), (1, d))


def host_entries(X) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host ``(rows, cols, vals)`` numpy arrays of a sparse ``X``,
    row-major sorted.  (Torch keeps no out-of-range padding entries, which
    the JAX version drops from a BCOO.)"""
    X = to_csr(X).cpu()
    rows = row_ids(X).numpy().astype(np.int64)
    cols = X.col_indices().numpy().astype(np.int32)
    vals = X.values().numpy()
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def take_rows(X, idx) -> Tensor:
    """Rows ``idx`` (unique row ids, in ``idx`` order) of a sparse ``X``
    as a CSR tensor on the CPU: the sparse ``X[idx]`` of k-fold and
    train/test splitting."""
    idx = np.asarray(idx)
    if np.unique(idx).size != idx.size:
        raise ValueError("take_rows needs unique row indices")
    n, d = X.shape
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise IndexError(
            f"row indices must lie in [0, {n}); got range "
            f"[{idx.min()}, {idx.max()}]"
        )
    rows, cols, vals = host_entries(X)
    pos = np.full((n,), -1, np.int64)
    pos[idx] = np.arange(idx.size)
    sel = pos[rows] >= 0
    new_rows = pos[rows[sel]]
    cols, vals = cols[sel], vals[sel]
    order = np.lexsort((cols, new_rows))
    indptr = np.zeros((idx.size + 1,), np.int64)
    np.add.at(indptr, new_rows + 1, 1)
    return csr_from_triple((vals[order], cols[order], np.cumsum(indptr)), d,
                           dtype=X.dtype)


def append_bias_sparse(X: Tensor) -> Tensor:
    """Sparse ``MLUtils.appendBias``: one extra always-1 column (index d)
    at the end of every row, keeping the matrix sparse and CSR-sorted."""
    X = to_csr(X)
    n, d = X.shape
    crow, col, vals = X.crow_indices(), X.col_indices(), X.values()
    dev = col.device
    idt = index_dtype(X._nnz() + n, n, d + 1)
    # each row gains one entry: entry k of row r moves to k + r, and row
    # r's bias lands at its old end crow[r + 1] plus r
    shift = torch.arange(n + 1, dtype=torch.int64, device=dev)
    new_crow = crow.to(torch.int64) + shift
    old_pos = torch.arange(X._nnz(), dtype=torch.int64, device=dev) \
        + row_ids(X).to(torch.int64)
    bias_pos = new_crow[1:] - 1
    new_col = torch.empty(X._nnz() + n, dtype=idt, device=dev)
    new_vals = torch.empty(X._nnz() + n, dtype=vals.dtype, device=dev)
    new_col[old_pos] = col.to(idt)
    new_vals[old_pos] = vals
    new_col[bias_pos] = d
    new_vals[bias_pos] = 1
    return _csr(new_crow.to(idt), new_col, new_vals, (n, d + 1))


def append_bias_auto(X):
    """Sparse-aware ``MLUtils.appendBias``: sparse features get the sparse
    bias column, everything else the dense one."""
    if is_sparse(X):
        return append_bias_sparse(X)
    from tpu_sgd_torch.utils.mlutils import append_bias

    return append_bias(X)


def csr_from_triple(csr: Tuple, num_features: int,
                    dtype=torch.float32) -> Tensor:
    """A CSR tensor on the CPU from the loader's ``(data, indices,
    indptr)`` triple (``load_libsvm_file(dense=False)``): the counterpart
    of ``csr_to_bcoo``.  An index outside ``[0, num_features)`` raises
    ``IndexError``, as the dense loader does for the same input."""
    data, indices, indptr = csr
    indices = np.asarray(indices)
    indptr = np.asarray(indptr, np.int64)
    d = int(num_features)
    if indices.size and (int(indices.min()) < 0 or int(indices.max()) >= d):
        bad = (int(indices.min()) if int(indices.min()) < 0
               else int(indices.max()))
        raise IndexError(
            f"feature index {bad} out of range for "
            f"num_features={d} (negative means a "
            "malformed 0-based file; otherwise pass a larger "
            "num_features, e.g. the training dimensionality)"
        )
    n = indptr.shape[0] - 1
    idt = index_dtype(indices.size, n, d)
    np_idt = np.int32 if idt == torch.int32 else np.int64
    return _csr(torch.from_numpy(indptr.astype(np_idt)),
                torch.from_numpy(indices.astype(np_idt)),
                torch.as_tensor(np.asarray(data), dtype=dtype), (n, d))


def load_libsvm_file_csr(path: str, num_features: Optional[int] = None,
                         dtype=torch.float32):
    """LIBSVM file(s) -> ``(X: CSR, y)`` without ever densifying."""
    from tpu_sgd_torch.utils.mlutils import load_libsvm_file

    csr, y, d = load_libsvm_file(path, num_features=num_features,
                                 dense=False)
    return csr_from_triple(csr, d, dtype), y


def sparse_data(
    n: int,
    d: int,
    nnz_per_row: int = 50,
    weights: Optional[np.ndarray] = None,
    eps: float = 0.1,
    seed: int = 42,
    kind: str = "linear",
):
    """Random sparse dataset: ``nnz_per_row`` uniformly placed nonzeros
    per row.  ``kind``: 'linear' (y = Xw + noise), 'logistic' ({0,1} from
    sigmoid margins), 'svm' ({0,1} by noisy-margin sign).  The same numpy
    draws as the JAX version; returns ``(X: CSR on the CPU, y, w_true)``."""
    rng = np.random.default_rng(seed)
    w = (
        np.asarray(weights, np.float32)
        if weights is not None
        else rng.uniform(-1.0, 1.0, size=(d,)).astype(np.float32)
    )
    if nnz_per_row * nnz_per_row * 4 < d:
        # draw all rows at once and re-roll the few that collide
        cols = rng.integers(0, d, size=(n, nnz_per_row), dtype=np.int32)
        cols.sort(axis=1)
        bad = np.nonzero((np.diff(cols, axis=1) == 0).any(axis=1))[0]
        for i in bad:
            cols[i] = np.sort(
                rng.choice(d, size=nnz_per_row, replace=False)
            ).astype(np.int32)
    else:
        cols = np.stack(
            [np.sort(rng.choice(d, size=nnz_per_row, replace=False))
             for _ in range(n)]
        ).astype(np.int32)
    vals = rng.normal(size=(n, nnz_per_row)).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * nnz_per_row
    X = csr_from_triple((vals.reshape(-1), cols.reshape(-1), indptr), d)
    margins = np.einsum("ij,ij->i", vals, w[cols])
    if kind == "linear":
        y = (margins + eps * rng.normal(size=n)).astype(np.float32)
    elif kind == "logistic":
        p = 1.0 / (1.0 + np.exp(-margins))
        y = (rng.uniform(size=n) < p).astype(np.float32)
    elif kind == "svm":
        y = ((margins + eps * rng.normal(size=n)) > 0).astype(np.float32)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return X, y, w
