"""Summary statistics: the port of ``tpu_sgd/stat.py`` (``colStats``,
``corr`` and the column summarizer behind ``StandardScaler.fit``).

A tensor is summarized on its own device, a numpy array on the CPU.  Dense
statistics are column reductions; CSR statistics come from index-adds and
scatter-reductions over the stored entries, never densified, with the
implicit zeros folded into the extrema.  Pearson correlation is one Gram
pass over the centered columns in true f32
(:func:`~tpu_sgd_torch.device.true_f32_matmul`); a CSR matrix's Gram
goes through the CSR kernel by blocks of columns, never through a
library's sparse-sparse product.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.device import true_f32_matmul
from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr

Tensor = torch.Tensor


class MultivariateStatisticalSummary:
    """Value object mirroring [U] MultivariateStatisticalSummary: ``mean``,
    ``variance`` (sample, n-1), ``count``, ``num_nonzeros``, ``max``,
    ``min``, ``norm_l1``, ``norm_l2``: all per column, host numpy."""

    def __init__(self, mean, variance, count, num_nonzeros, mx, mn, l1, l2):
        def host(a):
            return a.cpu().numpy() if isinstance(a, Tensor) else np.asarray(a)

        self.mean = host(mean)
        self.variance = host(variance)
        self.count = int(count)
        self.num_nonzeros = host(num_nonzeros)
        self.max = host(mx)
        self.min = host(mn)
        self.norm_l1 = host(l1)
        self.norm_l2 = host(l2)


def _as_matrix(X) -> Tensor:
    """A 2-D float tensor (a numpy array on the CPU; f64 and int become
    f32, as the JAX package computes with x64 off), or a CSR tensor."""
    if is_sparse(X):
        return to_csr(X)
    X = torch.as_tensor(np.asarray(X) if not isinstance(X, Tensor) else X)
    if X.dtype != torch.float32:
        X = X.to(torch.float32)
    return X


def _dense_col_stats(X: Tensor):
    n = X.shape[0]
    mean = torch.mean(X, dim=0)
    var = torch.sum((X - mean) ** 2, dim=0) / max(n - 1, 1)
    return (
        mean,
        var,
        torch.sum(X != 0, dim=0),
        torch.amax(X, dim=0),
        torch.amin(X, dim=0),
        torch.sum(torch.abs(X), dim=0),
        torch.sqrt(torch.sum(X * X, dim=0)),
    )


def _csr_col_stats(X: Tensor):
    """The same statistics of a CSR X without densifying.  Implicit zeros
    count in mean, variance, min and max as the reference's summarizer
    counts them (a column whose stored values are all positive still has
    min 0 when a row lacks an entry)."""
    n, d = X.shape
    cols = X.col_indices().to(torch.int64)
    vals = X.values().to(torch.float32)
    dev = vals.device

    def col_sum(v):
        return torch.zeros((d,), dtype=v.dtype, device=dev).index_add_(
            0, cols, v)

    s1 = col_sum(vals)
    s2 = col_sum(vals * vals)
    l1 = col_sum(torch.abs(vals))
    nnz = torch.bincount(cols[vals != 0], minlength=d)
    stored = torch.bincount(cols, minlength=d)
    big = float(torch.finfo(torch.float32).max)
    mx = torch.full((d,), -big, device=dev).scatter_reduce(
        0, cols, vals, reduce="amax")
    mn = torch.full((d,), big, device=dev).scatter_reduce(
        0, cols, vals, reduce="amin")
    has_zero = stored < n
    mx = torch.where(has_zero, torch.clamp(mx, min=0.0), mx)
    mn = torch.where(has_zero, torch.clamp(mn, max=0.0), mn)
    mean = s1 / n
    var = torch.clamp((s2 - n * mean * mean) / max(n - 1, 1), min=0.0)
    return mean, var, nnz, mx, mn, l1, torch.sqrt(s2)


def _checked(X) -> Tensor:
    X = _as_matrix(X)
    if X.dim() != 2:
        raise ValueError(f"expected a 2-D matrix, got {tuple(X.shape)}")
    if X.shape[0] == 0:
        raise ValueError("empty input")
    return X


def column_mean_variance(X):
    """``(mean, sample variance)`` per column, dense or sparse, as f32
    tensors on X's device (the CPU for a numpy array): the summarizer
    that ``StandardScaler.fit`` and :func:`col_stats` share."""
    X = _checked(X)
    stats = _csr_col_stats(X) if is_sparse(X) else _dense_col_stats(X)
    return stats[0], stats[1]


def col_stats(X) -> MultivariateStatisticalSummary:
    """[U] ``Statistics.colStats(rdd)`` over a dense or sparse matrix."""
    X = _checked(X)
    parts = _csr_col_stats(X) if is_sparse(X) else _dense_col_stats(X)
    return MultivariateStatisticalSummary(parts[0], parts[1], X.shape[0],
                                          *parts[2:])


def _corr_from_cov(cov: Tensor) -> Tensor:
    sd = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    denom = torch.outer(sd, sd)
    corr = torch.where(denom > 0, cov / torch.clamp(denom, min=1e-38),
                       float("nan"))
    # exact ones on the diagonal of every column with a variance
    eye = torch.eye(cov.shape[0], dtype=torch.bool, device=cov.device)
    return torch.where(eye & (sd > 0)[None, :], 1.0, corr)


def _pearson(X: Tensor) -> Tensor:
    n = X.shape[0]
    Xc = X - torch.mean(X, dim=0)
    with true_f32_matmul():
        cov = (Xc.T @ Xc) / max(n - 1, 1)
    return _corr_from_cov(cov)


def _ranks(X) -> np.ndarray:
    """Average-tie column ranks (1-based), the Spearman prerequisite
    (host-side, as in the JAX package)."""
    X = np.asarray(X, np.float64)
    n, d = X.shape
    out = np.empty_like(X)
    for j in range(d):
        col = X[:, j]
        order = np.argsort(col, kind="stable")
        ranks = np.empty(n, np.float64)
        ranks[order] = np.arange(1, n + 1, dtype=np.float64)
        uniq, inv, counts = np.unique(
            col, return_inverse=True, return_counts=True
        )
        sums = np.zeros(uniq.size, np.float64)
        np.add.at(sums, inv, ranks)
        out[:, j] = sums[inv] / counts[inv]
    return out


def _csr_gram(Xt: Tensor) -> Tensor:
    """The raw Gram ``Xᵀ X`` of a CSR X, from its transposed copy ``Xt``
    (``(d, n)``), as a dense ``(d, d)`` float32 matrix: X's columns in
    blocks of at most ``CSR_MAX_COLUMNS``, each block densified
    (``(n, block)``, from the rows of ``Xt`` that hold its columns) as the
    right-hand side of one ``cuda_kernels.csr_grad_sum`` over ``Xt``: the
    CSR kernel on the card, a fixed order of additions, so the Gram
    repeats bitwise; its plain twin on the CPU."""
    from tpu_sgd_torch.ops import cuda_kernels

    d, n = Xt.shape
    crow = Xt.crow_indices().cpu()
    rows, vals = Xt.col_indices().long(), Xt.values()
    feature = torch.repeat_interleave(
        torch.arange(d, device=vals.device), torch.diff(Xt.crow_indices()),
        output_size=vals.numel())
    G = torch.empty((d, d), dtype=torch.float32, device=vals.device)
    step = cuda_kernels.CSR_MAX_COLUMNS
    for j0 in range(0, d, step):
        j1 = min(d, j0 + step)
        lo, hi = int(crow[j0]), int(crow[j1])
        block = torch.zeros((n, j1 - j0), dtype=torch.float32,
                            device=vals.device)
        block.index_put_((rows[lo:hi], feature[lo:hi] - j0), vals[lo:hi],
                         accumulate=True)
        G[:, j0:j1] = cuda_kernels.csr_grad_sum(Xt, block)
    return G


def _pearson_csr(X: Tensor) -> Tensor:
    """Pearson of a CSR X: the raw Gram by column blocks through the CSR
    kernel (:func:`_csr_gram`; only ``(n, block)`` and the ``(d, d)``
    result go dense) and the column means as one more product of the
    kernel (``Xᵀ 1 / n``), so the result repeats bitwise on the card;
    centering folded in as ``cov = (G - n * outer(mean, mean)) / (n - 1)``."""
    from tpu_sgd_torch.ops import cuda_kernels

    n, d = X.shape
    Xt = transpose_csr(X.to(torch.float32))
    G = _csr_gram(Xt)
    mean = cuda_kernels.csr_grad_sum(
        Xt, torch.ones((n,), dtype=torch.float32, device=G.device)) / n
    cov = (G - n * torch.outer(mean, mean)) / max(n - 1, 1)
    return _corr_from_cov(cov)


def corr(X, method: str = "pearson") -> np.ndarray:
    """[U] ``Statistics.corr(rdd, method)``: the full correlation matrix as
    host numpy.  ``spearman`` ranks columns host-side (average ties) and
    reuses the Pearson pass; over sparse features it would densify
    through the rank transform, so it raises instead."""
    if method not in ("pearson", "spearman"):
        raise ValueError(f"unknown correlation method {method!r}")
    if is_sparse(X):
        if method == "spearman":
            raise ValueError(
                "spearman over sparse features requires the dense rank "
                "transform; pass X.to_dense() explicitly if n x d fits"
            )
        return _pearson_csr(to_csr(X)).cpu().numpy()
    X = _as_matrix(X)
    if X.dim() != 2:
        raise ValueError(f"corr expects a 2-D matrix, got {tuple(X.shape)}")
    if method == "spearman":
        X = torch.as_tensor(_ranks(X.cpu().numpy()), dtype=torch.float32,
                            device=X.device)
    return _pearson(X).cpu().numpy()
