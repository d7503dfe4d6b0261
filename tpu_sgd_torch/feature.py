"""Feature transformers: the port of ``tpu_sgd/feature.py``
(``StandardScaler`` and its model, ``Normalizer``).

``fit`` is one pass of the shared column summarizer (``stat.py``) on X's
device (the CPU for a numpy array).  ``transform`` is an elementwise
scale on the input's device; a numpy input stays numpy, and CSR features
are scaled by value, never densified.  A bf16 X becomes an f32 copy, as
the JAX package promotes it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.ops.sparse import _csr, is_sparse, row_ids, to_csr

Tensor = torch.Tensor


class StandardScalerModel:
    """Fitted column statistics and the transform rule.  ``factor`` is
    ``1/std`` where ``std`` clears the f32 noise floor of a constant
    column and ``0.0`` otherwise (the reference's convention: columns that
    carry no information are zeroed, not divided by zero)."""

    def __init__(self, mean, variance, with_mean: bool, with_std: bool):
        self.mean = torch.as_tensor(mean, dtype=torch.float32)
        self.variance = torch.as_tensor(variance, dtype=torch.float32,
                                        device=self.mean.device)
        self.with_mean = bool(with_mean)
        self.with_std = bool(with_std)
        std = torch.sqrt(self.variance)
        self.std = std
        # a constant column's f32 std is a few ulps of |mean|, not 0;
        # 8 eps * |mean| zeroes it and keeps any real variation above the
        # f32 representational limit (see the JAX module)
        eps = torch.finfo(torch.float32).eps
        noise_floor = 8.0 * eps * torch.abs(self.mean)
        self.factor = torch.where(
            std > noise_floor, 1.0 / torch.clamp(std, min=1e-38), 0.0)

    def transform(self, X):
        """Scale a feature matrix, a single vector, or (the harness's
        trick) a WEIGHT vector or matrix back into original space."""
        if is_sparse(X):
            if self.with_mean:
                # centering densifies; the reference raises here too
                raise ValueError(
                    "with_mean=True cannot be applied to sparse features "
                    "without densifying; pass dense X or with_mean=False"
                )
            if not self.with_std:
                return X
            X = to_csr(X)
            factor = self.factor.to(X.device)
            vals = X.values() * factor[X.col_indices().to(torch.int64)]
            return _csr(X.crow_indices(), X.col_indices(), vals, X.shape)
        if not isinstance(X, Tensor):
            # a host array stays on the host; int and f64 become f32
            X = np.asarray(X)
            if X.dtype == np.float64 or not np.issubdtype(X.dtype,
                                                          np.floating):
                X = X.astype(np.float32)
            if self.with_mean:
                X = X - self.mean.cpu().numpy()
            if self.with_std:
                X = X * self.factor.cpu().numpy()
            return X
        if self.with_mean:
            X = X - self.mean.to(X.device)
        if self.with_std:
            X = X * self.factor.to(X.device)
        return X


class Normalizer:
    """Row-wise p-norm normalization ([U] mllib/feature/Normalizer.scala):
    every example to unit p-norm (default p=2); zero-norm rows pass
    through unchanged.  CSR input computes row norms over its stored
    entries (implicit zeros add nothing to a p-norm) and rescales its
    values; a 1-D sparse vector is one row."""

    def __init__(self, p: float = 2.0):
        if not (p > 0 or p == float("inf")):
            raise ValueError(f"p must be in (0, inf], got {p}")
        self.p = float(p)

    def _norms_dense(self, X):
        if self.p == float("inf"):
            return torch.amax(torch.abs(X), dim=-1)
        return torch.sum(torch.abs(X) ** self.p, dim=-1) ** (1.0 / self.p)

    @staticmethod
    def _inverse(norms):
        return torch.where(norms > 0, 1.0 / torch.clamp(norms, min=1e-38),
                           1.0)

    def transform(self, X):
        if is_sparse(X):
            if X.dim() == 1:
                Xc = X.to_sparse_coo().coalesce()
                a = torch.abs(Xc.values()).to(torch.float32)
                if self.p == float("inf"):
                    norm = (torch.amax(a) if a.numel()
                            else torch.zeros((), device=a.device))
                else:
                    norm = torch.sum(a ** self.p) ** (1.0 / self.p)
                inv = self._inverse(norm).to(Xc.values().dtype)
                return torch.sparse_coo_tensor(
                    Xc.indices(), Xc.values() * inv, Xc.shape).coalesce()
            X = to_csr(X)
            n = X.shape[0]
            rows = row_ids(X).to(torch.int64)
            a = torch.abs(X.values()).to(torch.float32)
            zeros = torch.zeros((n,), dtype=torch.float32, device=a.device)
            if self.p == float("inf"):
                norms = zeros.scatter_reduce(0, rows, a, reduce="amax")
            else:
                norms = zeros.index_add(0, rows, a ** self.p) ** (1.0 / self.p)
            vals = X.values() * self._inverse(norms)[rows].to(X.values().dtype)
            return _csr(X.crow_indices(), X.col_indices(), vals, X.shape)
        X = torch.as_tensor(np.asarray(X) if not isinstance(X, Tensor) else X)
        if not X.dtype.is_floating_point:
            X = X.to(torch.float32)
        single = X.dim() == 1
        Xb = torch.atleast_2d(X)
        out = Xb * self._inverse(self._norms_dense(Xb))[:, None]
        return out[0] if single else out


class StandardScaler:
    """``fit(X) -> StandardScalerModel``.  Defaults mirror the reference:
    ``with_mean=False, with_std=True`` (unit variance, no centering, the
    only combination that keeps sparse data sparse)."""

    def __init__(self, with_mean: bool = False, with_std: bool = True):
        if not (with_mean or with_std):
            raise ValueError("at least one of with_mean/with_std must be set")
        self.with_mean = bool(with_mean)
        self.with_std = bool(with_std)

    def fit(self, X, mesh=None) -> StandardScalerModel:
        """The column statistics of ``X``; on a data ``mesh``, X is this
        rank's rows and the statistics are every rank's
        (``stat.column_mean_variance``)."""
        from tpu_sgd_torch.stat import column_mean_variance

        mean, var = column_mean_variance(X, mesh)
        return StandardScalerModel(mean, var, self.with_mean, self.with_std)
