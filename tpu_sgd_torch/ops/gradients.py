"""Loss gradients for generalized linear models: the port of
``tpu_sgd/ops/gradients.py`` (dense, vector-weight part).

Every linear-model gradient factors as

    margins   = X @ w
    coeff, l  = pointwise(margins, y)
    grad_sum  = coeff @ X          (masked rows contribute nothing)
    loss_sum  = sum(l)

so each subclass supplies only ``pointwise``.  For the three built-in
families ``batch_sums`` and ``window_sums`` go to the hand-written CUDA
kernel when dense data lies on a CUDA device (``ops/cuda_kernels.py``),
and to its plain PyTorch version when it lies on the CPU.  A subclass with
a rule of its own (``family = None``) always takes the plain version.

Sparse features (any non-strided layout, ``ops/sparse.py``) take neither:
as in the JAX package, where BCOO products lower to gather and segment-sum
and never reach a Pallas kernel, both products are torch CSR x vector
products at the accumulation dtype, on the CPU or the card alike.

Not ported yet: ``MultinomialLogisticGradient``, ``loss_sweep`` and
``ChunkedGradient`` (ROADMAP A1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr

Tensor = torch.Tensor


def matmul_dtype(X: Tensor) -> torch.dtype:
    """The mixed-precision contract: products run in the data's dtype
    (bf16 data keeps bf16 operands), int/bool features compute in f32."""
    return X.dtype if X.dtype.is_floating_point else torch.float32


def acc_dtype(mm_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype paired with :func:`matmul_dtype`: at least f32,
    and f64 for f64 data."""
    return torch.promote_types(mm_dtype, torch.float32)


def margins_of(X: Tensor, weights: Tensor) -> Tensor:
    """``X @ w`` with ``w`` rounded to X's dtype and an f32 (or wider)
    result.  A torch bf16 matmul would return bf16, so the operands are
    upcast instead: a product of two bf16 values is exact in f32, so this
    is the JAX package's ``preferred_element_type=f32`` contract.

    Sparse ``X`` computes at the accumulation dtype, as the JAX package
    does for BCOO: int one-hot values promote instead of truncating
    ``w``."""
    mm = matmul_dtype(X)
    acc = acc_dtype(mm)
    if is_sparse(X):
        return to_csr(X).to(acc) @ weights.to(acc)
    return X.to(acc) @ weights.to(mm).to(acc)


def grad_sum_of(coeff: Tensor, X: Tensor, Xt: Optional[Tensor] = None
                ) -> Tensor:
    """``coeff @ X`` (== ``X.T @ coeff``) with ``coeff`` rounded to X's
    dtype and f32 accumulation, as :func:`margins_of`.  For sparse ``X``
    it is ``Xt @ coeff`` at the accumulation dtype, ``Xt`` the transposed
    CSR (:func:`~tpu_sgd_torch.ops.sparse.transpose_csr`, built here when
    the caller holds none)."""
    mm = matmul_dtype(X)
    acc = acc_dtype(mm)
    if is_sparse(X):
        if Xt is None:
            Xt = transpose_csr(to_csr(X))
        return Xt.to(acc) @ coeff.to(acc)
    return coeff.to(mm).to(acc) @ X.to(acc)


def _no_feature_sharding(margin_axis_name) -> None:
    if margin_axis_name is not None:
        raise NotImplementedError(
            "feature-axis sharding (margin_axis_name) is not ported yet "
            "(ROADMAP A5)"
        )


def sparse_batch_sums(pointwise, X, y, weights, mask=None, Xt=None):
    """``(grad_sum, loss_sum, count)`` of sparse ``X``: the JAX
    ``Gradient.batch_sums`` arithmetic with CSR products; a ``mask`` zeroes
    the coefficients and losses of the rows it drops."""
    margins = margins_of(X, weights)
    coeff, losses = pointwise(margins, y.to(margins.dtype))
    if mask is not None:
        m = mask.to(margins.dtype)
        coeff = coeff * m
        losses = losses * m
        count = torch.sum(m)
    else:
        count = torch.tensor(float(X.shape[0]), dtype=margins.dtype,
                             device=margins.device)
    return grad_sum_of(coeff, X, Xt), torch.sum(losses), count


class Gradient:
    """Loss-specific plugin: the ``Gradient`` axis of the optimizer
    boundary.  Subclasses implement :meth:`pointwise`; ``family`` names
    the CUDA kernel's compile-time rule for it (``None``: no kernel)."""

    family: Optional[str] = None

    def pointwise(self, margin: Tensor, label: Tensor) -> Tuple[Tensor, Tensor]:
        """Elementwise rule: ``(dloss/dmargin, loss)`` given ``margin = x.w``."""
        raise NotImplementedError

    def weight_dim(self, num_features: int) -> int:
        """Length of the flat weight vector for ``num_features`` inputs."""
        return num_features

    def compute(self, data: Tensor, label, weights: Tensor):
        """Single-example ``(gradient, loss)`` — Spark contract parity."""
        margin = torch.dot(data, weights)
        coeff, loss = self.pointwise(margin, torch.as_tensor(
            label, dtype=margin.dtype, device=margin.device))
        return coeff * data, loss

    def batch_sums(
        self,
        X: Tensor,
        y: Tensor,
        weights: Tensor,
        mask: Optional[Tensor] = None,
        margin_axis_name: Optional[str] = None,
        Xt: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """Fused mini-batch ``(grad_sum, loss_sum, count)``, unnormalized;
        ``mask`` (bool, one entry per row) is the Bernoulli sample.
        ``Xt``: for sparse ``X``, its transposed CSR when the caller
        already holds it (the optimizer builds it once per dataset)."""
        from tpu_sgd_torch.ops import cuda_kernels

        _no_feature_sharding(margin_axis_name)
        if is_sparse(X):
            return sparse_batch_sums(self.pointwise, X, y, weights, mask, Xt)
        if self.family is None:
            return cuda_kernels.fused_gradient_sums_plain(
                self.pointwise, X, y, weights, mask)
        return cuda_kernels.fused_gradient_sums(
            self.pointwise, X, y, weights, mask)

    def window_sums(
        self,
        X: Tensor,
        y: Tensor,
        weights: Tensor,
        start,
        m: int,
        valid: Optional[Tensor] = None,
        margin_axis_name: Optional[str] = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """Sums over the row window ``[start, start + m)``, placed as
        ``lax.dynamic_slice`` places it (see :func:`_clamp_start`).

        ``start`` may stay a device tensor: the window kernel reads it
        through a pointer, so the sliced sampler never syncs the host.
        (A rule without a kernel slices on the host and reads ``start``.)
        """
        from tpu_sgd_torch.ops import cuda_kernels

        if is_sparse(X):
            raise NotImplementedError(
                "sliced sampling needs a dense row layout; use bernoulli "
                "sampling with sparse features"
            )
        _no_feature_sharding(margin_axis_name)
        if self.family is None:
            Xb, yb, mask = _slice_window(X, y, valid, start, m)
            return self.batch_sums(Xb, yb, weights, mask)
        # tile_m=1: the window kernel then starts at any row, which is
        # exactly this method's semantics (no tile flooring)
        return cuda_kernels.fused_window_sums(
            self.pointwise, X, y, weights, start, m, tile_m=1, valid=valid)


def _clamp_start(start: int, n: int, m: int) -> int:
    """Where ``lax.dynamic_slice_in_dim`` starts a length-``m`` window of
    ``n`` rows: a negative start counts from the end, then the start is
    clamped into ``[0, n - m]`` (the kernel does the same on the device)."""
    if start < 0:
        start += n
    return min(max(start, 0), max(n - m, 0))


def _slice_window(X, y, valid, start, m):
    """A length-``m`` row window placed as ``lax.dynamic_slice_in_dim``
    places it; ``start`` is read on the host."""
    s = _clamp_start(int(start), X.shape[0], m)
    mask = None if valid is None else valid[s:s + m]
    return X[s:s + m], y[s:s + m], mask


class LeastSquaresGradient(Gradient):
    """Squared loss for linear regression: ``L = (x.w - y)^2 / 2``."""

    family = "least_squares"

    def pointwise(self, margin, label):
        diff = margin - label
        return diff, 0.5 * diff * diff


class LogisticGradient(Gradient):
    """Binary log-loss with labels in {0, 1}, numerically stable:
    ``softplus(-m) = max(-m, 0) + log1p(exp(-|m|))``."""

    family = "logistic"

    def pointwise(self, margin, label):
        neg_margin = -margin
        multiplier = torch.sigmoid(margin) - label
        softplus = torch.clamp(neg_margin, min=0.0) + torch.log1p(
            torch.exp(-torch.abs(neg_margin))
        )
        loss = torch.where(label > 0, softplus, softplus - neg_margin)
        return multiplier, loss


class HingeGradient(Gradient):
    """Hinge loss for linear SVM with labels in {0, 1} mapped to {-1, +1}."""

    family = "hinge"

    def pointwise(self, margin, label):
        scaled = 2.0 * label - 1.0
        slack = 1.0 - scaled * margin
        active = slack > 0
        zero = torch.zeros((), dtype=slack.dtype, device=slack.device)
        coeff = torch.where(active, -scaled, zero)
        loss = torch.where(active, slack, zero)
        return coeff, loss
