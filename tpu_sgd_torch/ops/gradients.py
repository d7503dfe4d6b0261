"""Loss gradients for generalized linear models: the port of
``tpu_sgd/ops/gradients.py``.

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

Sparse features (any non-strided layout, ``ops/sparse.py``) take neither
fused kernel: as in the JAX package, where BCOO products lower to gather
and segment-sum and never reach a Pallas kernel, the margins and the
gradient are two CSR products.  On the card both go to the deterministic
CSR kernel (``cuda_kernels.csr_margins`` / ``csr_grad_sum``, shape rule:
CSR with float32 values and int32 or int64 indices, a right-hand side of 1
to ``CSR_MAX_COLUMNS`` columns; anything else raises), on the CPU to its
plain twin, torch's CSR product at the accumulation dtype.

Matrix weights (the line search's ``(T, d)`` stack of trial points, the
multinomial ``(K-1, d)`` class rows) take ``torch.matmul``, as the JAX
package left them to XLA, and dense passes over X go by row chunks
(:func:`row_chunks`): a bf16 X is never copied whole to f32, and the
per-row intermediates stay within ``SWEEP_BUDGET_ELEMS``.  On a CUDA
device a bf16 product runs with an f32 output (:func:`mm_acc`).

:class:`ChunkedGradient` walks a sliced window in fixed-size row blocks,
one window-kernel launch per block on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr

Tensor = torch.Tensor

#: element budget of one dense row chunk: the f32 per-row intermediates of
#: a sweep or a multinomial pass (``(rows, T, K)`` logits), plus the f32
#: copy of the chunk where X is upcast (~256 MB f32)
SWEEP_BUDGET_ELEMS = 64_000_000


def matmul_dtype(X: Tensor) -> torch.dtype:
    """The mixed-precision contract: products run in the data's dtype
    (bf16 data keeps bf16 operands), int/bool features compute in f32."""
    return X.dtype if X.dtype.is_floating_point else torch.float32


def acc_dtype(mm_dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype paired with :func:`matmul_dtype`: at least f32,
    and f64 for f64 data."""
    return torch.promote_types(mm_dtype, torch.float32)


def _upcasts(X: Tensor) -> bool:
    """Whether a dense product over ``X`` copies it to the accumulation
    dtype first (every narrow X but a bf16/f16 one on a CUDA device)."""
    mm = matmul_dtype(X)
    return mm != acc_dtype(mm) and not (X.is_cuda and mm in _F32_OUT)


_F32_OUT = (torch.bfloat16, torch.float16)


def mm_acc(A: Tensor, B: Tensor) -> Tensor:
    """``A @ B`` of two 2-D (or two batched 3-D) operands in the matmul
    dtype, with an accumulation-dtype result.  On a CUDA device a bf16 (or f16) pair goes
    to the library product with an f32 output (``torch.mm(...,
    out_dtype=)``), elsewhere both operands are upcast first; a product of
    two bf16 values is exact in f32, so both keep the JAX package's
    ``preferred_element_type=f32`` contract.  A bf16-output product never
    would."""
    acc = acc_dtype(A.dtype)
    if A.dtype == acc:
        return A @ B
    if A.is_cuda and A.dtype in _F32_OUT:
        product = torch.bmm if A.dim() == 3 else torch.mm
        return product(A, B, out_dtype=acc)
    return A.to(acc) @ B.to(acc)


def row_chunks(X: Tensor, per_row: int):
    """``(start, stop)`` row ranges of a dense ``X`` whose f32 work, at
    ``per_row`` intermediate elements a row plus the upcast copy of the
    chunk where there is one, stays within ``SWEEP_BUDGET_ELEMS`` (one
    range at test sizes, and for sparse X, whose products need no
    chunks)."""
    n = X.shape[0]
    if is_sparse(X):
        return [(0, n)]
    width = per_row + (X.shape[1] if _upcasts(X) else 0)
    rows = max(1, SWEEP_BUDGET_ELEMS // max(width, 1))
    return [(s, min(n, s + rows)) for s in range(0, max(n, 1), rows)]


def margins_of(X: Tensor, weights: Tensor,
               mask: Optional[Tensor] = None) -> Tensor:
    """``X @ w`` (or ``X @ Wᵀ`` for matrix trial or class weights) with
    the weights rounded to X's dtype and an f32 (or wider) result.  A
    vector ``w`` upcasts both operands (a torch bf16 matmul would return
    bf16; a product of two bf16 values is exact in f32, so this is the
    JAX package's ``preferred_element_type=f32`` contract); matrix
    weights go through :func:`mm_acc`.  Callers pass row chunks of a
    large dense X.

    Sparse ``X`` computes at the accumulation dtype, as the JAX package
    does for BCOO: int one-hot values promote instead of truncating
    ``w``.  It goes to ``cuda_kernels.csr_margins``: the CSR kernel on the
    card, its plain twin on the CPU; ``mask`` (sparse X only) sets the
    margins of the rows it drops to 0, and the kernel never reads them."""
    mm = matmul_dtype(X)
    acc = acc_dtype(mm)
    if is_sparse(X):
        from tpu_sgd_torch.ops import cuda_kernels

        rhs = weights.T.contiguous() if weights.dim() == 2 else weights
        return cuda_kernels.csr_margins(to_csr(X), rhs, mask)
    if mask is not None:
        raise ValueError("margins_of takes a row mask for sparse X only")
    if weights.dim() == 2:
        # computed as W @ Xᵀ and returned transposed: the (T, rows) product
        # has aligned rows whatever T is; X @ Wᵀ with T = 25 or 225 ran
        # 2.3x and 4.3x slower for its misaligned rows
        # (scripts/probe_f32_products.py, H100 80GB HBM3 at 700 W)
        return mm_acc(weights.to(mm), X.to(mm).T).T
    return X.to(acc) @ weights.to(mm).to(acc)


def grad_sum_of(coeff: Tensor, X: Tensor, Xt: Optional[Tensor] = None
                ) -> Tensor:
    """``coeff @ X`` (== ``X.T @ coeff``; ``coeffᵀ @ X``, shape ``(K-1,
    d)``, for a 2-D ``coeff``) with ``coeff`` rounded to X's dtype and f32
    accumulation, as :func:`margins_of`.  For sparse ``X`` it is ``Xt @
    coeff`` at the accumulation dtype, ``Xt`` the transposed CSR
    (:func:`~tpu_sgd_torch.ops.sparse.transpose_csr`, built here when the
    caller holds none), through ``cuda_kernels.csr_grad_sum`` (the CSR
    kernel on the card, its plain twin on the CPU)."""
    mm = matmul_dtype(X)
    acc = acc_dtype(mm)
    if is_sparse(X):
        from tpu_sgd_torch.ops import cuda_kernels

        if Xt is None:
            Xt = transpose_csr(to_csr(X))
        out = cuda_kernels.csr_grad_sum(Xt, coeff.contiguous())
        return out.T if coeff.dim() == 2 else out
    if coeff.dim() == 2:
        return mm_acc(coeff.T.to(mm), X.to(mm))
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
    margins = margins_of(X, weights, mask)
    coeff, losses = pointwise(margins, y.to(margins.dtype))
    if mask is not None:
        m = mask.to(margins.dtype)
        coeff = coeff * m
        losses = losses * m
        count = torch.sum(m)
    else:
        # a fill, not a tensor from a host value: that would copy it
        # from pageable memory, which a CUDA graph capture forbids
        count = torch.full((), float(X.shape[0]), dtype=margins.dtype,
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

    def loss_sweep(
        self,
        X: Tensor,
        y: Tensor,
        W: Tensor,
        mask: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Unnormalized ``(loss_sums (T,), count)`` of ``T`` stacked flat
        trial weight vectors ``W``: the whole line-search ladder in one
        pass over X (``margins = X @ Wᵀ``, one matmul per row chunk)
        instead of ``T`` matvecs and ``T`` host syncs.  No host sync."""
        acc = acc_dtype(matmul_dtype(X))
        sums = torch.zeros((W.shape[0],), dtype=acc, device=W.device)
        for s, e in row_chunks(X, W.shape[0]):
            Xc = X if is_sparse(X) else X[s:e]
            margins = margins_of(Xc, W)  # (rows, T)
            _, losses = self.pointwise(margins,
                                       y[s:e].to(margins.dtype)[:, None])
            if mask is not None:
                losses = losses * mask[s:e].to(losses.dtype)[:, None]
            sums = sums + torch.sum(losses, dim=0)
        return sums, _count(X, mask, acc)

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


def _count(X, mask, dtype) -> Tensor:
    """The row count of a batch: the mask's sum, or all rows."""
    if mask is not None:
        return torch.sum(mask.to(dtype))
    return torch.full((), float(X.shape[0]), dtype=dtype, device=X.device)


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


class ChunkedGradient(Gradient):
    """The window of ``sampling="sliced"`` as consecutive ``chunk_rows``-row
    blocks plus a remainder, behind the same ``Gradient`` contract: the
    port of the JAX package's one-read window schedule.

    On the card each block is one launch of the window kernel at a
    device-resident start (``base.window_sums``, ``tile_m=1``): the start
    is clamped once, on the device, and each block starts ``chunk_rows``
    rows after the previous one, so nothing syncs the host.  On the CPU the
    blocks take the plain path.  The sums accumulate at the accumulation
    dtype.  Wraps the built-in families; delegates everything but the
    window schedule."""

    def __init__(self, base: Gradient, chunk_rows: int = 65536):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.base = base
        self.chunk_rows = int(chunk_rows)

    @property
    def family(self):
        return self.base.family

    def pointwise(self, margin, label):
        return self.base.pointwise(margin, label)

    def weight_dim(self, num_features: int) -> int:
        return self.base.weight_dim(num_features)

    def compute(self, data, label, weights):
        return self.base.compute(data, label, weights)

    def batch_sums(self, X, y, weights, mask=None, margin_axis_name=None,
                   Xt=None):
        return self.base.batch_sums(X, y, weights, mask,
                                    margin_axis_name=margin_axis_name, Xt=Xt)

    def loss_sweep(self, X, y, W, mask=None):
        return self.base.loss_sweep(X, y, W, mask)

    def window_sums(self, X, y, weights, start, m, valid=None,
                    margin_axis_name=None):
        from tpu_sgd_torch.ops.cuda_kernels import _start_tensor

        if is_sparse(X):
            raise NotImplementedError(
                "sliced sampling needs a dense row layout; use bernoulli "
                "sampling with sparse features"
            )
        _no_feature_sharding(margin_axis_name)
        c = min(self.chunk_rows, m)
        nblk, rem = divmod(m, c)
        # clamp ONCE, like the stock path's whole window: per-block
        # clamping would re-read overlapping tail rows for an out-of-range
        # start and diverge from the base implementation
        start = torch.clamp(_start_tensor(start, X.device), 0,
                            max(X.shape[0] - m, 0))
        cd = acc_dtype(matmul_dtype(X))
        g = torch.zeros(weights.shape, dtype=cd, device=weights.device)
        ls = torch.zeros((), dtype=cd, device=weights.device)
        cnt = torch.zeros((), dtype=cd, device=weights.device)
        blocks = [(i * c, c) for i in range(nblk)]
        if rem:
            blocks.append((nblk * c, rem))
        for offset, rows in blocks:
            gb, lb, cb = self.base.window_sums(X, y, weights, start + offset,
                                               rows, valid=valid)
            g, ls, cnt = g + gb.to(cd), ls + lb.to(cd), cnt + cb.to(cd)
        return g, ls, cnt


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


class MultinomialLogisticGradient:
    """K-class logistic gradient over flat ``(K-1)*D`` weights: class 0
    is the pivot with an implicit zero logit, and the loss is the softmax
    negative log-likelihood (the reference's multinomial branch of
    ``LogisticGradient``).  It has no CUDA kernel (``family = None``):
    both products are matmuls (:func:`mm_acc`) over row chunks of a dense
    X, or CSR products, as the JAX package leaves them to XLA.  It works
    under ``GradientDescent`` and the quasi-Newton optimizers alike."""

    family = None

    def __init__(self, num_classes: int):
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = num_classes

    def weight_dim(self, num_features: int) -> int:
        return (self.num_classes - 1) * num_features

    def _log_probs(self, margins_t):
        """Class-major ``(..., K, rows)`` log-softmax of the ``(..., K-1,
        rows)`` margins with the pivot's zero logit in front."""
        zeros = torch.zeros(margins_t.shape[:-2] + (1, margins_t.shape[-1]),
                            dtype=margins_t.dtype, device=margins_t.device)
        return torch.log_softmax(torch.cat([zeros, margins_t], dim=-2),
                                 dim=-2)

    def batch_sums(
        self,
        X: Tensor,
        y: Tensor,
        weights: Tensor,
        mask: Optional[Tensor] = None,
        margin_axis_name: Optional[str] = None,
        Xt: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """``(grad_sum (K-1)*D, loss_sum, count)``, computed class-major:
        ``(K-1, rows)`` margins and coefficients (aligned products on the
        card, see :func:`margins_of`)."""
        _no_feature_sharding(margin_axis_name)
        K = self.num_classes
        D = X.shape[-1]
        W = weights.reshape(K - 1, D)
        acc = acc_dtype(matmul_dtype(X))
        classes = torch.arange(1, K, device=weights.device)
        grad = torch.zeros((K - 1, D), dtype=acc, device=weights.device)
        loss = torch.zeros((), dtype=acc, device=weights.device)
        sparse = is_sparse(X)
        for s, e in row_chunks(X, K):
            Xc = X if sparse else X[s:e]
            log_probs = self._log_probs(margins_of(Xc, W).T)  # (K, rows)
            y_int = y[s:e].to(torch.int64)
            losses = -torch.gather(log_probs, 0, y_int[None, :])[0]
            # one_hot(y - 1, K - 1): the pivot's column is all zeros
            onehot = (classes[:, None] == y_int[None, :]).to(log_probs.dtype)
            coeff = torch.exp(log_probs[1:]) - onehot  # (K-1, rows)
            if mask is not None:
                m = mask[s:e].to(log_probs.dtype)
                coeff = coeff * m[None, :]
                losses = losses * m
            grad = grad + grad_sum_of(coeff.T, Xc, Xt if sparse else None)
            loss = loss + torch.sum(losses)
        return grad.reshape(-1), loss, _count(X, mask, acc)

    def loss_sweep(
        self,
        X: Tensor,
        y: Tensor,
        W: Tensor,
        mask: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor]:
        """Line-search sweep over stacked flat ``(K-1)*D`` trial weights:
        one ``(T·(K-1), D) @ Xᵀ`` matmul per row chunk, so X is read once
        for the whole ladder.  The JAX package chunks over trials instead
        (one read of X per trial chunk); both bound the ``(T, K, rows)``
        logits by ``SWEEP_BUDGET_ELEMS`` and agree up to summation
        order."""
        T = W.shape[0]
        K = self.num_classes
        D = X.shape[-1]
        acc = acc_dtype(matmul_dtype(X))
        Wf = W.reshape(T * (K - 1), D)
        sums = torch.zeros((T,), dtype=acc, device=W.device)
        sparse = is_sparse(X)
        for s, e in row_chunks(X, T * K):
            Xc = X if sparse else X[s:e]
            margins = margins_of(Xc, Wf).T.reshape(T, K - 1, e - s)
            log_probs = self._log_probs(margins)  # (T, K, rows)
            y_int = y[s:e].to(torch.int64)
            losses = -torch.gather(
                log_probs, 1, y_int[None, None, :].expand(T, 1, e - s))[:, 0]
            if mask is not None:
                losses = losses * mask[s:e].to(losses.dtype)[None, :]
            sums = sums + torch.sum(losses, dim=1)
        return sums, _count(X, mask, acc)

    # the same window contract as the vector-weight gradients
    window_sums = Gradient.window_sums

    def predict_class(self, X: Tensor, weights: Tensor) -> Tensor:
        K = self.num_classes
        W = weights.reshape(K - 1, X.shape[-1])
        return pivot_class_traced(f32_product(X, W.T))


def f32_product(X, rhs: Tensor) -> Tensor:
    """``X @ rhs`` in float32 with X promoted, as ``jnp`` promotes a bf16
    or int X against f32 weights (the weights are not rounded): the
    prediction product.  A dense X goes by row chunks, so a bf16 X is
    never copied whole to f32.  A sparse X (its values promoted to f32)
    goes to ``cuda_kernels.csr_margins``: the CSR kernel on the card, a
    fixed order of additions, so sparse predictions repeat bitwise; its
    plain twin on the CPU."""
    if is_sparse(X):
        from tpu_sgd_torch.ops import cuda_kernels

        return cuda_kernels.csr_margins(to_csr(X).to(torch.float32), rhs)
    n = X.shape[0]
    out = torch.empty((n,) + tuple(rhs.shape[1:]), dtype=torch.float32,
                      device=rhs.device)
    width = rhs.shape[1] if rhs.dim() == 2 else 1
    rows = max(1, SWEEP_BUDGET_ELEMS // (X.shape[1] + width))
    for s in range(0, n, rows):
        out[s:s + rows] = X[s:s + rows].to(torch.float32) @ rhs
    return out


def pivot_class_traced(margins: Tensor) -> Tensor:
    """Multinomial decision rule (pivot class 0 with an implicit zero
    logit): per-class margins -> predicted class as float32, on the
    margins' device.  ``torch.argmax`` returns the first maximum, as
    ``jnp.argmax`` and ``np.argmax`` do."""
    zeros = torch.zeros((margins.shape[0], 1), dtype=margins.dtype,
                        device=margins.device)
    return torch.argmax(torch.cat([zeros, margins], dim=-1),
                        dim=-1).to(torch.float32)


def pivot_class_host(margins) -> np.ndarray:
    """Host-numpy twin of :func:`pivot_class_traced`; the two agree
    exactly (first-max tie-breaking in both)."""
    margins = np.asarray(margins)
    logits = np.concatenate(
        [np.zeros((margins.shape[0], 1), margins.dtype), margins], axis=-1
    )
    return np.argmax(logits, axis=-1).astype(np.float32)
