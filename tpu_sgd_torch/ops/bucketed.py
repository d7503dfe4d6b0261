"""Shape-bucketed dense scoring: the port of ``tpu_sgd/ops/bucketed.py``.

The models (``GeneralizedLinearModel.predict_margin`` / ``predict``,
``MultinomialLogisticRegressionModel.predict_dense_bucketed``) and the
serving engines (``serve/engine.py``, ``tenant/engine.py``) score dense
batches through the functions below, so a serving endpoint's coalesced
batches are bitwise what ``model.predict`` gives on the same rows: both
run the same torch ops at the same padded shape.

Why buckets, in PyTorch: the JAX package pads row counts to a fixed set of
buckets so that XLA compiles one program per bucket.  PyTorch runs eagerly
and compiles nothing, but a library product may tile a batch differently
at each shape, so two shapes of the same rows can disagree in the last
bit.  The buckets keep the exactness contract: every batch of 1 to
``buckets[-1]`` rows is padded ON THE HOST to its bucket (zero rows;
each output row depends only on its own input row), copied to the device
in one copy and scored at the bucket's shape.  The result stays on the
device, sliced to the real rows: the caller decides where it goes (the
serving engines fetch it to the host in one copy, the request/response
sync; ``model.predict`` returns it where the weights lie).  The shape
keys (``program_cache_size``) count the distinct padded shapes scored,
the counterpart of the JAX package's compiled programs: after warm-up no
request size adds one.  An empty batch, or one beyond the largest
bucket (training-scale scoring), runs once at its natural shape through
the models' plain product (``ops.gradients.f32_product``, by row
chunks), on the device as well.

The products: ``X @ w`` / ``X @ W`` (``torch.matmul``: the JAX package
leaves this matvec to XLA outside any Pallas kernel), the mixed-tenant
gathered dot ``(X * W[slots]).sum(-1)`` and the multi-model ``X @ Wᵀ``.
X is promoted to float32 first (bf16 or int rows, as ``f32_product``
does); no product returns bf16.  Every op runs on the current stream of
the weights' device, under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

#: default row-count buckets — spaced ~4x so padding waste is bounded by
#: the bucket ratio
DEFAULT_BUCKETS = (1, 8, 32, 128, 512)

#: padded margin shapes scored so far, as keys
#: (rows, d, x-dtype, w-ndim, w-cols, w-dtype, activation)
_MATVEC_SHAPES: set = set()

#: padded multi-tenant slab shapes scored so far (tenant/), as keys
#: (mode, rows, d, capacity, x-dtype, slab-dtype, activation) — the slab
#: CAPACITY is a key root, the number of tenants RESIDENT is not: a slab
#: serves 1 or 10k tenants at the same shapes
_SLAB_SHAPES: set = set()

#: memo-key declaration (tpu_sgd_torch/analysis): the shape-key sets are
#: the port's count of the JAX package's bucket programs; a key is all a
#: set holds, so the rule checks that each key's roots are declared
GRAFTLINT_MEMO = {
    "_MATVEC_SHAPES": ("X", "buckets", "w", "activation"),
    "_SLAB_SHAPES": ("X", "buckets", "slab", "activation"),
}


def program_cache_size() -> int:
    """Distinct padded margin shapes scored (the JAX package's count of
    compiled bucket programs)."""
    return len(_MATVEC_SHAPES)


def slab_program_cache_size() -> int:
    return len(_SLAB_SHAPES)


def bucket_for(n: int, buckets: Tuple[int, ...] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket holding ``n`` rows (``n`` beyond the largest bucket
    runs at its natural shape, so the reported padded size is the max
    bucket only nominally)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def dense_rows(X):
    """A dense batch as a tensor where it lies (numpy on the host, a
    tensor on its device), without a copy where none is needed."""
    if isinstance(X, torch.Tensor):
        return X
    X = np.asarray(X)
    if not X.flags.c_contiguous:
        X = np.ascontiguousarray(X)
    elif not X.flags.writeable:  # torch cannot wrap a read-only buffer
        X = X.copy()
    return torch.from_numpy(X)


def _padded(X: torch.Tensor, rows: int, dev: torch.device) -> torch.Tensor:
    """``X`` with zero rows appended up to ``rows``, on ``dev``: padded
    where it lies (on the host for host rows), then one copy."""
    n = X.shape[0]
    if rows != n:
        Xp = torch.zeros((rows,) + tuple(X.shape[1:]), dtype=X.dtype,
                         device=X.device)
        Xp[:n] = X
        X = Xp
    return X.to(dev)


def fetch(out: torch.Tensor) -> np.ndarray:
    """A batch's device result as a host numpy array: one copy, the
    request/response sync of a batch (the serving engines' only fetch)."""
    return np.atleast_1d(out.cpu().numpy())


def _activate(out: torch.Tensor, activation: Optional[str]):
    return torch.sigmoid(out) if activation == "sigmoid" else out


def plain_margins(X, w: torch.Tensor, intercept: float = 0.0):
    """``X @ w + intercept`` at X's natural shape on w's device, through
    the prediction product (``f32_product``: X promoted to f32, by row
    chunks): the route of every batch beyond the largest bucket, shared
    by the models and the engines so that both sides run one function."""
    from tpu_sgd_torch.ops.gradients import f32_product

    return f32_product(dense_rows(X).to(w.device), w) + float(intercept)


def bucketed_matvec(X, w: torch.Tensor, intercept: float = 0.0,
                    buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                    activation: Optional[str] = None) -> torch.Tensor:
    """Canonical dense score: ``X @ w + intercept`` (then the sigmoid when
    ``activation="sigmoid"``) with the row count padded to a bucket, on
    ``w``'s device, returned there sliced back to ``len(X)``.  ``w`` is a
    tensor: a ``(d,)`` vector (GLM margin) or a ``(d, K)`` matrix
    (multinomial per-class margins)."""
    Xt = dense_rows(X)
    n = int(Xt.shape[0])
    with torch.no_grad():
        if n == 0 or Xt.dim() != 2 or n > buckets[-1]:
            # degenerate shapes and training-scale scoring: one pass at
            # the natural shape
            return _activate(plain_margins(Xt, w, intercept), activation)
        rows = bucket_for(n, buckets)
        key = (rows, int(Xt.shape[1]), str(Xt.dtype), int(w.dim()),
               int(w.shape[1]) if w.dim() == 2 else 0, str(w.dtype),
               activation)
        _MATVEC_SHAPES.add(key)
        Xd = _padded(Xt, rows, w.device)
        out = Xd.to(torch.float32) @ w + float(intercept)
        return _activate(out, activation)[:n]


def _gather_scores(Xd, sd, slab, intercepts, activation):
    out = (Xd.to(torch.float32) * slab[sd]).sum(-1) + intercepts[sd]
    return _activate(out, activation)


def bucketed_gather_matvec(X, slots, slab: torch.Tensor,
                           intercepts: torch.Tensor,
                           buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                           activation: Optional[str] = None
                           ) -> torch.Tensor:
    """Mixed-tenant margin: row ``r`` of ``X`` scores against slab row
    ``slots[r]`` — ``(X * slab[slots]).sum(-1) + b[slots]`` with the row
    count (and the slot vector, padded with slot 0) padded to a bucket,
    on the slab's device, sliced back to ``len(X)``.  The slab and the
    slots are data, so neither a tenant hot swap nor a novel tenant mix
    adds a shape key; only a new (bucket, width, capacity) does.  X and
    the slot vector are the batch's two host-to-device copies.

    NOT bitwise-comparable to :func:`bucketed_matvec` on a uniform batch:
    the per-row dot is another reduction than the library matvec's.  A
    caller that needs the single-model bitwise contract (tenant/: the
    M=1 / uniform-tenant case) routes those batches through
    :func:`bucketed_matvec` on the tenant's weight row instead."""
    Xt = dense_rows(X)
    st = torch.from_numpy(np.asarray(slots, np.int64).reshape(-1))
    n = int(Xt.shape[0])
    dev = slab.device
    with torch.no_grad():
        if n == 0 or Xt.dim() != 2 or n > buckets[-1]:
            return _gather_scores(Xt.to(dev), st.to(dev), slab, intercepts,
                                  activation)
        rows = bucket_for(n, buckets)
        key = ("gather", rows, int(Xt.shape[1]), int(slab.shape[0]),
               str(Xt.dtype), str(slab.dtype), activation)
        _SLAB_SHAPES.add(key)
        return _gather_scores(_padded(Xt, rows, dev), _padded(st, rows, dev),
                              slab, intercepts, activation)[:n]


def bucketed_multi_matvec(X, slab: torch.Tensor, intercepts: torch.Tensor,
                          buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                          activation: Optional[str] = None) -> torch.Tensor:
    """Multi-model batch: every row of ``X`` scores against EVERY slab
    row — ``X @ slabᵀ + b``, a ``(len(X), capacity)`` score matrix on the
    slab's device, columns selected by the caller (the shadow/canary
    case of the tenant slab: M = registry versions)."""
    Xt = dense_rows(X)
    n = int(Xt.shape[0])
    dev = slab.device
    with torch.no_grad():
        if n == 0 or Xt.dim() != 2 or n > buckets[-1]:
            Xd = Xt.to(dev)
        else:
            rows = bucket_for(n, buckets)
            key = ("all", rows, int(Xt.shape[1]), int(slab.shape[0]),
                   str(Xt.dtype), str(slab.dtype), activation)
            _SLAB_SHAPES.add(key)
            Xd = _padded(Xt, rows, dev)
        out = Xd.to(torch.float32) @ slab.T + intercepts
        return _activate(out, activation)[:n]
