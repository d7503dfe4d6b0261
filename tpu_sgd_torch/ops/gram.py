"""Sufficient-statistics execution of the least-squares gradient: the port
of ``tpu_sgd/ops/gram.py`` (resident statistics, one device).

For the quadratic loss the window gradient is linear in the sufficient
statistics

    grad_sum = G_w @ w - b_w          G_w = X_wᵀ X_w,  b_w = X_wᵀ y_w
    loss_sum = ½ (wᵀ G_w w - 2 bᵀ_w w + yyw)

so one pass over the data builds *block-prefix* Grams, after which any
contiguous window (``sampling="sliced"``) costs the difference of two
``(d, d)`` prefix rows, one matvec, and two masked partial-block edge
corrections, instead of two passes over the window's rows.  It is the same gradient, exact up to
float summation order.  The full-batch gradient, the L-BFGS cost and the
line-search sweep reduce to the total statistics.  Least squares only:
the other losses are nonlinear in the margins.

Memory: the prefix stack holds ``(n // block_rows + 1) · d²`` entries of
the stats dtype.  It is one preallocated tensor, written entry by entry
(``PG[k+1] = PG[k] + G_k``): stacking the block Grams and then summing them
would hold the stack twice.  At 10M × 1000 and the default block size the
stack is 4.88 GB.

Precision: window results are differences of whole-prefix accumulations,
and near convergence the loss is a difference of terms about 10⁴ times its
size (``wᵀGw``, ``bᵀw`` and ``yy`` each scale like ``|y|²``).  An f32
rounding of those terms is then a 1e-3 error in the loss, so the path goes
wider than the JAX package where that happens, in f64 (``SUM_DTYPE``):

* the build: each block's products and the running prefix sums are f64,
  and each stored entry is rounded once.  ``PG`` (and ``G_tot``) are
  stored at the stats dtype, the small ``Pb``, ``Pyy``, ``b_tot`` and
  ``yy_tot`` in f64.  A bf16 X is upcast one block at a time, never whole;
* the loss's three terms are formed and summed in f64, and the full-batch
  evaluators (which read only the ``(d, d)`` totals) run in f64.

The per-iteration window products stay at the stats dtype (f32, or f64 for
f64 data): an exact window differences its two prefix rows before its one
matvec, as an aligned window does, so the matvec works at window
magnitude.  On the card f32 products run in true f32
(:func:`~tpu_sgd_torch.device.true_f32_matmul`: no TF32).  None of this
follows the hot path's bf16 bandwidth contract (``ops/gradients.py``).
H100's f64 tensor-core rate equals its f32 rate outside the tensor cores,
so the f64 build costs no more than an f32 one would.

Nothing here syncs the host per iteration: window starts stay device
tensors, and the prefix rows and edge rows are gathered on device
indices.  Masks, ``valid``, an unbound or
different matrix, and feature sharding run the stock exact path, which on
the card is the fused kernel (``ops/cuda_kernels.py``).

Not ported yet: ``build_streamed`` and the build checkpoints, which stream
host-resident data through the ingest pipeline (ROADMAP A9).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device, true_f32_matmul
from tpu_sgd_torch.ops.cuda_kernels import _start_tensor
from tpu_sgd_torch.ops.gradients import (
    LeastSquaresGradient,
    acc_dtype,
    matmul_dtype,
)

Tensor = torch.Tensor

#: default prefix block size, shared by ``build`` and the optimizers'
#: ``set_gram_options`` default
DEFAULT_BLOCK_ROWS = 8192
#: dtype of the prefix sums' carry, of ``yy`` and of the loss's cancelling
#: terms (module docstring)
SUM_DTYPE = torch.float64


def _dot_hi(a: Tensor, b: Tensor, dtype: torch.dtype) -> Tensor:
    """Cancellation-safe product: both operands at the stats dtype.
    Callers hold :func:`true_f32_matmul`, so f32 runs without TF32."""
    return a.to(dtype) @ b.to(dtype)


def _dot_wide(a: Tensor, b: Tensor) -> Tensor:
    """A product at ``SUM_DTYPE``, for the loss's cancelling terms."""
    return _dot_hi(a, b, SUM_DTYPE)


def aligned_window_blocks(m: int, B: int, nbf: int) -> int:
    """Whole-block length of an m-row aligned window, shared by the
    per-iteration executor and the chunked driver
    (``optimize/gram_driver.py``) so their trajectories cannot drift."""
    return max(1, min(nbf, round(m / B)))


def aligned_window_k1(start: Tensor, n: int, m: int, B: int, nbf: int,
                      mb: int) -> Tensor:
    """First block of the aligned window at device row ``start``: the
    clamp-then-floor shared by both aligned drivers."""
    start = torch.clamp(start, 0, max(n - m, 0))
    return torch.clamp(torch.div(start, B, rounding_mode="floor"), 0,
                       nbf - mb)


def aligned_window_terms(PG_diff, Pb_diff, yy_diff, w_sd):
    """``(g_sum, loss_sum)`` of an aligned window from its differenced
    prefix statistics, shared by both aligned drivers: the matvec at the
    stats dtype, ``loss_sum`` at ``SUM_DTYPE`` (near convergence the loss
    is a near-zero difference of ``|y|²``-sized terms)."""
    g_sum = _dot_hi(PG_diff, w_sd, PG_diff.dtype) - Pb_diff
    w_wide = w_sd.to(SUM_DTYPE)
    loss_sum = 0.5 * (_dot_wide(w_wide, g_sum) - _dot_wide(w_wide, Pb_diff)
                      + yy_diff.to(SUM_DTYPE))
    return g_sum, loss_sum


def _running_sum(stacks, blocks):
    """Inclusive running sums with a leading zero entry, written in place:
    ``P[0] = 0`` and ``P[k+1] = P[k] + block_k`` for each of ``stacks``,
    summed in a ``SUM_DTYPE`` carry and rounded once into each entry, with
    one block's statistics live at a time (``blocks`` yields one tuple per
    block).  Returns the carries: the sums over all blocks."""
    carries = [torch.zeros(P.shape[1:], dtype=SUM_DTYPE, device=P.device)
               for P in stacks]
    for P in stacks:
        P[0].zero_()
    for k, stats in enumerate(blocks):
        for P, c, s in zip(stacks, carries, stats):
            c += s
            P[k + 1].copy_(c)
    return carries


def _full(value, dtype, like: Tensor) -> Tensor:
    """A scalar count on ``like``'s device, made by a fill: a tensor made
    from a host value would copy it, and that copy waits for the card."""
    return torch.full((), float(value), dtype=dtype, device=like.device)


def _dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"``: the JAX package's dtype spelling."""
    return str(dtype).replace("torch.", "")


def _as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``, as
    the JAX package writes it)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype).replace("torch.", ""), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype named {dtype!r}")
    return out


class GramData:
    """A dense ``(n, d)`` matrix bundled with its block-prefix Gram
    statistics.  Quacks like the wrapped matrix where the SGD driver needs
    it (``shape``, ``dtype``, ``ndim``, ``device``).

    ``X`` may be ``None``: a VIRTUAL matrix, whose statistics alone exist
    (loaded with :meth:`load`, or totals from
    :meth:`GramLeastSquaresGradient.totals_only_data`), and ``shape`` /
    ``dtype`` report the logical dataset.  Virtual data supports
    block-aligned sliced windows and full-batch sums (nothing that reads
    rows)."""

    __slots__ = ("X", "PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot",
                 "block_rows", "_logical_shape", "_logical_dtype",
                 "__weakref__")

    def __init__(self, X, PG, Pb, Pyy, G_tot, b_tot, yy_tot, block_rows,
                 logical_shape=None, logical_dtype=None):
        self.X = X
        self.PG = PG
        self.Pb = Pb
        self.Pyy = Pyy
        self.G_tot = G_tot
        self.b_tot = b_tot
        self.yy_tot = yy_tot
        self.block_rows = int(block_rows)
        if X is None and (logical_shape is None or logical_dtype is None):
            raise ValueError(
                "virtual GramData (X=None) needs logical_shape and "
                "logical_dtype (GramData.load and "
                "GramLeastSquaresGradient.totals_only_data set them)"
            )
        self._logical_shape = (tuple(int(s) for s in logical_shape)
                               if logical_shape is not None
                               else tuple(X.shape))
        self._logical_dtype = (_as_torch_dtype(logical_dtype)
                               if logical_dtype is not None else X.dtype)

    @property
    def shape(self):
        return self._logical_shape

    @property
    def dtype(self):
        return self._logical_dtype

    @property
    def ndim(self):
        return len(self._logical_shape)

    @property
    def device(self):
        return self.PG.device

    def __getitem__(self, idx):
        raise TypeError(
            "GramData supports sliced/full-batch execution only; use "
            "sampling='sliced' (or mini_batch_fraction=1.0), or pass the "
            "plain matrix for indexed/bernoulli sampling"
        )

    # -- persistence: the JAX package's format ------------------------------
    _FORMAT_VERSION = "1.0"

    def save(self, path: str) -> None:
        """Persist the STATISTICS (never the rows) as a directory of
        ``metadata.json`` + ``stats.npz``, the JAX package's format.
        Loads back, in either package, as a VIRTUAL bundle."""
        os.makedirs(path, exist_ok=True)
        meta = {
            "class": "GramData",
            "version": self._FORMAT_VERSION,
            "block_rows": int(self.block_rows),
            "logical_shape": list(self._logical_shape),
            "logical_dtype": _dtype_name(self._logical_dtype),
        }
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(meta, f)
        host = {k: getattr(self, k).detach().cpu().numpy()
                for k in ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot")}
        np.savez(os.path.join(path, "stats.npz"), **host)

    @classmethod
    def load(cls, path: str, device=None) -> "GramData":
        """Statistics saved by :meth:`save` in either package, as a virtual
        bundle on ``device`` (``None``: the card)."""
        dev = resolve_device(device)
        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        if meta.get("class") != "GramData":
            raise ValueError(
                f"{path} holds a {meta.get('class')}, expected GramData"
            )
        if meta["version"] != cls._FORMAT_VERSION:
            raise ValueError(
                f"unsupported GramData format version {meta['version']}"
            )
        with np.load(os.path.join(path, "stats.npz")) as z:
            stats = [as_tensor(z[k], dev) for k in
                     ("PG", "Pb", "Pyy", "G_tot", "b_tot", "yy_tot")]
        return cls(None, *stats, int(meta["block_rows"]),
                   logical_shape=tuple(meta["logical_shape"]),
                   logical_dtype=meta["logical_dtype"])


class GramLeastSquaresGradient(LeastSquaresGradient):
    """``LeastSquaresGradient`` bound to precomputed block-prefix Grams.

    Build with :meth:`build`; pass it anywhere a ``Gradient`` goes
    (``GradientDescent``, ``LBFGS``, ``OWLQN``), giving the optimizer
    ``.data`` (the :class:`GramData` bundle) or the bound matrix itself as
    the feature matrix.  Accelerates ``window_sums`` (sliced sampling:
    prefix differences plus edge corrections), ``batch_sums`` without a
    mask (full batch, the L-BFGS cost: the totals) and ``loss_sweep``
    without a mask (one ``(T, d) × (d, d)`` quadratic form).

    A plain matrix binds by identity only.  Bernoulli masks, ``valid``,
    feature sharding, and any ``X`` that is neither the bundle nor the
    bound matrix run the stock exact path, so a same-shape different
    matrix never trains against stale statistics (it warns once)."""

    def __init__(self, data: Optional[GramData] = None,
                 aligned: bool = False):
        # data=None: an UNBOUND executor, which accelerates GramData
        # arguments and treats every plain matrix as stock input.
        # aligned=True floors window starts to block boundaries even when
        # the rows are resident, skipping the edge corrections; virtual
        # data (X=None) is always aligned.
        self.data = data
        self.aligned = bool(aligned)
        self._X_shape = tuple(data.shape) if data is not None else None
        self._X_dtype = data.dtype if data is not None else None
        self.block_rows = data.block_rows if data is not None else None
        self._warned = False

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, X, y, block_rows: int = DEFAULT_BLOCK_ROWS,
              stats_dtype=None, aligned: bool = False,
              device=None) -> "GramLeastSquaresGradient":
        """One pass over ``(X, y)`` on ``device`` (``None``: the card) → a
        bound gradient, its statistics in ``.data``.

        ``block_rows`` trades prefix memory (``n/B · d²`` entries) against
        per-iteration edge traffic (``2 · B · d`` elements read).
        ``stats_dtype`` defaults to the wider of f32 and the data dtype
        (f64 data keeps f64 statistics)."""
        dev = resolve_device(device)
        X = as_tensor(X, dev)
        if not X.dtype.is_floating_point:
            X = X.to(torch.float32)  # match optimize()'s coercion
        y = as_tensor(y, dev)
        if not y.dtype.is_floating_point:
            y = y.to(torch.float32)
        if X.dim() != 2 or X.shape[0] == 0:
            raise ValueError(
                f"need a non-empty (n, d) matrix, got {tuple(X.shape)}")
        sd = cls._resolve_stats_dtype(X.dtype, stats_dtype)
        B = max(1, min(int(block_rows), X.shape[0]))
        stats = cls._precompute(X, y, B=B, stats_dtype=sd)
        return cls(GramData(X, *stats, B), aligned=aligned)

    @classmethod
    def build_streamed(cls, X, y, block_rows: int = DEFAULT_BLOCK_ROWS,
                       **kwargs):
        """Statistics of a host-resident dataset too large for the card:
        the streamed statistics (ROADMAP A9, second half)."""
        from tpu_sgd_torch.optimize.gradient_descent import (A9_REST,
                                                             _not_ported)

        _not_ported("GramLeastSquaresGradient.build_streamed", A9_REST)

    @staticmethod
    def _resolve_stats_dtype(data_dtype, stats_dtype) -> torch.dtype:
        """The wider of f32 and the data dtype by default; never below f32
        (prefix differencing would amplify the rounding)."""
        if stats_dtype is None:
            return torch.promote_types(torch.float32, data_dtype)
        sd = _as_torch_dtype(stats_dtype)
        if not sd.is_floating_point:
            # an int/bool stats dtype would truncate every element in the
            # upcast: garbage statistics and no error
            raise ValueError(
                f"stats_dtype must be a floating dtype, got {sd}; use "
                "float32 or wider")
        if torch.finfo(sd).bits < 32:
            raise ValueError(
                "stats_dtype below f32 loses ~1% on prefix differences; "
                "use float32 or wider")
        return sd

    @staticmethod
    def _block_stats(X, y, *, B):
        """Yields ``(G, b, yy)`` of each full ``B``-row block of ``(X,
        y)`` in order, at ``SUM_DTYPE``, one block's upcast live at a
        time."""
        for k in range(X.shape[0] // B):
            Xb = X[k * B:(k + 1) * B].to(SUM_DTYPE)
            yb = y[k * B:(k + 1) * B].to(SUM_DTYPE)
            yield _dot_wide(Xb.T, Xb), _dot_wide(yb, Xb), _dot_wide(yb, yb)

    @staticmethod
    def _total_stats(X, y, *, B, stats_dtype, valid=None):
        """TOTAL statistics ``(G, b, yy)`` by blockwise accumulation with
        an O(d²) ``SUM_DTYPE`` carry (no prefix stack), the ``n % B`` tail
        included; ``G`` comes back at the stats dtype, ``b`` and ``yy`` at
        ``SUM_DTYPE``, as :meth:`build` stores them.  ``valid`` masks rows
        exactly (one operand's rows zeroed)."""
        n, d = X.shape
        G = torch.zeros((d, d), dtype=SUM_DTYPE, device=X.device)
        b = torch.zeros((d,), dtype=SUM_DTYPE, device=X.device)
        yy = torch.zeros((), dtype=SUM_DTYPE, device=X.device)
        for s in range(0, n, B):
            Xb = X[s:s + B].to(SUM_DTYPE)
            yb = y[s:s + B].to(SUM_DTYPE)
            Xm, ym = Xb, yb
            if valid is not None:
                v = valid[s:s + B].to(SUM_DTYPE)
                Xm, ym = Xb * v[:, None], yb * v
            G += _dot_wide(Xm.T, Xb)
            b += _dot_wide(ym, Xb)
            yy += _dot_wide(ym, yb)
        return G.to(stats_dtype), b, yy

    @staticmethod
    def totals_only_data(G_tot, b_tot, yy_tot, n: int, d: int,
                         data_dtype) -> GramData:
        """A VIRTUAL :class:`GramData` carrying only totals (a one-block
        prefix stack): enough for the quasi-Newton cost and sweep, which
        never read windows.  Sliced GD sees every window as the full batch
        and must not use it."""
        stack = lambda t: torch.stack([torch.zeros_like(t), t])
        return GramData(None, stack(G_tot), stack(b_tot), stack(yy_tot),
                        G_tot, b_tot, yy_tot, int(n),
                        logical_shape=(int(n), int(d)),
                        logical_dtype=data_dtype)

    @classmethod
    def _precompute(cls, X, y, *, B, stats_dtype):
        """``(PG, Pb, Pyy, G_tot, b_tot, yy_tot)``: the prefix stacks,
        preallocated and written in place (all but ``PG`` and ``G_tot`` at
        ``SUM_DTYPE``), then the totals with the ``n % B`` tail."""
        sd = stats_dtype
        n, d = X.shape
        nbf = n // B
        dev = X.device
        PG = torch.empty((nbf + 1, d, d), dtype=sd, device=dev)
        Pb = torch.empty((nbf + 1, d), dtype=SUM_DTYPE, device=dev)
        Pyy = torch.empty((nbf + 1,), dtype=SUM_DTYPE, device=dev)
        cG, cb, cyy = _running_sum((PG, Pb, Pyy), cls._block_stats(X, y, B=B))
        Xt = X[nbf * B:].to(SUM_DTYPE)  # the n % B tail
        yt = y[nbf * B:].to(SUM_DTYPE)
        G_tot = (cG + _dot_wide(Xt.T, Xt)).to(sd)
        b_tot = cb + _dot_wide(yt, Xt)
        yy_tot = cyy + _dot_wide(yt, yt)
        return PG, Pb, Pyy, G_tot, b_tot, yy_tot

    # -- binding check -----------------------------------------------------
    def _stats_for(self, X, mask_or_valid, margin_axis_name):
        """``(dense_X, stats)``: the GramData to read from, or None when
        this call must run the stock path."""
        if isinstance(X, GramData):
            if mask_or_valid is not None or margin_axis_name is not None:
                if X.X is None:
                    raise NotImplementedError(
                        "virtual (stats-only) GramData supports sliced "
                        "windows and full-batch sums only — no masks, "
                        "valid padding, or feature sharding"
                    )
                return X.X, None  # masked: the stock path is correct
            return X.X, X
        if mask_or_valid is not None or margin_axis_name is not None:
            return X, None
        # a plain matrix binds by IDENTITY only: a same-shape different
        # matrix (a validation split, a regenerated batch) must never
        # train against stale statistics
        if self.data is None:
            return X, None  # unbound executor: plain matrices are stock
        if X is self.data.X:
            return X, self.data
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"GramLeastSquaresGradient is bound to a {self._X_shape} "
                f"{self._X_dtype} matrix but was called with a different "
                f"{tuple(X.shape)} {getattr(X, 'dtype', '?')} matrix; "
                "running the exact unaccelerated path (pass gradient.data "
                "as X — the optimizers' set_sufficient_stats flags do — or "
                "rebuild)",
                RuntimeWarning,
                stacklevel=4,
            )
        return X, None

    # -- accelerated entry points -----------------------------------------
    def batch_sums(self, X, y, weights, mask=None, margin_axis_name=None,
                   Xt=None):
        Xd, st = self._stats_for(X, mask, margin_axis_name)
        if st is None:
            return super().batch_sums(Xd, y, weights, mask,
                                      margin_axis_name=margin_axis_name,
                                      Xt=Xt)
        # X (bundle or bound matrix) carries the logical shape and dtype
        # even when the rows are virtual
        # the totals are (d, d): the whole evaluation runs at SUM_DTYPE
        cd = acc_dtype(matmul_dtype(X))
        w = weights.to(SUM_DTYPE)
        with true_f32_matmul():
            Gw = _dot_wide(st.G_tot, w)
            b = st.b_tot.to(SUM_DTYPE)
            loss_sum = 0.5 * (_dot_wide(w, Gw) - 2.0 * _dot_wide(w, b)
                              + st.yy_tot.to(SUM_DTYPE))
        return (Gw - b).to(cd), loss_sum.to(cd), _full(X.shape[0], cd, w)

    def loss_sweep(self, X, y, W, mask=None):
        Xd, st = self._stats_for(X, mask, None)
        if st is None:
            return super().loss_sweep(Xd, y, W, mask)
        # at SUM_DTYPE, as batch_sums: the line search compares the two
        cd = acc_dtype(matmul_dtype(X))
        Wc = W.to(SUM_DTYPE)  # (T, d)
        with true_f32_matmul():
            GW = _dot_wide(Wc, st.G_tot)  # G is symmetric
            quad = torch.sum(GW * Wc, dim=1)
            lin = _dot_wide(Wc, st.b_tot)
        losses = 0.5 * (quad - 2.0 * lin + st.yy_tot.to(SUM_DTYPE))
        return losses.to(cd), _full(X.shape[0], cd, W)

    def window_sums(self, X, y, weights, start, m: int,
                    valid: Optional[Tensor] = None,
                    margin_axis_name: Optional[str] = None,
                    ) -> Tuple[Tensor, Tensor, Tensor]:
        Xd, st = self._stats_for(X, valid, margin_axis_name)
        if st is None:
            return super().window_sums(Xd, y, weights, start, m, valid,
                                       margin_axis_name=margin_axis_name)
        cd = acc_dtype(matmul_dtype(X))
        start = _start_tensor(start, st.device)
        with true_f32_matmul():
            if st.X is None or self.aligned:
                return self._window_sums_aligned(st, weights, start, m, cd)
            n = Xd.shape[0]
            # the stock path's whole-window clamp
            start = torch.clamp(start, 0, max(n - m, 0))
            # both ends at once: rows [0, start) and [0, start + m)
            k, e_gw, e_b, e_yy = self._cum(st, Xd, y, weights,
                                           torch.cat([start, start + m]))
            PG = st.PG.index_select(0, k)
            # the window's whole blocks, then the edges' difference
            Gw = (_dot_hi(PG[1] - PG[0], weights, st.PG.dtype)
                  + (e_gw[1] - e_gw[0]))
            Pb = st.Pb.index_select(0, k)
            Pyy = st.Pyy.index_select(0, k)
            b = (Pb[1] - Pb[0]) + (e_b[1] - e_b[0])
            yy = (Pyy[1] - Pyy[0]) + (e_yy[1] - e_yy[0])
            g_sum = Gw - b
            w_wide = weights.to(SUM_DTYPE)
            loss_sum = 0.5 * (_dot_wide(w_wide, g_sum)
                              - _dot_wide(w_wide, b) + yy)
        return g_sum.to(cd), loss_sum.to(cd), _full(m, cd, g_sum)

    def _window_sums_aligned(self, st, weights, start, m, cd):
        """Block-aligned window: the start floors to a block boundary and
        the length rounds to whole blocks (the floored-window sampling
        deviation of the tiled kernel).  Prefix differences only: no row
        is read."""
        B = st.block_rows
        n = st.shape[0]
        nbf = n // B
        mb = aligned_window_blocks(m, B, nbf)
        k1 = aligned_window_k1(start, n, m, B, nbf, mb)
        ends = torch.cat([k1, k1 + mb])
        PG = st.PG.index_select(0, ends)
        Pb = st.Pb.index_select(0, ends)
        Pyy = st.Pyy.index_select(0, ends)
        g_sum, loss_sum = aligned_window_terms(
            PG[1] - PG[0], Pb[1] - Pb[0], Pyy[1] - Pyy[0],
            weights.to(st.PG.dtype))
        return g_sum.to(cd), loss_sum.to(cd), _full(mb * B, cd, g_sum)

    # -- internals ---------------------------------------------------------
    def _cum(self, st, X, y, weights, r):
        """Rows ``[0, r_i)`` for each entry of the device vector ``r``, as
        prefix entry ``k_i = r_i // B`` plus the masked partial-block edge
        ``[k_i·B, r_i)``: returns ``k`` and the edges' ``(e_gw, e_b,
        e_yy)`` applied to ``weights``, one row each.  The caller
        differences the prefix rows."""
        k = torch.div(r, st.block_rows, rounding_mode="floor")
        return (k,) + self._edge(st, X, y, weights, r, k)

    def _edge(self, st, X, y, weights, r, k):
        """Contributions of the partial blocks ``[k_i·B, r_i)`` (fewer
        than B rows each) by masked products over one B-row slice each,
        never a ``(d, d)`` intermediate, all edges in one gather.  A slice start backs off to ``n − B`` near the
        tail, and the mask is in slice-local coordinates, so it stays
        exact either way."""
        B = st.block_rows
        n = X.shape[0]
        sd = st.PG.dtype
        s = torch.clamp(k * B, max=max(n - B, 0))[:, None]  # (R, 1)
        j = torch.arange(B, device=r.device)
        rows = s + j  # (R, B)
        Xb = X[rows].to(sd)  # (R, B, d)
        yb = y[rows].to(sd)
        msk = ((j >= k[:, None] * B - s) & (j < r[:, None] - s)).to(sd)
        margins = _dot_hi(Xb, weights, sd)  # (R, B)
        ybm = yb * msk
        # both row products in one pass over each slice, one product per
        # slice: as one batched (R, 2, B) x (R, B, d) product they took
        # 0.27 ms against 0.04 ms on an H100 (chip_smoke.py, leg (c))
        c = torch.stack([margins * msk, ybm], dim=1)  # (R, 2, B)
        e = torch.stack([_dot_hi(c[i], Xb[i], sd) for i in range(len(r))])
        e_yy = torch.sum(yb.to(SUM_DTYPE) * ybm.to(SUM_DTYPE), dim=1)
        return e[:, 0], e[:, 1].to(SUM_DTYPE), e_yy
