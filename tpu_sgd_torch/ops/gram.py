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

Host-resident data too large for the card builds its statistics in one
streamed pass (:meth:`GramLeastSquaresGradient.build_streamed`, and the
totals alone by :meth:`GramLeastSquaresGradient._streamed_totals` for the
normal equations): chunks of whole blocks go through the ingest pipeline
(``tpu_sgd_torch/io``: a prefetch worker, pinned slots, copies on a side
stream) and each block is summed by the resident build's own arithmetic
(``_block_stats``, the f64 carry of ``_running_sum``), which carries on
across chunk boundaries.  So a streamed stack equals the resident
``build`` over the same whole blocks bit for bit, whatever the chunk size.
A build given ``resume_dir`` persists each chunk's prefix rows and the
f64 carry (``_PrefixBuildCheckpoint``; the totals: the carry alone,
``_TotalsBuildCheckpoint``), so a build stopped part way resumes from its
last chunk to the same bits.  The JAX package carries f32 prefix rows
across chunks and in its part files; a resume directory it wrote records
no carry dtype and is refused.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import shutil
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device, true_f32_matmul
from tpu_sgd_torch.io.chunking import plan_chunks
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.wire import host_tensor, resolve_wire_dtype
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


def _running_sum(stacks, blocks, carries=None, k0: int = 0):
    """Inclusive running sums with a leading zero entry, written in place:
    ``P[0] = 0`` and ``P[k+1] = P[k] + block_k`` for each of ``stacks``,
    summed in a ``SUM_DTYPE`` carry and rounded once into each entry, with
    one block's statistics live at a time (``blocks`` yields one tuple per
    block).  Returns the carries: the sums over all blocks.

    A streamed build passes the carries of the blocks before its chunk
    (updated in place) and ``k0``, the chunk's first block: its entries
    land at ``P[k0 + 1] ...``."""
    if carries is None:
        carries = [torch.zeros(P.shape[1:], dtype=SUM_DTYPE,
                               device=P.device) for P in stacks]
        for P in stacks:
            P[0].zero_()
    for k, stats in enumerate(blocks, start=k0 + 1):
        for P, c, s in zip(stacks, carries, stats):
            c += s
            P[k].copy_(c)
    return carries


def streamed_totals_chunking(n: int, block_rows: int, batch_rows=None):
    """``(B, chunk)`` of a streamed TOTALS build: block size and chunk rows.
    ``batch_rows`` caps the chunk exactly: the totals carry has no prefix
    stack, so the block shrinks to honour a small cap.  Default: 64
    blocks a chunk.  The JAX package's policy, shared with
    ``NormalEquations.set_host_streaming``."""
    n = max(1, int(n))
    B = max(1, min(int(block_rows), n))
    if batch_rows:
        B = max(1, min(B, int(batch_rows)))
        chunk = max(B, (int(batch_rows) // B) * B)
    else:
        chunk = 64 * B
    return B, min(chunk, n)


def _acc_totals(carry, X, y, B, valid=None):
    """Add the statistics ``(XᵀX, Xᵀy, yᵀy)`` of ``(X, y)`` to the
    ``SUM_DTYPE`` carry ``(G, b, yy)`` in place, ``B`` rows at a time (the
    last block may be short), each block upcast on its own.  ``valid``
    masks rows exactly (one operand's rows zeroed).  Returns the carry."""
    G, b, yy = carry
    for s in range(0, X.shape[0], B):
        Xb = X[s:s + B].to(SUM_DTYPE)
        yb = y[s:s + B].to(SUM_DTYPE)
        Xm, ym = Xb, yb
        if valid is not None:
            v = valid[s:s + B].to(SUM_DTYPE)
            Xm, ym = Xb * v[:, None], yb * v
        G += _dot_wide(Xm.T, Xb)
        b += _dot_wide(ym, Xb)
        yy += _dot_wide(ym, yb)
    return carry


def _chunk_prefix(stacks, carries, X, y, B, k0):
    """One streamed chunk of whole blocks into the prefix stacks, its
    first block at ``k0``, the carries continued in place."""
    return _running_sum(
        stacks, GramLeastSquaresGradient._block_stats(X, y, B=B), carries, k0)


def _sum_carries(d: int, device):
    """Zero ``SUM_DTYPE`` carries ``(G, b, yy)`` of width ``d``."""
    return [torch.zeros(shape, dtype=SUM_DTYPE, device=device)
            for shape in ((d, d), (d,), ())]


def _host_bytes(t: Tensor) -> bytes:
    """A host tensor's bytes, whatever its dtype (bf16 included)."""
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def _dataset_fingerprint(Xh: Tensor, yh: Tensor, n_rows: int) -> str:
    """Cheap dataset identity for the resume checkpoints: the first and
    the last used row and the head of the labels, so a stale resume_dir
    of another dataset of the same shape is refused."""
    h = hashlib.sha1()
    h.update(_host_bytes(Xh[0]))
    h.update(_host_bytes(Xh[n_rows - 1]))
    h.update(_host_bytes(yh[:min(64, n_rows)].to(torch.float64)))
    return h.hexdigest()


def _atomic_json_write(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` to ``path`` through a temporary file and a rename, so
    the file exists whole or not at all."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _to_host(t: Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _validate_or_write_meta(meta_path: str, meta: dict,
                            validate_keys) -> dict:
    """Compare a checkpoint meta on disk with this build's (raising on a
    mismatch of geometry, dataset or wire) or write a fresh one; returns
    the meta on disk.  A meta without ``carry_dtype`` was written by a
    build that carries its sums at the stats dtype (the JAX package's),
    and cannot resume this one bitwise: it is refused."""
    if not os.path.exists(meta_path):
        _atomic_json_write(meta_path, meta)
        return meta
    with open(meta_path) as f:
        on_disk = json.load(f)
    where = os.path.dirname(meta_path)
    if "carry_dtype" not in on_disk:
        raise ValueError(
            f"resume_dir {where!r} holds a build that records no carry "
            "dtype: one that carries its sums at the stats dtype (the JAX "
            "package writes such parts), which this build, carrying "
            f"{_dtype_name(SUM_DTYPE)} sums, cannot resume bitwise; point "
            "resume_dir at a fresh directory or delete the stale one")
    want = {k: meta[k] for k in validate_keys}
    got = {k: on_disk.get(k) for k in validate_keys}
    if got != want:
        raise ValueError(
            f"resume_dir {where!r} holds a different build ({got} != "
            f"{want}); point resume_dir at a fresh directory or delete the "
            "stale one")
    return on_disk


class _TotalsBuildCheckpoint:
    """Resumability of a streamed TOTALS build: the whole mid-pass state
    is the ``SUM_DTYPE`` carry, so a checkpoint is one small atomic npz
    (the carry and the rows done) beside a meta of geometry, dataset
    fingerprint, effective wire and carry dtype."""

    def __init__(self, path, *, n, d, B, chunk, sd_name, fingerprint="",
                 wire="none"):
        self.path = path
        self.meta = {
            "class": "TotalsBuildCheckpoint",
            "n": int(n), "d": int(d), "B": int(B), "chunk": int(chunk),
            "stats_dtype": sd_name, "fingerprint": fingerprint,
            # chunks summed under one wire never mix with a resumed pass
            # under another
            "wire": wire, "carry_dtype": _dtype_name(SUM_DTYPE),
        }
        os.makedirs(path, exist_ok=True)
        self._state_path = os.path.join(path, "totals.npz")
        _validate_or_write_meta(os.path.join(path, "meta.json"), self.meta,
                                tuple(self.meta))

    def restore(self, device):
        """``(rows_done, carry | None)`` from the last checkpoint."""
        if not os.path.exists(self._state_path):
            return 0, None
        with np.load(self._state_path) as z:
            carry = [torch.from_numpy(z[k]).to(device)
                     for k in ("G", "b", "yy")]
            return int(z["rows_done"]), carry

    def save(self, rows_done, carry) -> None:
        G, b, yy = (_to_host(t) for t in carry)
        _atomic_savez(self._state_path, rows_done=np.asarray(rows_done),
                      G=G, b=b, yy=yy)

    def finalize(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)


class _PrefixBuildCheckpoint:
    """Per-chunk persistence of the streamed prefix build: each part file
    holds one chunk's prefix rows (stats dtype; ``Pb`` and ``Pyy`` at
    ``SUM_DTYPE``) and the ``SUM_DTYPE`` carry after it, written
    atomically; ``meta.json`` records the geometry, the dataset, the wire,
    the carry dtype and the high-water row.  A restart replays the parts
    into the new stack and continues from the last part's carry, so the
    resumed build is bitwise the uninterrupted one."""

    def __init__(self, path, *, n_used, d, B, sd_name, chunk,
                 fingerprint="", wire="none"):
        self.path = path
        self.meta = {
            "class": "PrefixBuildCheckpoint",
            "n_used": int(n_used), "d": int(d), "B": int(B),
            "stats_dtype": sd_name, "chunk": int(chunk),
            "fingerprint": fingerprint,
            # a resumed pass under another wire would mix two wires'
            # statistics
            "wire": wire, "carry_dtype": _dtype_name(SUM_DTYPE),
            "high_water_rows": 0,
        }
        os.makedirs(path, exist_ok=True)
        self._meta_path = os.path.join(path, "meta.json")
        on_disk = _validate_or_write_meta(
            self._meta_path, self.meta,
            ("class", "n_used", "d", "B", "stats_dtype", "fingerprint",
             "wire", "carry_dtype"))
        if on_disk is not self.meta:
            self.meta["high_water_rows"] = int(
                on_disk.get("high_water_rows", 0))

    def _part_path(self, start_block: int) -> str:
        return os.path.join(self.path, f"part_{start_block:08d}.npz")

    def restore(self):
        """``(resume_row, parts)``: the row to continue from and the
        persisted ``(start_block, (pG, pb, pyy), carry)`` chunks in order.
        Parts past the recorded high-water mark (a stop between a part's
        write and the meta's) are whole chunks and are replayed too."""
        parts = []
        resume_row = 0
        for fp in sorted(glob.glob(os.path.join(self.path, "part_*.npz"))):
            start_block = int(os.path.basename(fp)[5:-4])
            if start_block * self.meta["B"] != resume_row:
                break  # a gap: an earlier part is missing
            with np.load(fp) as z:
                rows = tuple(z[k] for k in ("pG", "pb", "pyy"))
                carry = tuple(z[k] for k in ("cG", "cb", "cyy"))
            parts.append((start_block, rows, carry))
            resume_row += rows[0].shape[0] * self.meta["B"]
        return resume_row, parts

    def save_part(self, start_block: int, rows, carry,
                  high_water_rows: int) -> None:
        pG, pb, pyy = (_to_host(t) for t in rows)
        cG, cb, cyy = (_to_host(t) for t in carry)
        _atomic_savez(self._part_path(start_block), pG=pG, pb=pb, pyy=pyy,
                      cG=cG, cb=cb, cyy=cyy)
        self.meta["high_water_rows"] = int(high_water_rows)
        _atomic_json_write(self._meta_path, self.meta)

    def finalize(self) -> None:
        """Drop the parts once the build completed (``GramData.save`` is
        the durable format)."""
        shutil.rmtree(self.path, ignore_errors=True)


def _float_dtype(dtype: torch.dtype) -> torch.dtype:
    """A floating dtype as it is; int and bool as f32 (``optimize()``'s
    coercion)."""
    return dtype if dtype.is_floating_point else torch.float32


def _host_rows(X, y):
    """Host ``(X, y)`` of a streamed pass as contiguous CPU tensors (a
    numpy array is wrapped, not copied); raises on anything but a
    non-empty 2-D matrix.  Int and bool rows stay as they are: the feed
    casts each chunk to f32 (:func:`_float_dtype`) on its way."""
    Xh = host_tensor(X)
    yh = host_tensor(y)
    if Xh.dim() != 2 or Xh.shape[0] == 0:
        raise ValueError(
            f"need a non-empty (n, d) matrix, got {tuple(Xh.shape)}")
    return Xh.contiguous(), yh.contiguous()


def _stream_chunks(Xh, yh, plan, device, wire, depth):
    """Yield ``(chunk, Xc, yc)`` for each chunk of ``plan``: its valid rows
    on ``device``, X at the ``wire`` dtype when one is set, else at its
    float dtype, y at its float dtype.  The prefetch worker stages each
    chunk in a pinned ring slot (the cast in the same copy) and copies it
    on a side stream.  The consumer queues its work on a chunk before it
    asks for the next one, which frees the slot."""
    xdt = wire if wire is not None else _float_dtype(Xh.dtype)
    slots = ring_slots(depth)
    rows = plan.chunk_rows
    ring = PinnedRing({"x": ((rows, Xh.shape[1]), xdt),
                       "y": ((rows,), _float_dtype(yh.dtype))}, slots,
                      device)

    def produce(c):
        slot = c.index % slots
        host = ring.claim(slot)
        dev = ring.dev[slot]
        v = c.valid
        host["x"][:v].copy_(Xh[c.start:c.stop])
        host["y"][:v].copy_(yh[c.start:c.stop])
        ring.send(slot, [(dev["x"][:v], host["x"][:v]),
                         (dev["y"][:v], host["y"][:v])])
        return c, slot

    with Prefetcher(produce, plan, depth=depth) as feed:
        for c, slot in feed:
            dev = ring.take(slot)
            yield c, dev["x"][:c.valid], dev["y"][:c.valid]
            ring.release(slot)
    ring.drain()


def _sync_chunks(Xh, yh, n, chunk, start, device):
    """The plain feed (``pipeline=False``): chunk after chunk from
    ``start``, each copied at its float dtype, no lookahead, no wire
    cast."""
    for s in range(start, n, chunk):
        e = min(s + chunk, n)
        yield (s, e, Xh[s:e].to(device, _float_dtype(Xh.dtype)),
               yh[s:e].to(device, _float_dtype(yh.dtype)))


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
                       batch_rows: Optional[int] = None, stats_dtype=None,
                       resume_dir: Optional[str] = None, wire_dtype=None,
                       prefetch_depth: int = 2, pipeline: bool = True,
                       device=None) -> "GramLeastSquaresGradient":
        """Statistics of a HOST-resident dataset too large for the card
        (a numpy array or a CPU tensor, bf16 included), in one streamed
        pass on ``device`` (``None``: the card).  The gradient comes back
        bound to a VIRTUAL ``GramData`` (``X=None``) of logical shape
        ``(n // B · B, d)``: the trailing ``n % block_rows`` rows are
        dropped, and block-aligned sliced windows and full-batch sums then
        run from the statistics alone.

        ``batch_rows`` is the host->device chunk (default 64 blocks, then
        whole blocks).  ``pipeline=True`` feeds chunk ``k+1`` while chunk
        ``k`` is summed (``prefetch_depth`` chunks staged at once, the one
        being summed included); ``wire_dtype="bfloat16"`` casts each chunk
        on the host and moves half the bytes; ``pipeline=False`` is the
        plain feed, no lookahead and no wire cast, bitwise the same on an
        f32 wire.  The stack is allocated once on the card and written in
        place, so the peak is the stack plus the staged chunks.
        ``resume_dir`` makes the pass resumable (module docstring)."""
        dev = resolve_device(device)
        Xh, yh = _host_rows(X, y)
        n, d = Xh.shape
        B = max(1, min(int(block_rows), n))
        nbf = n // B
        data_dtype = _float_dtype(Xh.dtype)
        sd = cls._resolve_stats_dtype(data_dtype, stats_dtype)
        chunk = (max(1, int(batch_rows) // B) if batch_rows else 64) * B
        PG, Pb, Pyy = cls._streamed_prefix(
            Xh, yh, B, sd, chunk, dev, resume_dir=resume_dir,
            wire_dtype=wire_dtype, prefetch_depth=prefetch_depth,
            pipeline=pipeline)
        data = GramData(None, PG, Pb, Pyy, PG[-1], Pb[-1], Pyy[-1], B,
                        logical_shape=(nbf * B, d), logical_dtype=data_dtype)
        return cls(data)

    @classmethod
    def _streamed_prefix(cls, Xh, yh, B, sd, chunk, device, resume_dir=None,
                         wire_dtype=None, prefetch_depth=2, pipeline=True):
        """``(PG, Pb, Pyy)`` of the whole blocks of host rows ``(Xh, yh)``,
        streamed chunk by chunk (``chunk`` a multiple of ``B``) into one
        stack allocated on ``device``; each chunk's blocks go through
        :func:`_chunk_prefix`, the ``SUM_DTYPE`` carry threading the
        chunks.  See :meth:`build_streamed` and the module docstring for
        the feed and ``resume_dir``."""
        n_used = (Xh.shape[0] // B) * B
        nbf = n_used // B
        d = Xh.shape[1]
        # the legacy plain feed transfers at the data dtype
        wd = resolve_wire_dtype(wire_dtype, Xh.dtype) if pipeline else None
        stacks = (torch.empty((nbf + 1, d, d), dtype=sd, device=device),
                  torch.empty((nbf + 1, d), dtype=SUM_DTYPE, device=device),
                  torch.empty((nbf + 1,), dtype=SUM_DTYPE, device=device))
        for P in stacks:
            P[0].zero_()
        carries = _sum_carries(d, device)
        s = 0
        ckpt = None
        if resume_dir is not None:
            ckpt = _PrefixBuildCheckpoint(
                resume_dir, n_used=n_used, d=d, B=B, sd_name=_dtype_name(sd),
                chunk=chunk, fingerprint=_dataset_fingerprint(Xh, yh, n_used),
                wire="none" if wd is None else _dtype_name(wd))
            s, parts = ckpt.restore()
            for start_block, rows, carry in parts:
                for P, r in zip(stacks, rows):
                    P[start_block + 1:start_block + 1 + r.shape[0]].copy_(
                        torch.from_numpy(r))
                carries = [torch.from_numpy(c).to(device) for c in carry]

        def one(start, stop, Xc, yc):
            k0 = start // B
            _chunk_prefix(stacks, carries, Xc, yc, B, k0)
            if ckpt is not None:
                rows = tuple(P[k0 + 1:stop // B + 1] for P in stacks)
                ckpt.save_part(k0, rows, carries, high_water_rows=stop)

        if pipeline and s < n_used:
            plan = plan_chunks(n_used, chunk, offset=s, round_to=B)
            with contextlib.closing(_stream_chunks(
                    Xh, yh, plan, device, wd, prefetch_depth)) as feed:
                for c, Xc, yc in feed:
                    one(c.start, c.stop, Xc, yc)
        elif not pipeline:
            for start, stop, Xc, yc in _sync_chunks(Xh, yh, n_used, chunk, s,
                                                    device):
                one(start, stop, Xc, yc)
        if ckpt is not None:
            ckpt.finalize()
        return stacks

    @classmethod
    def _streamed_totals(cls, Xh, yh, B, sd, chunk, device=None,
                         resume_dir=None, checkpoint_every: int = 4,
                         wire_dtype=None, prefetch_depth=2, pipeline=True,
                         finalize: bool = True, wide: bool = False):
        """TOTAL statistics ``(G, b, yy)`` of host rows ``(Xh, yh)``,
        streamed chunk by chunk with a ``SUM_DTYPE`` carry and no prefix
        stack (the normal equations read only totals).  Every row counts,
        the ``n % B`` tail included.  Returned as :meth:`_total_stats`
        returns them: ``G`` at the stats dtype ``sd``, ``b`` and ``yy`` at
        ``SUM_DTYPE``; bitwise the same for any ``chunk`` that is a
        multiple of ``B`` and with either feed on an f32 wire.

        ``resume_dir``: the carry is saved every ``checkpoint_every``
        chunks and at the end (each save reads the carry back to the
        host), so a pass stopped part way resumes from its last save,
        bitwise; ``finalize=False`` keeps the directory after the pass
        (a mesh removes its shards' once every shard is done).
        ``wide=True`` returns ``G`` unrounded, at ``SUM_DTYPE`` (a mesh
        combines the ranks' carries before it rounds)."""
        dev = resolve_device(device)
        Xh, yh = _host_rows(Xh, yh)
        n, d = Xh.shape
        wd = resolve_wire_dtype(wire_dtype, Xh.dtype) if pipeline else None
        carry = _sum_carries(d, dev)
        s = 0
        ckpt = None
        if resume_dir is not None:
            ckpt = _TotalsBuildCheckpoint(
                resume_dir, n=n, d=d, B=B, chunk=chunk,
                sd_name=_dtype_name(sd),
                fingerprint=_dataset_fingerprint(Xh, yh, n),
                wire="none" if wd is None else _dtype_name(wd))
            s, saved = ckpt.restore(dev)
            if saved is not None:
                carry = saved
        since_save = 0

        def one(stop, Xc, yc):
            nonlocal since_save
            _acc_totals(carry, Xc, yc, B)
            since_save += 1
            if ckpt is not None and (since_save >= checkpoint_every
                                     or stop >= n):
                ckpt.save(stop, carry)
                since_save = 0

        if pipeline and s < n:  # a restore at row n has nothing left
            plan = plan_chunks(n, chunk, offset=s, round_to=B)
            with contextlib.closing(_stream_chunks(
                    Xh, yh, plan, dev, wd, prefetch_depth)) as feed:
                for c, Xc, yc in feed:
                    one(c.stop, Xc, yc)
        elif not pipeline:
            for _, stop, Xc, yc in _sync_chunks(Xh, yh, n, chunk, s, dev):
                one(stop, Xc, yc)
        if ckpt is not None and finalize:
            ckpt.finalize()
        G, b, yy = carry
        return (G if wide else G.to(sd)), b, yy

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
        G, b, yy = _acc_totals(_sum_carries(X.shape[1], X.device), X, y, B,
                               valid)
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
