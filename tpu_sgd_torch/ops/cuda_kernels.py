"""Fused gradient sums on the card: the port of ``tpu_sgd/ops/pallas_kernels.py``.

The JAX package's three Pallas kernels compute ``(grad_sum, loss_sum,
count)`` of a mini-batch in one pass over X.  Here two hand-written CUDA
sources (sm_90a) serve the three wrappers:

  * :func:`fused_gradient_sums` (Pallas ``_masked_kernel``) sums rows
    ``[0, n)`` with an optional Bernoulli mask;
  * :func:`fused_window_sums` (``_window_kernel``) and
    :func:`fused_window_sums_vpu` (``_window_kernel_vpu``) sum
    ``num_tiles * tile_m`` rows from row ``start_tile * tile_m``, read in
    place from the full X.  The start stays a device tensor: the kernel
    reads it through a pointer and clamps it on the device.

The shape rule.  A CUDA call goes to ``csrc/window_sums.cu`` (bulk copies
into a shared-memory ring, a cluster reduction) when
:func:`window_stage_plan` gives X's width a plan for its base
(:func:`window_plan_for`; any base aligned to X's element size): a window
to its ``window_main``, an unmasked ``fused_gradient_sums`` to the same
entry as a window of ``n`` rows at start 0, a masked one to its
``gather_main``, which deals the live rows into the ring
(:func:`gradient_sums_route`).  Rows of whole 16-byte units on a 16-byte
aligned base land back to back in a stage; any other row (d = 1001 bf16,
101 f32, a view one element off a unit) lands through its 16-byte aligned
superset into a slot of :func:`window_row_pitch` bytes.  Every other call
goes to ``csrc/fused_sums.cu``: widths whose ring does not fit beside w
and the sums (f32 above 4,124 columns, bf16 above 7,216; above 4,121 and
7,209 when a row is not whole 16-byte units or the base is not 16-byte
aligned) and widths above ``WINDOW_MAX_D``, up to the
:func:`_check_tile_smem` limit.  Their rows cannot be staged whole in
shared memory, and ``fused_sums.cu`` reads a tile a second time from L2
instead.  Wider rows raise.  On the TPU the two window kernels differed
in how they used the matrix unit; on Hopper both are one dot product and
one FMA per element, so they launch the same kernel and keep separate
launch counts.
The ring's split of rows among its blocks has a mirror here
(:func:`ring_grid`).

Sparse features have a kernel of their own, ``csrc/csr_products.cu``:
:func:`csr_margins` and :func:`csr_grad_sum` compute a CSR matrix times a
vector (or up to ``CSR_MAX_COLUMNS`` columns) with a fixed order of
additions and no float atomics, so two runs give the same bits.  It is not
a port of a Pallas kernel (the JAX package leaves its BCOO products to
XLA); it is the one sparse product of the card's paths (``ops/gradients.py``
``margins_of`` and ``grad_sum_of``).  Its merge-path split of the rows'
end marks and the entries into blocks of ``CSR_BLOCK_ITEMS`` has a mirror
here (:func:`csr_split`, :func:`csr_walker_lanes`); the wrapper sizes the
grid and the carries from shapes alone (:func:`csr_grid`).

Each wrapper takes its plain PyTorch version (``*_plain``, the same
arithmetic: ``margins_of`` -> pointwise -> ``grad_sum_of``) when X lies on
the CPU, and launches a kernel when X lies on a CUDA device.  There is no
fallback from one to the other: a CUDA input that neither kernel takes
raises.  Each wrapper counts its launches in a plain int attribute
``launches``, :func:`kernel_launch_counts` counts them by CUDA source and
:func:`gradient_route_counts` counts :func:`fused_gradient_sums`'s by
route; :func:`reset_launch_counts` sets all of them to 0.  Under CUDA graph
capture a wrapper runs on the host once and launches nothing:
:func:`captured_launches` takes what a capture counted back out and keeps
it, and :func:`add_replayed_launches` adds it on each replay, so the
counts stay one per kernel the card runs.  Nothing a wrapper does needs
the host during a capture: starts stay device tensors, and a capture
gets its own window scratch.

Threads may launch at once (the replica workers do): every count changes
under one lock (:func:`count_launch`), and a window call holds it from
taking the stream's shared scratch until both of its kernels are queued,
since the C entry queues them with the interpreter lock released.  A
capture's record is its thread's own: while one thread captures, the
launches other threads count, eagerly or by replays, stay in the counts
and out of its record (resident replica workers capture on their cards
while their peers launch).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.ops import _build
from tpu_sgd_torch.ops.gradients import (
    Gradient,
    _clamp_start,
    acc_dtype,
    grad_sum_of,
    margins_of,
    matmul_dtype,
)
from tpu_sgd_torch.ops.sparse import is_sparse

Tensor = torch.Tensor

#: guards every launch count and the window scratch cache: a ``+=`` on a
#: dict entry or an attribute is a read-modify-write that loses updates
#: when threads launch at once.  Re-entrant, so a window call can hold it
#: across its scratch lookup and its launch.
_COUNTS_LOCK = threading.RLock()

#: the pointwise rules the kernel compiles in (csrc/fused_sums.cu Family)
FAMILIES = {"least_squares": 0, "logistic": 1, "hinge": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: shared memory one Hopper block can use (227 KB, sm_90)
SMEM_PER_BLOCK = 232_448
#: shared memory of one SM, shared by the blocks resident on it
SMEM_PER_SM = 233_472
#: the kernel's static shared memory (the compacted row list, tile
#: coefficients, warp partials) plus headroom
_STATIC_SMEM = 6 * 1024
#: threads of a kernel block, and most resident blocks on one SM (2048
#: threads)
_THREADS = 256
_MAX_BLOCKS_PER_SM = 2048 // _THREADS
#: the kernel's row tile: 8 warps x 4 rows
KERNEL_TILE_ROWS = 32
#: row chunk of the plain versions, so that upcasting a bf16 X to f32
#: never materializes more than this many rows at once
PLAIN_CHUNK_ROWS = 1 << 20


def _check_tile_smem(X: Tensor) -> None:
    """Reject feature widths whose ``(d,)`` f32 gradient accumulator does
    not fit in a block's shared memory, with an actionable error instead
    of a refused launch (the counterpart of ``_check_tile_vmem``).  The
    kernel's row tile is fixed, so only ``d`` matters; ``w`` moves to
    global memory (L2) when it does not fit beside the accumulator."""
    d = X.shape[1]
    need = 4 * d + _STATIC_SMEM
    if need > SMEM_PER_BLOCK:
        max_d = (SMEM_PER_BLOCK - _STATIC_SMEM) // 4
        raise ValueError(
            f"d={d} needs ~{need / 1024:.0f} KB of shared memory for the "
            f"fused kernel's f32 gradient accumulator, over the "
            f"{SMEM_PER_BLOCK / 1024:.0f} KB a Hopper block can use; the "
            f"kernel takes d <= {max_d} — train wider data as sparse "
            "features (a torch sparse CSR X) or on the CPU path "
            "(device='cpu')"
        )


def _w_in_smem(d: int) -> bool:
    return 8 * d + _STATIC_SMEM <= SMEM_PER_BLOCK


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# -- the window kernel's stage planner (csrc/window_sums.cu) ----------------

#: rows a ring stage may hold, in the order the planner tries them
WINDOW_STAGE_ROWS = (16, 8, 4)
#: the fewest and the most stages of the ring
WINDOW_MIN_STAGES = 3
WINDOW_MAX_STAGES = 8
#: blocks a cluster: they add their sums through distributed shared memory
WINDOW_CLUSTER = 2
#: shared memory the kernel keeps for its static arrays (barriers,
#: coefficients, partials)
_WINDOW_STATIC_SMEM = 1024
#: bytes after a stage's rows for the aligned supersets of its labels and
#: valid flags (kLabelBytes in the source)
WINDOW_LABEL_BYTES = 112
#: widest row: 8 chunks of 4 columns for each of the 256 consumer threads
WINDOW_MAX_D = 8 * 4 * 256
#: widest row that two blocks an SM take (2 chunks of 4 columns a
#: consumer thread: the register budget of two resident blocks)
WINDOW_TWO_BLOCK_MAX_D = 2 * 4 * 256
#: shared memory the hardware reserves for each resident block
_SMEM_RESERVED_PER_BLOCK = 1024


@dataclass(frozen=True)
class StagePlan:
    """How ``csrc/window_sums.cu`` runs a width: ``stage_rows`` rows of X a
    ring stage (``stage_bytes``, each row in a slot of
    :func:`window_row_pitch` bytes, then the rows' labels and valid flags
    in ``WINDOW_LABEL_BYTES``), ``stages`` stages, ``cluster`` blocks a
    cluster, ``blocks_per_sm`` resident blocks an SM the ring is sized for,
    and the dynamic shared memory a block uses (the ring, then
    ``round_T(w)`` and the f32 sums, each :func:`window_padded_d`
    columns)."""

    stage_rows: int
    stages: int
    cluster: int
    blocks_per_sm: int
    stage_bytes: int
    smem_bytes: int


def window_row_pitch(d: int, itemsize: int, aligned_base: bool) -> int:
    """Bytes of a ring slot for one row (``row_pitch`` in the source): the
    row itself when it is whole 16-byte units on a 16-byte aligned base,
    else the bound of its 16-byte aligned superset, the row after a lead
    of at most ``16 - itemsize`` bytes rounded up to whole units."""
    row = d * itemsize
    if row % 16 == 0 and aligned_base:
        return row
    return -(-(row + 16 - itemsize) // 16) * 16


def window_padded_d(d: int, itemsize: int) -> int:
    """Columns of ``round_T(w)`` and of the sums in the kernel's shared
    memory (``padded_d``): d rounded up to whole 16-byte vectors."""
    vec = 16 // itemsize
    return -(-d // vec) * vec


@functools.lru_cache(maxsize=None)
def window_stage_plan(d: int, itemsize: int,
                      aligned_base: bool) -> Optional[StagePlan]:
    """The window kernel's plan for rows of ``d`` elements of ``itemsize``
    bytes on a base that is 16-byte aligned or not (``aligned_base``, as
    :func:`window_plan_for` reads it from X and the kernel picks its
    instance), or ``None`` when the kernel does not take the width: at
    least ``WINDOW_MIN_STAGES`` stages
    of at least 4 slots of :func:`window_row_pitch` bytes must fit beside
    ``w`` and the sums in one block's shared memory.  Rows of up to
    ``WINDOW_TWO_BLOCK_MAX_D`` columns get two blocks an SM when their
    ring fits in half of it; then the planner takes the most rows a stage
    (16, 8 or 4) that leave 3 stages, and as many stages as fit, up to 8."""
    if d <= 0 or d > WINDOW_MAX_D:
        return None
    pitch = window_row_pitch(d, itemsize, aligned_base)
    sums = 8 * window_padded_d(d, itemsize)
    for blocks in ((2, 1) if d <= WINDOW_TWO_BLOCK_MAX_D else (1,)):
        block_smem = (SMEM_PER_BLOCK if blocks == 1
                      else SMEM_PER_SM // 2 - _SMEM_RESERVED_PER_BLOCK)
        budget = block_smem - _WINDOW_STATIC_SMEM - sums
        for rows in WINDOW_STAGE_ROWS:
            stage = rows * pitch + WINDOW_LABEL_BYTES
            stages = min(WINDOW_MAX_STAGES, budget // stage)
            if stages >= WINDOW_MIN_STAGES:
                return StagePlan(rows, stages, WINDOW_CLUSTER, blocks,
                                 rows * pitch, stages * stage + sums)
    return None


def ring_grid(rows: int, plan: StagePlan, sms: int,
              max_clusters: Optional[int] = None) -> int:
    """Blocks of ``csrc/window_sums.cu``'s persistent grid over ``rows``
    rows, the same for both of its entries: as many clusters as fit on the
    card at once (``max_clusters``; the plan sizes the ring so that ``sms
    * blocks_per_sm / cluster`` fit), at most one a scratch row (the
    wrapper allocates that many), and no more than the rows' tiles need."""
    parts = max(1, sms * plan.blocks_per_sm // plan.cluster)
    clusters = parts if max_clusters is None else min(max_clusters, parts)
    tiles = -(-rows // plan.stage_rows)
    return max(1, min(clusters, -(-tiles // plan.cluster))) * plan.cluster


def _library() -> ctypes.CDLL:
    lib = _build.load("fused_sums")
    fn = lib.tsgd_fused_sums
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, i, p, p, p, p, p, ll, ll, ll, i, i, i,
                       p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.tsgd_error_string.argtypes = [ctypes.c_int]
        lib.tsgd_error_string.restype = ctypes.c_char_p
    return lib


def _window_library() -> ctypes.CDLL:
    return _bind_window(_build.load("window_sums"))


def _bind_window(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``window_sums.cu`` (once)."""
    fn = lib.tsgd_window_sums
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, p, p, p, p, p, ll, ll, ll, i, i, i, i, i,
                       p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.tsgd_gather_sums.argtypes = [i, i, i, p, p, p, p, ll, i, i, i,
                                         i, i, p, p, p, p, p, p, p]
        lib.tsgd_gather_sums.restype = ctypes.c_int
        lib.tsgd_window_error_string.argtypes = [ctypes.c_int]
        lib.tsgd_window_error_string.restype = ctypes.c_char_p
    return lib


def _family_of(pointwise) -> int:
    """The kernel's rule for a ``Gradient.pointwise`` bound method."""
    owner = getattr(pointwise, "__self__", None)
    family = getattr(owner, "family", None)
    if family not in FAMILIES:
        raise ValueError(
            "the CUDA kernel compiles in the least-squares, logistic and "
            f"hinge rules only; {pointwise!r} has none of them (a Gradient "
            "with family=None takes the plain path through batch_sums)"
        )
    return FAMILIES[family]


def _operands(X, y, w, mask):
    """Validate and normalize the kernel's operands; raises on anything
    it does not take (it never converts X)."""
    if X.dim() != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(X.shape)}")
    if X.dtype not in _DTYPES:
        raise TypeError(
            f"the fused kernel takes float32 or bfloat16 X, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("the fused kernel needs a row-major contiguous X")
    n, d = X.shape
    dev = X.device
    if y.shape != (n,):
        raise ValueError(f"y must have shape ({n},), got {tuple(y.shape)}")
    if w.shape != (d,):
        raise ValueError(f"w must have shape ({d},), got {tuple(w.shape)}")
    for name, t in (("y", y), ("w", w), ("mask", mask)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, X on {dev}")
    # y and w enter the kernel as f32, as the Pallas wrappers cast them
    y = y.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (n,):
            raise TypeError(
                f"mask must be a bool tensor of shape ({n},), got "
                f"{mask.dtype} {tuple(mask.shape)}")
        mask = mask.contiguous().view(torch.uint8)
    return y, w, mask


def _launch(pointwise, X, y, w, mask, start, start_scale, rows):
    """Both kernel phases on the current stream; returns device tensors
    ``(grad (d,), loss (), count ())``.  Does not synchronise."""
    family = _family_of(pointwise)
    y, w, mask = _operands(X, y, w, mask)
    _check_tile_smem(X)
    n, d = X.shape
    dev = X.device
    lib = _library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    # scratch rows for the most blocks that can be resident at once; the
    # launcher picks the grid (by occupancy) within this
    dyn = 4 * d * (2 if _w_in_smem(d) else 1)
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM,
                        SMEM_PER_SM // (dyn + _STATIC_SMEM)))
    blocks = max(1, min(per_sm * _sm_count(index),
                        -(-rows // KERNEL_TILE_ROWS)))
    f32 = dict(dtype=torch.float32, device=dev)
    part_grad = torch.empty((blocks, d), **f32)
    part_loss = torch.empty((blocks,), dtype=torch.float64, device=dev)
    part_cnt = torch.empty((blocks,), dtype=torch.float64, device=dev)
    grad = torch.empty((d,), **f32)
    loss = torch.empty((), **f32)
    cnt = torch.empty((), **f32)
    vec = _vector_width(d, X.element_size(), X.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tsgd_fused_sums(
            family, _DTYPES[X.dtype], index, vec, X.data_ptr(), y.data_ptr(),
            w.data_ptr(), None if mask is None else mask.data_ptr(),
            None if start is None else start.data_ptr(), start_scale,
            n, rows, d, int(_w_in_smem(d)), blocks,
            part_grad.data_ptr(), part_loss.data_ptr(), part_cnt.data_ptr(),
            grad.data_ptr(), loss.data_ptr(), cnt.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            "fused_sums kernel launch failed: "
            f"{lib.tsgd_error_string(rc).decode()} (cudaError {rc})")
    count_launch(source="fused_sums")
    return grad, loss, cnt


#: (device index, d, stream) -> the window kernel's partials; each call's
#: kernels finish with them before the next call on the stream starts
_WINDOW_SCRATCH: dict = {}


def _window_scratch(index: int, d: int, parts: int, stream: int):
    """At least ``parts`` rows of partials (plans of one width differ in
    blocks an SM by element type, so a cached scratch may be too short).

    Under CUDA graph capture the scratch is the graph's own, allocated
    from its private memory pool: a cached scratch may be replaced by a
    longer one later and freed while the graph still holds its
    pointer."""
    dev = torch.device("cuda", index)
    fresh = lambda: (  # noqa: E731
        torch.empty((parts, d), dtype=torch.float32, device=dev),
        torch.empty((parts,), dtype=torch.float64, device=dev),
        torch.empty((parts,), dtype=torch.float64, device=dev))
    if torch.cuda.is_current_stream_capturing():
        return fresh()
    key = (index, d, stream)
    with _COUNTS_LOCK:
        scratch = _WINDOW_SCRATCH.get(key)
        if scratch is None or scratch[0].shape[0] < parts:
            scratch = _WINDOW_SCRATCH[key] = fresh()
        return scratch


def _launch_window(pointwise, X, y, w, valid, start, start_scale, rows,
                   plan: StagePlan, gather: bool = False):
    """``csrc/window_sums.cu`` on the current stream; returns device tensors
    ``(grad (d,), loss (), count ())``.  Does not synchronise.  The window
    entry sums rows ``[s, s + rows)`` from ``s = clamp(start *
    start_scale)`` (``start`` None: 0) where ``valid`` is not 0; with
    ``gather`` the gather entry sums the rows of ``[0, n)`` that the mask
    ``valid`` keeps."""
    family = _family_of(pointwise)
    y, w, valid = _operands(X, y, w, valid)
    n, d = X.shape
    dev = X.device
    lib = _window_library()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    parts = max(1, _sm_count(index) * plan.blocks_per_sm // plan.cluster)
    # one fresh buffer a call for the outputs: grad, then loss and count
    out = torch.empty((d + 2,), dtype=torch.float32, device=dev)
    grad, loss, cnt = out[:d], out[d], out[d + 1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    # held from the scratch lookup until both kernels are queued: every
    # call on this stream shares the scratch, and another thread's call
    # queued between this call's two kernels would overwrite its partials
    with _COUNTS_LOCK:
        part_grad, part_loss, part_cnt = _window_scratch(index, d, parts,
                                                         stream)
        sums = (part_grad.data_ptr(), part_loss.data_ptr(),
                part_cnt.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * d,
                out.data_ptr() + 4 * d + 4, stream)
        if gather:
            fn = lib.tsgd_gather_sums
            args = (family, _DTYPES[X.dtype], index, X.data_ptr(),
                    y.data_ptr(), w.data_ptr(), valid.data_ptr(), n, d,
                    plan.stage_rows, plan.stages, plan.cluster, parts, *sums)
        else:
            fn = lib.tsgd_window_sums
            args = (family, _DTYPES[X.dtype], index, X.data_ptr(),
                    y.data_ptr(), w.data_ptr(),
                    None if valid is None else valid.data_ptr(),
                    None if start is None else start.data_ptr(), start_scale,
                    n, rows, d, plan.stage_rows, plan.stages, plan.cluster,
                    parts, *sums)
        # the kernels launch on the current device: make it X's
        if torch.cuda.current_device() == index:
            rc = fn(*args)
        else:
            with torch.cuda.device(dev):
                rc = fn(*args)
        if rc == 0:
            count_launch(source="window_sums")
    if rc != 0:
        raise RuntimeError(
            "window_sums kernel launch failed: "
            f"{lib.tsgd_window_error_string(rc).decode()} (cudaError {rc})")
    return grad, loss, cnt


def _vector_width(d: int, itemsize: int, ptr: int) -> int:
    """Elements per load: 16 bytes' worth, or 8 when 16-byte chunks would
    leave more than half of the block's 256 threads without a column chunk
    in the kernel's column pass, or 1 when d (or the base address) does
    not allow aligned vector loads."""
    for nbytes in (16, 8):
        vec = nbytes // itemsize
        if d % vec == 0 and ptr % nbytes == 0 and (
                nbytes == 8 or d // vec >= _THREADS // 2):
            return vec
    return 1


def _start_tensor(start, dev) -> Tensor:
    """The window start as a 1-element int64 tensor on ``dev``; a device
    tensor stays on the device (no host read)."""
    if isinstance(start, Tensor):
        if start.numel() != 1:
            raise ValueError("the window start must be a scalar")
        return start.to(device=dev, dtype=torch.int64).reshape(1)
    # a fill: a tensor made from a host value would copy it from pageable
    # memory, which a CUDA graph capture forbids
    return torch.full((1,), int(start), dtype=torch.int64, device=dev)


# -- plain versions ---------------------------------------------------------

def fused_gradient_sums_plain(pointwise, X, y, w, mask=None):
    """Plain PyTorch ``(grad_sum, loss_sum, count)``: ``margins_of`` ->
    pointwise -> mask -> ``grad_sum_of``, in chunks of
    ``PLAIN_CHUNK_ROWS`` rows (one chunk at test sizes)."""
    n = X.shape[0]
    acc = acc_dtype(matmul_dtype(X))
    grad = torch.zeros(w.shape, dtype=acc, device=X.device)
    loss = torch.zeros((), dtype=acc, device=X.device)
    count = torch.zeros((), dtype=acc, device=X.device)
    for s in range(0, max(n, 1), PLAIN_CHUNK_ROWS):
        Xc, yc = X[s:s + PLAIN_CHUNK_ROWS], y[s:s + PLAIN_CHUNK_ROWS]
        margins = margins_of(Xc, w)
        coeff, losses = pointwise(margins, yc.to(margins.dtype))
        if mask is not None:
            m = mask[s:s + PLAIN_CHUNK_ROWS].to(margins.dtype)
            coeff = coeff * m
            losses = losses * m
            count = count + torch.sum(m)
        else:
            count = count + Xc.shape[0]
        grad = grad + grad_sum_of(coeff, Xc)
        loss = loss + torch.sum(losses)
    return grad, loss, count


def fused_window_sums_plain(pointwise, X, y, w, start_tile, num_tiles,
                            tile_m=2048, valid=None):
    """Plain version of the window sums: rows ``[s, s + num_tiles *
    tile_m)`` from ``s = start_tile * tile_m``, placed as
    :func:`~tpu_sgd_torch.ops.gradients._clamp_start` places it (read on
    the host)."""
    m = num_tiles * tile_m
    s = _clamp_start(int(start_tile) * tile_m, X.shape[0], m)
    mask = None if valid is None else valid[s:s + m]
    return fused_gradient_sums_plain(pointwise, X[s:s + m], y[s:s + m], w,
                                     mask)


# -- the wrappers -------------------------------------------------------------

def fused_gradient_sums(
    pointwise,
    X: Tensor,
    y: Tensor,
    w: Tensor,
    mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused ``(grad_sum, loss_sum, count)`` over all rows of ``X``.

    ``pointwise`` is a built-in ``Gradient``'s bound ``pointwise``;
    ``mask`` (bool, ``(n,)``) drops rows, and the kernel never reads a
    dropped row.  On the card the call goes by the module's shape rule
    (:func:`gradient_sums_route`).  The JAX function's ``tile_m`` and
    ``interpret`` have no counterpart: the kernels' row tiles are fixed,
    rows need no padding, and there is no interpret mode (CPU tensors take
    the plain version).
    """
    if not X.is_cuda:
        return fused_gradient_sums_plain(pointwise, X, y, w, mask)
    route = gradient_sums_route(X, mask is not None)
    n = X.shape[0]
    if route == "fused_sums":
        out = _launch(pointwise, X, y, w, mask, None, 1, n)
    else:
        out = _launch_window(pointwise, X, y, w, mask, None, 1, n,
                             window_plan_for(X), gather=route == "gather")
    count_launch(fused_gradient_sums, route=route)
    return out


def gradient_sums_route(X: Tensor, masked: bool) -> str:
    """The kernel a CUDA call of :func:`fused_gradient_sums` on X
    launches: ``"gather"`` (``window_sums.cu``'s gather entry) for a mask
    and ``"window"`` (its window entry over rows ``[0, n)``) without one,
    when X has a ring plan (:func:`window_plan_for`); else
    ``"fused_sums"`` (``csrc/fused_sums.cu``).  Shapes alone decide."""
    if window_plan_for(X) is None:
        return "fused_sums"
    return "gather" if masked else "window"


def _window(counter, pointwise, X, y, w, start_tile, num_tiles, tile_m,
            valid):
    if X.shape[0] % tile_m:
        raise ValueError(
            f"fused_window_sums needs rows ({X.shape[0]}) to be a multiple "
            f"of the tile size ({tile_m}); pad the dataset or use a "
            "smaller tile"
        )
    if num_tiles * tile_m > X.shape[0]:
        raise ValueError(
            f"a window of {num_tiles} x {tile_m} rows is longer than X "
            f"({X.shape[0]} rows)")
    if not X.is_cuda:
        return fused_window_sums_plain(pointwise, X, y, w, start_tile,
                                       num_tiles, tile_m, valid)
    start = _start_tensor(start_tile, X.device)
    rows = num_tiles * tile_m
    plan = window_plan_for(X)
    if plan is not None:
        out = _launch_window(pointwise, X, y, w, valid, start, tile_m, rows,
                             plan)
    else:
        out = _launch(pointwise, X, y, w, valid, start, tile_m, rows)
    count_launch(counter)
    return out


def window_plan_for(X: Tensor) -> Optional[StagePlan]:
    """The window kernel's plan for X, or ``None`` when X's windows go to
    ``csrc/fused_sums.cu``: X's width has no plan on X's base, or the base
    is not aligned to X's element size.  The base's 16-byte alignment
    picks the row layout, and with it the plan (:func:`window_row_pitch`),
    as the kernel picks its instance."""
    if X.dim() != 2 or X.dtype not in _DTYPES:
        return None
    ptr, itemsize = X.data_ptr(), X.element_size()
    if ptr % itemsize:
        return None
    return window_stage_plan(X.shape[1], itemsize, ptr % 16 == 0)


def fused_window_sums(
    pointwise,
    X: Tensor,
    y: Tensor,
    w: Tensor,
    start_tile,
    num_tiles: int,
    tile_m: int = 2048,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused sums over ``num_tiles`` consecutive tiles of ``tile_m`` rows
    from tile ``start_tile`` (a device scalar tensor or an int), read in
    place from the full X; ``count = num_tiles * tile_m`` without
    ``valid``.  ``X.shape[0]`` must be a multiple of ``tile_m``.  The start
    row is placed as ``lax.dynamic_slice`` places it (negative counts from
    the end, then clamped so the window stays in bounds), so ``tile_m=1``
    gives exactly ``Gradient.window_sums``.  ``valid`` (bool, ``(n,)``, indexed by
    absolute row) masks rows inside the window."""
    return _window(fused_window_sums, pointwise, X, y, w, start_tile,
                   num_tiles, tile_m, valid)


def fused_window_sums_vpu(
    pointwise,
    X: Tensor,
    y: Tensor,
    w: Tensor,
    start_tile,
    num_tiles: int,
    tile_m: int = 2048,
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The counterpart of the JAX package's VPU-reduction window kernel.
    Same contract as :func:`fused_window_sums` and, on Hopper, the same
    kernel (see the module docstring); it keeps its own launch count."""
    return _window(fused_window_sums_vpu, pointwise, X, y, w, start_tile,
                   num_tiles, tile_m, valid)


# -- the CSR products (csrc/csr_products.cu) -----------------------------------

#: most right-hand columns the CSR kernel takes (the line searches' 25 and
#: 30 trial points and the multinomial classes are far below it)
CSR_MAX_COLUMNS = 1024
#: path items (the rows' end marks and the entries) a block of the CSR
#: kernel takes: the whole of its merge-path split.  15 a thread at T = 1,
#: an odd stride, so the threads' first products in shared memory fall in
#: different banks, all loaded in one round
CSR_BLOCK_ITEMS = 3840
#: the share under a row mask, which leaves most of a block's entries
#: unread, on a matrix large enough: twice the items, so half the blocks
#: pay the fixed cost of finding their rows
CSR_MASKED_BLOCK_ITEMS = 2 * CSR_BLOCK_ITEMS
#: the fewest blocks of CSR_MASKED_BLOCK_ITEMS for which a masked call
#: takes that share: with fewer, the card holds most blocks at once, and a
#: call costs about one block's time, which the longer share lengthens
CSR_MASKED_MIN_BLOCKS = 2048
#: threads a block of the CSR kernel (``tsgd_csr_block_threads``)
CSR_BLOCK_THREADS = 256


def _bind_csr(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csr_products.cu`` and check
    that its block is the one this module's mirror assumes."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tsgd_csr_matmul.argtypes = [i, p, p, p, p, i, p, ll, ll, ll, p, p, p]
    lib.tsgd_csr_matmul.restype = ctypes.c_int
    for name in ("tsgd_csr_block_threads", "tsgd_csr_thread_items"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.tsgd_csr_error_string.argtypes = [ctypes.c_int]
    lib.tsgd_csr_error_string.restype = ctypes.c_char_p
    threads = lib.tsgd_csr_block_threads()
    items = lib.tsgd_csr_thread_items()
    if threads != CSR_BLOCK_THREADS or CSR_BLOCK_ITEMS != threads * items:
        raise RuntimeError(
            f"csr_products.cu takes {threads} threads of {items} items a "
            f"block, its mirror {CSR_BLOCK_THREADS} threads and "
            f"{CSR_BLOCK_ITEMS} items")
    return lib


def _csr_library() -> ctypes.CDLL:
    lib = _build.load("csr_products")
    if lib.tsgd_csr_matmul.argtypes is None:
        _bind_csr(lib)
    return lib


def csr_walker_lanes(T: int) -> Tuple[int, int]:
    """``(W, C)`` of the CSR kernel for ``T`` right-hand columns: a walker
    is W lanes (T rounded up to a power of two, at most 32), each lane
    adds C columns (``W * C >= T``), so a block has
    ``CSR_BLOCK_THREADS // W`` walkers."""
    if not 1 <= T <= CSR_MAX_COLUMNS:
        raise ValueError(f"T must be in [1, {CSR_MAX_COLUMNS}], got {T}")
    lanes = 1
    while lanes < min(T, 32):
        lanes *= 2
    cols = 1
    while lanes * cols < T:
        cols *= 2
    return lanes, cols


def csr_block_items(masked: bool, rows: int, nnz: int) -> int:
    """The CSR kernel's block share for a call on ``rows`` rows and
    ``nnz`` entries, with or without a mask (shapes alone decide it)."""
    if masked and csr_grid(rows, nnz, CSR_MASKED_BLOCK_ITEMS) \
            >= CSR_MASKED_MIN_BLOCKS:
        return CSR_MASKED_BLOCK_ITEMS
    return CSR_BLOCK_ITEMS


def csr_grid(rows: int, nnz: int, block_items: int = CSR_BLOCK_ITEMS) -> int:
    """Blocks of the CSR kernel: the ``rows + nnz`` path items in shares of
    ``block_items`` (none for a matrix without rows)."""
    if rows == 0:
        return 0
    return -(-(rows + nnz) // block_items)


def csr_carry_floats(grid: int, T: int) -> int:
    """Size in float32 of the CSR kernel's carries: a block's int64 head
    row (two floats), its head and its tail (T floats each)."""
    return grid * (2 * T + 2)


def csr_path_rows(crow, diag):
    """The merge-path search of the CSR kernel: for each diagonal (a count
    of path items), the rows whose end mark lies among its first items,
    i.e. the number of rows ``p`` with ``crow[p + 1] + p + 1 <= diag``.
    The diagonal's entry is ``diag - rows``."""
    crow = np.asarray(crow, dtype=np.int64)
    ends = crow[1:] + np.arange(1, crow.size, dtype=np.int64)
    return np.searchsorted(ends, np.asarray(diag, dtype=np.int64),
                           side="right")


class CsrSplit(NamedTuple):
    """The CSR kernel's split of one matrix (:func:`csr_split`).

    ``first_row[b]`` / ``first_entry[b]``: where block ``b`` begins on the
    path (``b = grid`` is the end); ``head_row[b]``: the row that began in
    an earlier block and ends in ``b`` (summed by the second pass), or -1;
    ``tail_row[b]``: the row ``b`` ends inside (``rows`` past the last)."""

    first_row: np.ndarray
    first_entry: np.ndarray
    head_row: np.ndarray
    tail_row: np.ndarray


def csr_split(crow, block_items: int = CSR_BLOCK_ITEMS) -> CsrSplit:
    """The blocks of the CSR kernel on a matrix with row pointers
    ``crow``, as the kernel finds them on the card."""
    crow = np.asarray(crow, dtype=np.int64)
    rows, nnz = crow.size - 1, int(crow[-1])
    grid = csr_grid(rows, nnz, block_items)
    diag = np.minimum(np.arange(grid + 1, dtype=np.int64) * block_items,
                      rows + nnz)
    first = csr_path_rows(crow, diag)
    entry = diag - first
    head = (first[:-1] < first[1:]) & (entry[:-1] > crow[first[:-1]])
    return CsrSplit(first, entry, np.where(head, first[:-1], -1), first[1:])


def _fmaf(v, x, acc):
    """fmaf, elementwise: the f32 product is exact in f64."""
    return (np.float64(v) * x.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def csr_walk(crow, col, val, rhs, mask=None, block_items=CSR_BLOCK_ITEMS):
    """The CSR kernel's arithmetic in its order, in numpy (a model for
    tests, slow): each walker's sums (of the f32 products staged at T = 1,
    fmaf chains above), the scan of the walkers' tails, the blocks' head
    and tail carries, and pass 2's strided lanes and shuffle tree.
    ``rhs`` is ``(k, T)`` float32, ``mask`` a bool array or None; returns
    the ``(rows, T)`` float32 product the card gives bit for bit."""
    S = block_items
    crow = np.asarray(crow, np.int64)
    rows, nnz = crow.size - 1, int(crow[-1])
    T = rhs.shape[1]
    W, _ = csr_walker_lanes(T)
    walkers = CSR_BLOCK_THREADS // W
    per = S // walkers
    sp = csr_split(crow, S)
    grid = sp.head_row.size
    out = np.full((rows, T), np.nan, np.float32)
    head = np.full((grid, T), np.nan, np.float32)
    tail = np.full((grid, T), np.nan, np.float32)
    zero = np.zeros(T, np.float32)
    for b in range(grid):
        d0, d1 = b * S, min(b * S + S, rows + nnz)
        rb = sp.first_row[b]
        dw0 = np.minimum(d0 + np.arange(walkers) * per, d1)
        dw1 = np.minimum(dw0 + per, d1)
        r0s = csr_path_rows(crow, dw0)
        r1s = np.append(r0s[1:], sp.first_row[b + 1])
        tails = np.zeros((walkers, T), np.float32)
        parts = {}
        for w in range(walkers):
            r0, r1 = r0s[w], r1s[w]
            e0, e1 = dw0[w] - r0, dw1[w] - r1
            e = e0
            for r in range(r0, r1 + 1):
                hi = e1 if r == r1 else crow[r + 1]
                acc = zero
                if r < rows and (mask is None or mask[r]):
                    for k in range(e, hi):
                        if W == 1:  # the staged product, then the sum
                            acc = acc + val[k] * rhs[col[k]]
                        else:
                            acc = _fmaf(val[k], rhs[col[k]], acc)
                if r < r1:
                    if r == r0 and e0 > crow[r0]:
                        parts[w] = acc
                    else:
                        out[r] = acc
                e = hi
            tails[w] = acc
        tails = _scan_tails(tails, r1s, W)
        for w, part in parts.items():
            if w > 0:
                part = tails[w - 1] + part
            if r0s[w] == rb and d0 - rb > crow[rb]:
                head[b] = part
            else:
                out[r0s[w]] = part
        tail[b] = tails[-1]
    ct = 1
    while ct < min(T, 32):
        ct *= 2
    lanes = np.arange(32)
    for b, r in enumerate(sp.head_row):
        if r < 0:
            continue
        first = (crow[r] + r) // S
        for t0 in range(0, T, ct):
            acc = np.zeros(32, np.float32)
            for lane in lanes:
                t = t0 + lane % ct
                if t < T:
                    for i in range(first + lane // ct, b, 32 // ct):
                        acc[lane] = acc[lane] + tail[i, t]
            off = 16
            while off >= ct:
                acc = acc + acc[lanes ^ off]
                off //= 2
            for tl in range(min(ct, T - t0)):
                out[r, t0 + tl] = acc[tl] + head[b, t0 + tl]
    return out


def _hillis_steele(vals, keys, span):
    """Inclusive segmented (by key) Hillis-Steele scan within runs of
    ``span`` slots: ``v[w] = v[w - d] + v[w]`` where the keys agree."""
    pos = np.arange(len(keys)) % span
    step = 1
    while step < span:
        same = (keys[:-step] == keys[step:]) & (pos[step:] >= step)
        new = vals.copy()
        new[step:][same] = vals[:-step][same] + vals[step:][same]
        vals, step = new, 2 * step
    return vals


def _scan_tails(tails, keys, W):
    """The kernel's scan of its walkers' tails.  T = 1 (one thread a
    walker): each warp's 32 by shuffles, then the warps' totals chained in
    warp order and added where a walker's run began in an earlier warp;
    T > 1: one Hillis-Steele scan over all the block's walkers."""
    if W > 1:
        return _hillis_steele(tails, keys, len(keys))
    v = _hillis_steele(tails, keys, 32)
    run, out = None, v.copy()
    for k in range(len(keys) // 32):
        last = 32 * k + 31
        if k > 0:
            same = keys[32 * k:last + 1] == keys[last - 32]
            out[32 * k:last + 1][same] = run + v[32 * k:last + 1][same]
        run = out[last]
    return out


def csr_matmul_plain(X: Tensor, rhs: Tensor,
                     mask: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch ``X @ rhs`` of a CSR ``X`` at the accumulation dtype
    (the values promote, as the JAX package's BCOO products promote them),
    with the rows that ``mask`` drops set to 0."""
    acc = acc_dtype(matmul_dtype(X))
    out = X.to(acc) @ rhs.to(acc)
    if mask is not None:
        keep = mask.reshape((-1,) + (1,) * (out.dim() - 1))
        out = torch.where(keep, out, torch.zeros((), dtype=out.dtype))
    return out


def _csr_operands(X: Tensor, rhs: Tensor, mask: Optional[Tensor]):
    """The CSR kernel's shape rule; raises on anything outside it: X a
    CSR tensor with float32 values and int32 or int64 indices, ``rhs``
    on X's device with X's column count as its first dimension and at
    most ``CSR_MAX_COLUMNS`` columns (taken as float32), ``mask`` bool
    with one entry a row."""
    if X.layout != torch.sparse_csr or X.dim() != 2:
        raise ValueError(
            f"the CSR kernel takes a 2-D sparse CSR X, got {X.layout} "
            f"with shape {tuple(X.shape)}")
    rows, k = X.shape
    vals = X.values()
    if vals.dtype != torch.float32:
        raise TypeError(
            f"the CSR kernel takes float32 values, got {vals.dtype}")
    crow, col = X.crow_indices(), X.col_indices()
    if crow.dtype != col.dtype or crow.dtype not in (torch.int32,
                                                     torch.int64):
        raise TypeError(
            f"the CSR kernel takes int32 or int64 indices, got "
            f"{crow.dtype} / {col.dtype}")
    if rhs.device != X.device:
        raise ValueError(f"rhs is on {rhs.device}, X on {X.device}")
    if rhs.dim() not in (1, 2) or rhs.shape[0] != k:
        raise ValueError(
            f"rhs must have shape ({k},) or ({k}, T), got "
            f"{tuple(rhs.shape)}")
    T = 1 if rhs.dim() == 1 else rhs.shape[1]
    if not 1 <= T <= CSR_MAX_COLUMNS:
        raise ValueError(
            f"the CSR kernel takes 1 to {CSR_MAX_COLUMNS} right-hand "
            f"columns, got {T}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (rows,) \
                or mask.device != X.device:
            raise TypeError(
                f"mask must be a bool tensor of shape ({rows},) on "
                f"{X.device}, got {mask.dtype} {tuple(mask.shape)} on "
                f"{mask.device}")
    return crow, col, vals.contiguous(), \
        rhs.to(torch.float32).contiguous(), T


def _csr_launch(X: Tensor, rhs: Tensor, mask: Optional[Tensor]) -> Tensor:
    """The two passes of ``csrc/csr_products.cu`` on the current stream;
    returns the ``(rows,)`` or ``(rows, T)`` float32 product.  Allocates
    the output and the carries, both sized from shapes, and nothing else;
    reads nothing back, so a call can be captured in a CUDA graph."""
    crow, col, vals, rhs_c, T = _csr_operands(X, rhs, mask)
    if mask is not None:
        mask = mask.contiguous()
    lib = _csr_library()
    rows, nnz = X.shape[0], X._nnz()
    dev = X.device
    block_items = csr_block_items(mask is not None, rows, nnz)
    grid = csr_grid(rows, nnz, block_items)
    out = torch.empty((rows, T) if rhs.dim() == 2 else (rows,),
                      dtype=torch.float32, device=dev)
    carries = torch.empty((csr_carry_floats(grid, T),), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tsgd_csr_matmul(
            crow.element_size(), crow.data_ptr(), col.data_ptr(),
            vals.data_ptr(), rhs_c.data_ptr(), T,
            None if mask is None else mask.data_ptr(), rows, nnz,
            block_items, carries.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(
            "csr_products kernel launch failed: "
            f"{lib.tsgd_csr_error_string(rc).decode()} (cudaError {rc})")
    return out


def csr_margins(X: Tensor, rhs: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
    """Margins ``X @ rhs`` of a CSR ``X`` (``rhs`` the weights ``(d,)``, or
    ``Wᵀ`` ``(d, T)``), float32; a row that ``mask`` drops is 0 and its
    entries are never read.  On a CUDA X, one call of the deterministic
    CSR kernel (``csrc/csr_products.cu``: two launches, shape rule in
    :func:`_csr_operands`); on a CPU X, :func:`csr_matmul_plain`."""
    if not X.is_cuda:
        return csr_matmul_plain(X, rhs, mask)
    out = _csr_launch(X, rhs, mask)
    _count_csr(csr_margins, rhs)
    return out


def csr_grad_sum(Xt: Tensor, coeff: Tensor) -> Tensor:
    """The gradient sum ``Xᵀ @ coeff`` from X's transposed CSR ``Xt``
    (``ops/sparse.py`` ``transpose_csr``), ``(d,)`` or ``(d, T)`` float32.
    On a CUDA ``Xt``, one call of the CSR kernel; on the CPU, the plain
    version."""
    if not Xt.is_cuda:
        return csr_matmul_plain(Xt, coeff)
    out = _csr_launch(Xt, coeff, None)
    _count_csr(csr_grad_sum, coeff)
    return out


def _count_csr(fn, rhs: Tensor) -> None:
    """One launch of a CSR wrapper, counted in all and by its right-hand
    column count."""
    count_launch(fn, csr_columns=f"{fn.__name__}/"
                 f"{1 if rhs.dim() == 1 else rhs.shape[1]}")


fused_gradient_sums.launches = 0
fused_window_sums.launches = 0
fused_window_sums_vpu.launches = 0
csr_margins.launches = 0
csr_grad_sum.launches = 0
WRAPPERS = (fused_gradient_sums, fused_window_sums, fused_window_sums_vpu)
#: the CSR kernel's wrappers (one source, ``csrc/csr_products.cu``),
#: counted apart from the dense kernels' so that a count of the dense
#: path stays exactly theirs
CSR_WRAPPERS = (csr_margins, csr_grad_sum)
#: launches by CUDA source (csrc/<name>.cu), counted where each launches
KERNEL_LAUNCHES = {"fused_sums": 0, "window_sums": 0}
#: fused_gradient_sums's launches by route (gradient_sums_route)
GRADIENT_ROUTE_LAUNCHES = {"gather": 0, "window": 0, "fused_sums": 0}
#: the CSR wrappers' launches by right-hand column count T, keyed
#: ``"<wrapper>/<T>"`` (OWL-QN's line-search sweep is ``"csr_margins/30"``)
CSR_COLUMN_LAUNCHES = {}
#: library products of the 2-D mesh's margin-combined sums
#: (``gradients.margin_combined_sums``: the margins and the gradient, two
#: a call), which run no kernel of this module
MODEL_AXIS_PRODUCTS = {"products": 0}


#: the records of the captures open on each thread, innermost last
#: (:func:`captured_launches`)
_CAPTURES = threading.local()


def _open_record() -> Optional[dict]:
    """The record of the innermost capture open on this thread, if any."""
    stack = getattr(_CAPTURES, "stack", None)
    return stack[-1] if stack else None


def count_launch(wrapper=None, source: Optional[str] = None,
                 route: Optional[str] = None,
                 csr_columns: Optional[str] = None) -> None:
    """Add one launch to a wrapper's ``launches``, to a CUDA source's
    count, to a :func:`fused_gradient_sums` route's and to a CSR
    wrapper's ``"<wrapper>/<T>"`` count, each given one, under the one
    lock of the counts; inside a capture on this thread, to the capture's
    record instead (the capture launches nothing)."""
    rec = _open_record()
    with _COUNTS_LOCK:
        if rec is not None:
            if wrapper is not None:
                rec["wrappers"][wrapper.__name__] += 1
            if source is not None:
                rec["sources"][source] += 1
            if route is not None:
                rec["routes"][route] += 1
            if csr_columns is not None:
                cols = rec["csr_columns"]
                cols[csr_columns] = cols.get(csr_columns, 0) + 1
            return
        if wrapper is not None:
            wrapper.launches += 1
        if source is not None:
            KERNEL_LAUNCHES[source] += 1
        if route is not None:
            GRADIENT_ROUTE_LAUNCHES[route] += 1
        if csr_columns is not None:
            CSR_COLUMN_LAUNCHES[csr_columns] = (
                CSR_COLUMN_LAUNCHES.get(csr_columns, 0) + 1)


def count_model_axis_products(n: int) -> None:
    rec = _open_record()
    with _COUNTS_LOCK:
        counts = MODEL_AXIS_PRODUCTS if rec is None else rec["model_axis"]
        counts["products"] += int(n)


def model_axis_product_counts() -> int:
    """Library products of the 2-D mesh's sums since the last reset."""
    return MODEL_AXIS_PRODUCTS["products"]


def reset_launch_counts() -> None:
    with _COUNTS_LOCK:
        for fn in WRAPPERS + CSR_WRAPPERS:
            fn.launches = 0
        for counts in (KERNEL_LAUNCHES, GRADIENT_ROUTE_LAUNCHES,
                       MODEL_AXIS_PRODUCTS):
            for name in counts:
                counts[name] = 0
        CSR_COLUMN_LAUNCHES.clear()


def launch_counts() -> dict:
    """Launches of the dense kernels' wrappers since the last reset."""
    with _COUNTS_LOCK:
        return {fn.__name__: fn.launches for fn in WRAPPERS}


def csr_launch_counts(by_columns: bool = False) -> dict:
    """Launches of the CSR kernel's wrappers since the last reset; by
    wrapper and right-hand column count with ``by_columns``."""
    with _COUNTS_LOCK:
        if by_columns:
            return dict(CSR_COLUMN_LAUNCHES)
        return {fn.__name__: fn.launches for fn in CSR_WRAPPERS}


def kernel_launch_counts() -> dict:
    """Launches of the dense sources since the last reset: which kernel
    ran (the CSR source's are :func:`csr_launch_counts`)."""
    with _COUNTS_LOCK:
        return dict(KERNEL_LAUNCHES)


def gradient_route_counts() -> dict:
    """:func:`fused_gradient_sums`'s launches since the last reset, by the
    route each took: the gather or window entry of ``window_sums.cu``, or
    ``fused_sums.cu``."""
    with _COUNTS_LOCK:
        return dict(GRADIENT_ROUTE_LAUNCHES)


@contextlib.contextmanager
def captured_launches():
    """Bracket a CUDA graph capture: the wrappers run and count as they
    would launch, but a capture launches nothing.  Yields the capture's
    record (``{"wrappers": {...}, "sources": {...}, "routes": {...},
    "model_axis": {...}, "csr_columns": {...}}``): what this thread
    counts inside the bracket goes there and not into the counts, and
    each replay adds it (:func:`add_replayed_launches`).  So a count
    stays one per kernel the card runs, whatever other threads launch
    meanwhile."""
    with _COUNTS_LOCK:
        record = {"wrappers": {fn.__name__: 0
                               for fn in WRAPPERS + CSR_WRAPPERS},
                  "sources": dict.fromkeys(KERNEL_LAUNCHES, 0),
                  "routes": dict.fromkeys(GRADIENT_ROUTE_LAUNCHES, 0),
                  "model_axis": dict.fromkeys(MODEL_AXIS_PRODUCTS, 0),
                  "csr_columns": {}}
    stack = _CAPTURES.__dict__.setdefault("stack", [])
    stack.append(record)
    try:
        yield record
    finally:
        stack.pop()


def add_replayed_launches(record: dict) -> None:
    """One replay of a graph whose capture recorded ``record``: the
    kernels it launches, counted by wrapper, by source and by route."""
    with _COUNTS_LOCK:
        for fn in WRAPPERS + CSR_WRAPPERS:
            fn.launches += record["wrappers"][fn.__name__]
        for name, n in record["sources"].items():
            KERNEL_LAUNCHES[name] += n
        for name, n in record["routes"].items():
            GRADIENT_ROUTE_LAUNCHES[name] += n
        for name, n in record["model_axis"].items():
            MODEL_AXIS_PRODUCTS[name] += n
        for key, n in record["csr_columns"].items():
            CSR_COLUMN_LAUNCHES[key] = CSR_COLUMN_LAUNCHES.get(key, 0) + n


class FusedGradient(Gradient):
    """Wrap a built-in Gradient with the fused kernels' tiled routing —
    the counterpart of ``PallasGradient``.

    ``batch_sums`` goes to :func:`fused_gradient_sums` when X is dense and
    to the base gradient's sparse path when it is not (as
    ``PallasGradient`` sends BCOO to the XLA path); ``window_sums``
    (``sampling="sliced"``) to :func:`fused_window_sums`, or to
    :func:`fused_window_sums_vpu` with ``window_kernel="vpu"``, when X is
    dense, ``valid is None``, ``m >= tile_m`` and ``n % tile_m == 0``;
    otherwise to the base gradient's ``window_sums``.  On CPU tensors every
    route computes with the plain versions.

    Window-alignment caveat (kept from ``PallasGradient``): on the tiled
    route ``window_sums`` floors ``start`` to a ``tile_m`` boundary and
    clamps it to ``(n - m) // tile_m`` tiles, so for a start that is not
    tile-aligned it sums a *different, equally sized* window than the base
    ``Gradient.window_sums``.  Under ``sampling="sliced"`` the start is
    uniform and rows are exchangeable, so the distribution of sampled
    windows is unchanged, but the two routes agree row for row only for
    tile-aligned starts.  Any sub-tile remainder ``m % tile_m`` is summed
    through the base path right after the tiled bulk, so exactly ``m``
    rows are processed.  The floor and clamp are device ops on the start
    tensor: nothing syncs the host.
    """

    def __init__(self, base: Gradient, tile_m: int = 2048,
                 window_kernel: str = "mxu"):
        if window_kernel not in ("mxu", "vpu"):
            raise ValueError(
                f"window_kernel must be 'mxu' or 'vpu', got {window_kernel!r}"
            )
        if tile_m < 1:
            raise ValueError(f"tile_m must be positive, got {tile_m}")
        self.base = base
        self.tile_m = int(tile_m)
        self.window_kernel = window_kernel

    @property
    def family(self):
        return self.base.family

    def pointwise(self, margin, label):
        return self.base.pointwise(margin, label)

    def weight_dim(self, num_features: int) -> int:
        return self.base.weight_dim(num_features)

    def batch_sums(self, X, y, weights, mask=None, margin_axis_name=None,
                   Xt=None):
        # a margin combine (a 2-D mesh) goes to the base path, as
        # PallasGradient sends margin_axis_name to XLA
        if margin_axis_name is not None or is_sparse(X):
            return self.base.batch_sums(
                X, y, weights, mask, margin_axis_name=margin_axis_name,
                Xt=Xt)
        return fused_gradient_sums(self.base.pointwise, X, y, weights, mask)

    def window_sums(self, X, y, weights, start, m, valid=None,
                    margin_axis_name=None):
        n = X.shape[0]
        usable = (
            not is_sparse(X)
            and margin_axis_name is None
            and valid is None
            and m >= self.tile_m
            and n % self.tile_m == 0
        )
        if not usable:
            return self.base.window_sums(
                X, y, weights, start, m, valid=valid,
                margin_axis_name=margin_axis_name)
        num_tiles = m // self.tile_m
        rem = m - num_tiles * self.tile_m
        start = _start_tensor(start, X.device)
        start_tile = torch.clamp(
            torch.div(start, self.tile_m, rounding_mode="floor"),
            max=(n - m) // self.tile_m)
        kernel = (fused_window_sums_vpu if self.window_kernel == "vpu"
                  else fused_window_sums)
        g, l, c = kernel(self.base.pointwise, X, y, weights, start_tile,
                         num_tiles, tile_m=self.tile_m)
        if rem:
            tail = (start_tile + num_tiles) * self.tile_m
            g2, l2, c2 = self.base.window_sums(X, y, weights, tail, rem)
            g, l, c = g + g2, l + l2, c + c2
        return g, l, c
