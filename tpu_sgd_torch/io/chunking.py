"""Fixed-shape chunk planning for host->device streaming: the port of
``tpu_sgd/io/chunking.py``.

The planner's one job is shape discipline: every chunk it emits has the
SAME row count, so a consumer on the card (a captured CUDA graph, a
kernel's scratch) sees one shape per run; the tail is padded with zero
rows on the HOST.  Zero rows are exact for every consumer here: they add
exact zeros to sums, and a padded step whose valid mask is all False is
a no-op update.

``round_to`` aligns the fixed shape to a consumer's block size ``B`` so
a padded tail is whole zero BLOCKS.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from tpu_sgd_torch.io.wire import as_torch_dtype, host_tensor
from tpu_sgd_torch.reliability.failpoints import failpoint


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One planned chunk: source rows ``[start, stop)`` materialized at
    the plan's fixed ``rows`` shape (``pad`` trailing zero rows)."""

    index: int
    start: int
    stop: int
    rows: int

    @property
    def valid(self) -> int:
        return self.stop - self.start

    @property
    def pad(self) -> int:
        return self.rows - self.valid


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Fixed-shape cover of host rows ``[offset, n)``: every chunk is
    ``chunk_rows`` rows (a multiple of ``round_to``); only the LAST chunk
    may carry padding, always trailing."""

    n: int
    offset: int
    chunk_rows: int
    round_to: int

    @property
    def n_chunks(self) -> int:
        span = self.n - self.offset
        return -(-span // self.chunk_rows) if span > 0 else 0

    @property
    def pad_rows(self) -> int:
        """Zero rows appended to the final chunk."""
        span = self.n - self.offset
        return self.n_chunks * self.chunk_rows - span

    def __iter__(self) -> Iterator[Chunk]:
        for i in range(self.n_chunks):
            start = self.offset + i * self.chunk_rows
            yield Chunk(index=i, start=start,
                        stop=min(start + self.chunk_rows, self.n),
                        rows=self.chunk_rows)


def plan_chunks(n: int, chunk_rows: int, *, offset: int = 0,
                round_to: int = 1) -> ChunkPlan:
    """Plan fixed-shape chunks over rows ``[offset, n)``: ``chunk_rows``
    rounded down to a multiple of ``round_to``, then clamped so a dataset
    smaller than one requested chunk gets one right-sized chunk.
    ``offset`` must be a multiple of ``round_to`` (resumed builds save at
    block boundaries)."""
    n = int(n)
    offset = int(offset)
    round_to = max(1, int(round_to))
    if not 0 <= offset <= n:
        raise ValueError(f"offset {offset} outside [0, {n}]")
    if offset % round_to:
        raise ValueError(
            f"offset {offset} is not a multiple of round_to={round_to} "
            "(resume checkpoints save at block boundaries)")
    chunk_rows = max(round_to, (int(chunk_rows) // round_to) * round_to)
    span = n - offset
    span_rounded = -(-span // round_to) * round_to  # pad only to blocks
    chunk_rows = min(chunk_rows, max(span_rounded, round_to))
    return ChunkPlan(n=n, offset=offset, chunk_rows=chunk_rows,
                     round_to=round_to)


def stack_superchunk(xs: Sequence, ys: Sequence, valids: Sequence,
                     k: Optional[int] = None, out=None):
    """Stack per-step host batches into ONE ``(K, ...)`` *superchunk*.

    The superstep executor's host stage: K consecutive iterations'
    cap-shaped batches become one buffer per leaf, so the host->device
    hop is one copy per leaf a superstep.  The output shape is FIXED at
    ``k`` steps: when fewer than ``k`` batches are passed (a run's tail),
    the missing steps stay zero rows with all-False valid masks, which
    the step's empty-batch rule turns into no-op updates.

    ``out`` (three CPU tensors of shape ``(k,) + batch.shape``, e.g. a
    pinned staging slot) receives the stack in place; a batch that is
    already the matching row of ``out`` (the streamed drivers assemble
    each step straight into its row) is not copied again.  Passes the
    ``io.superstep`` failpoint.  Returns ``(Xs, Ys, Vs)``."""
    failpoint("io.superstep")
    if not xs or len(xs) != len(ys) or len(xs) != len(valids):
        raise ValueError(
            f"need matching non-empty batch lists, got "
            f"{len(xs)}/{len(ys)}/{len(valids)}")
    k = len(xs) if k is None else int(k)
    if k < len(xs):
        raise ValueError(f"{len(xs)} batches do not fit k={k} steps")
    xs = [host_tensor(a) for a in xs]
    ys = [host_tensor(a) for a in ys]
    valids = [host_tensor(a) for a in valids]
    if out is None:
        out = (torch.zeros((k,) + tuple(xs[0].shape), dtype=xs[0].dtype),
               torch.zeros((k,) + tuple(ys[0].shape), dtype=ys[0].dtype),
               torch.zeros((k,) + tuple(valids[0].shape), dtype=torch.bool))
    Xs, Ys, Vs = out
    for t, parts in enumerate(zip(xs, ys, valids)):
        for dst, src in zip((Xs[t], Ys[t], Vs[t]), parts):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
    for dst in (Xs, Ys, Vs):
        dst[len(xs):].zero_()
    return Xs, Ys, Vs


def pad_rows(a, rows: int, dtype=None) -> torch.Tensor:
    """Fixed-shape host padding (+ optional wire cast): ``a`` itself
    (zero-copy) when it already has ``rows`` rows and the target dtype,
    else a ``rows``-row zero buffer of the target dtype with ``a`` copied
    in (the pad and the cast are one host pass)."""
    a = host_tensor(a)
    dt = a.dtype if dtype is None else as_torch_dtype(dtype)
    if a.shape[0] == rows and a.dtype == dt:
        return a
    if a.shape[0] > rows:
        raise ValueError(f"{a.shape[0]} rows do not fit a {rows}-row chunk")
    out = torch.zeros((rows,) + tuple(a.shape[1:]), dtype=dt)
    out[: a.shape[0]] = a
    return out
