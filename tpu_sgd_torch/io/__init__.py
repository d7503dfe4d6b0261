"""The host->device ingest layer: the port of ``tpu_sgd/io``.

Every host-streamed path cuts a host-resident dataset into fixed-shape
batches, moves each to the card, and hands it to a step there:

* :mod:`~tpu_sgd_torch.io.chunking`: fixed-shape chunk plans and the
  K-step superchunk (zero-row tails), so the card sees one shape a run;
* :mod:`~tpu_sgd_torch.io.prefetch`: the worker-thread prefetcher and the
  pinned staging ring (copies on a side stream, READY and FREE events);
* :mod:`~tpu_sgd_torch.io.wire`: the opt-in bf16 wire (torch's bf16, no
  ``ml_dtypes``);
* :mod:`~tpu_sgd_torch.io.sparse_wire`: top-k with error feedback, and the
  fixed ``(row_cap, nse_cap)`` CSR batches of the sparse feed;
* :mod:`~tpu_sgd_torch.io.integrity`: checksummed frames verified at the
  consume site.
"""

from tpu_sgd_torch.io.chunking import (Chunk, ChunkPlan, pad_rows,
                                       plan_chunks, stack_superchunk)
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.sparse_wire import (ErrorFeedback,
                                          merge_sparse_segments,
                                          parse_wire_compress,
                                          plan_sparse_batches,
                                          stage_sparse_batch, topk_nnz,
                                          topk_select)
from tpu_sgd_torch.io.wire import resolve_wire_dtype, wire_cast

#: default lookahead of every pipelined streaming path (double buffer)
DEFAULT_PREFETCH_DEPTH = 2

__all__ = [
    "Chunk", "ChunkPlan", "DEFAULT_PREFETCH_DEPTH", "ErrorFeedback",
    "PinnedRing", "Prefetcher", "merge_sparse_segments", "pad_rows",
    "parse_wire_compress",
    "plan_chunks", "plan_sparse_batches", "resolve_wire_dtype",
    "ring_slots", "stack_superchunk", "stage_sparse_batch", "topk_nnz",
    "topk_select", "wire_cast",
]
