"""Host-streamed full-batch cost evaluation for the quasi-Newton optimizers:
the port of ``tpu_sgd/optimize/streamed_costfun.py`` (one device, or a
data mesh).

The reference's L-BFGS ``CostFun`` takes the full-batch ``(loss,
gradient)`` in one ``treeAggregate`` over data of any size, for any
``Gradient``.  Here the rows stay in host memory (a numpy array, or a CPU
tensor of any float dtype, bf16 included) and every evaluation streams
them through the card in a fixed grid of chunks, adding each chunk's
``(grad_sum, loss_sum, count)`` into accumulators on the card: the
chunked treeAggregate.  It works for any gradient with ``batch_sums``
(least squares, logistic, hinge, multinomial's flat matrix weights); the
line-search sweep streams ``loss_sweep`` the same way.

The feed: :class:`~tpu_sgd_torch.io.prefetch.Prefetcher`'s worker copies
chunk ``i+1`` into a pinned slot of a
:class:`~tpu_sgd_torch.io.prefetch.PinnedRing` and sends it on a side
stream while the card runs chunk ``i`` (two slots; the ring's READY and
FREE events order the reuse).  The grid is fixed: ``cap = min(batch_rows,
n)`` rows a chunk.  Full chunks take B1's unmasked launch
(``mask=None``); the tail is zero-padded to ``cap`` once, in a pinned
buffer kept for the instance's life, and takes the launch masked by its
valid rows, so the sums stay exact.  The order of the additions is fixed,
so two evaluations of the same weights are bitwise equal.  Int and bool
features arrive as f32 (the slot's dtype), as ``optimize()`` coerces
them; labels as f32.

Cost: every evaluation re-reads the whole dataset over the host feed (an
L-BFGS iteration is one cost evaluation and one sweep), so this is the
schedule of last resort, for losses without fixed-size statistics.

On a data mesh (``mesh``, ``k`` ranks) the JAX package's two chunk grids:

* the ranks lie on one host (the JAX package's one process): every rank
  passes the SAME whole host dataset (a file every rank maps, never a
  private copy), the chunk cap is padded up to a multiple of ``k``, and
  rank ``r`` takes rows ``[r·cap/k, (r+1)·cap/k)`` of each chunk: full
  shares B1 unmasked, a partial or empty share (past the last row)
  zero-padded and masked;
* the ranks lie on several hosts (``parallel.mesh.mesh_spans_processes``;
  a CPU test may declare the split, ``data_mesh(hosts=...)``): each rank
  passes its LOCAL rows and streams ``cap/k`` of them a chunk, on a grid
  agreed by one gather of the row counts (the longest rank's chunks); a
  rank whose rows have run out, or that has none, feeds all-invalid
  chunks, so every rank runs the same number of combines and none waits
  for ever.

Either way each rank adds its chunks' sums on its card and the ranks'
sums combine ONCE an evaluation, in rank order
(``parallel.mesh.combine``): the same bits on every rank, equal to a
one-process rank-order sum of the ranks' accumulated sums.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.parallel.mesh import (
    Mesh,
    as_data_mesh,
    collective_device,
    combine,
    mesh_spans_processes,
)
from tpu_sgd_torch.io import DEFAULT_PREFETCH_DEPTH
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.wire import host_tensor

#: default host->device chunk budget in bytes
_DEFAULT_CHUNK_BYTES = 256e6


def default_stream_batch_rows(d: int, itemsize: int,
                              chunk_bytes: Optional[float] = None) -> int:
    """Rows per streamed chunk at a byte budget (default ~256 MB): the JAX
    package's chunk-sizing policy, shared with ``plan.plan_quasi_newton``,
    which sizes a planned run's chunk from the device budget (an unplanned
    run takes the 256 MB default)."""
    if chunk_bytes is None:
        chunk_bytes = _DEFAULT_CHUNK_BYTES
    return max(1024, int(chunk_bytes // max(1, d * itemsize)))


class StreamedCostFun:
    """Chunked full-batch ``(loss, grad)`` and loss-sweep evaluator over
    host-resident rows.

    Returns RAW SUMS on the card, ``(grad_sum, loss_sum, count)`` and
    ``(loss_sums, count)``, as ``Gradient.batch_sums`` and ``loss_sweep``
    do (on a mesh, every rank's, combined); callers normalize and add
    their regularization.  One instance binds ``(gradient, X, y,
    batch_rows, mesh)`` and keeps its staging ring and padded shares;
    ``device=None`` is the card.  ``cap`` is the rows of one chunk (on
    several hosts, of one rank's part of it), ``share`` this rank's rows
    of each chunk."""

    def __init__(self, gradient, X, y, batch_rows: Optional[int] = None,
                 mesh=None, device=None):
        self.gradient = gradient
        self.device = resolve_device(device)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh takes a tpu_sgd_torch.parallel.Mesh (data_mesh), got "
                f"{type(mesh).__name__}")
        self.mesh = None if mesh is None else as_data_mesh(mesh)
        self.multihost = (self.mesh is not None
                          and mesh_spans_processes(self.mesh))
        Xh = host_tensor(X)
        if Xh.dim() != 2 or (Xh.shape[0] == 0 and not self.multihost):
            # a rank of a multi-host mesh may hold no rows: it still
            # joins every combine, with all-invalid chunks
            raise ValueError(
                f"need a non-empty (n, d) matrix, got {tuple(Xh.shape)}")
        self.X = Xh.contiguous()
        self.y = host_tensor(y).contiguous()
        # the slot's dtype: int, bool and f64 rows compute in f32, as the
        # resident optimizer converts them
        xdt = Xh.dtype if Xh.dtype in (torch.float32,
                                       torch.bfloat16) else torch.float32
        n, d = Xh.shape
        self.n = n
        if batch_rows is None:
            batch_rows = default_stream_batch_rows(d, xdt.itemsize)
        k = 1 if self.mesh is None else self.mesh.size
        if self.multihost:
            from tpu_sgd_torch.parallel.data_parallel import agree

            # the grid from batch_rows alone (a cap clamped to the local
            # row count would differ between ranks) and the longest
            # rank's rows, agreed by one gather
            cap = max(1, int(batch_rows))
            cap += (-cap) % k
            self.cap = self.share = cap // k
            counts = agree(self.mesh, [n], collective_device(self.mesh))
            self.n_chunks = math.ceil(int(counts.max()) / self.share)
            self._stride, self._offset = self.share, 0
        else:
            cap = int(min(max(1, int(batch_rows)), n))
            cap += (-cap) % k  # equal shares; padding rows are invalid
            self.cap, self.share = cap, cap // k
            self.n_chunks = math.ceil(n / cap)
            self._stride = cap
            self._offset = 0 if self.mesh is None else (
                self.mesh.rank * self.share)
        self._slots = ring_slots(DEFAULT_PREFETCH_DEPTH)
        self._ring = PinnedRing({"x": ((self.share, d), xdt),
                                 "y": ((self.share,), torch.float32)},
                                self._slots, self.device)
        #: zero-padded shares by host row span: (pinned X, pinned y,
        #: valid mask on the card), built once each
        self._pads = {}

    # -- chunk feed --------------------------------------------------------
    def _span(self, i: int):
        """``[s, e)``: this rank's host rows of chunk ``i`` (empty past its
        last row)."""
        s = min(i * self._stride + self._offset, self.n)
        return s, min(s + self.share, self.n)

    def _padded(self, s: int, e: int):
        """Host rows ``[s, e)`` zero-padded to ``share`` rows in pinned
        buffers, with their valid mask on the card; built once a span."""
        hit = self._pads.get((s, e))
        if hit is None:
            spec = self._ring.host[0]
            pin = self._ring.cuda
            Xp = torch.zeros(spec["x"].shape, dtype=spec["x"].dtype,
                             pin_memory=pin)
            yp = torch.zeros(spec["y"].shape, dtype=torch.float32,
                             pin_memory=pin)
            Xp[:e - s].copy_(self.X[s:e])
            yp[:e - s].copy_(self.y[s:e])
            valid = torch.zeros((self.share,), dtype=torch.bool)
            valid[:e - s] = True
            hit = self._pads[(s, e)] = (Xp, yp, valid.to(self.device))
        return hit

    def _stream(self, fn):
        """``fn(Xc, yc, mask)`` on this rank's share of every chunk in
        order, its outputs added into accumulators on the card (the first
        chunk's, copied); on a mesh the ranks' accumulators then combine
        in rank order.  Returns the accumulators."""
        ring = self._ring
        slots = self._slots

        def produce(i):
            slot = i % slots
            host = ring.claim(slot)
            dev = ring.dev[slot]
            s, e = self._span(i)
            if e - s < self.share:
                Xp, yp, _ = self._padded(s, e)
                ring.send(slot, [(dev["x"], Xp), (dev["y"], yp)])
            else:
                host["x"].copy_(self.X[s:e])
                host["y"].copy_(self.y[s:e])
                ring.send(slot, [(dev["x"], host["x"]),
                                 (dev["y"], host["y"])])
            return i, slot

        accs = None
        with Prefetcher(produce, range(self.n_chunks),
                        depth=DEFAULT_PREFETCH_DEPTH) as feed:
            for i, slot in feed:
                dev = ring.take(slot)
                s, e = self._span(i)
                mask = self._padded(s, e)[2] if e - s < self.share \
                    else None
                out = fn(dev["x"], dev["y"], mask)
                if accs is None:
                    accs = [t.clone() for t in out]
                else:
                    for a, t in zip(accs, out):
                        a += t
                ring.release(slot)
        ring.drain()
        if self.mesh is not None:
            accs = combine(self.mesh, *accs)
        return tuple(accs)

    # -- public sums -------------------------------------------------------
    def cost_sums(self, w):
        """Full-batch ``(grad_sum, loss_sum, count)`` of ``w``."""
        g = self.gradient
        w = torch.as_tensor(w, device=self.device)
        return self._stream(lambda X, y, m: g.batch_sums(X, y, w, mask=m))

    def loss_sums(self, w):
        """Full-batch ``(loss_sum, count)`` of ``w`` (the gradient's sum is
        computed and dropped: eager torch has nothing to prune it)."""
        return self.cost_sums(w)[1:]

    def sweep_sums(self, W):
        """Full-batch ``(loss_sums (T,), count)`` of a ``(T, d)`` stack of
        trial weights: the whole line-search ladder reads each chunk
        once."""
        g = self.gradient
        if not hasattr(g, "loss_sweep"):
            raise NotImplementedError(
                f"{type(g).__name__} has no loss_sweep rule")
        W = torch.as_tensor(W, device=self.device)
        return self._stream(lambda X, y, m: g.loss_sweep(X, y, W, mask=m))
