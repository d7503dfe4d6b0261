"""Host-streamed full-batch cost evaluation for the quasi-Newton optimizers:
the port of ``tpu_sgd/optimize/streamed_costfun.py`` (one device).

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

Not ported: the meshed and multi-host chunk grids (``mesh``, ROADMAP A5).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.io import DEFAULT_PREFETCH_DEPTH
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.wire import host_tensor

#: default host->device chunk budget in bytes
_DEFAULT_CHUNK_BYTES = 256e6


def default_stream_batch_rows(d: int, itemsize: int,
                              chunk_bytes: Optional[float] = None) -> int:
    """Rows per streamed chunk at a byte budget (default ~256 MB): the JAX
    package's chunk-sizing policy."""
    if chunk_bytes is None:
        chunk_bytes = _DEFAULT_CHUNK_BYTES
    return max(1024, int(chunk_bytes // max(1, d * itemsize)))


class StreamedCostFun:
    """Chunked full-batch ``(loss, grad)`` and loss-sweep evaluator over
    host-resident rows.

    Returns RAW SUMS on the card, ``(grad_sum, loss_sum, count)`` and
    ``(loss_sums, count)``, as ``Gradient.batch_sums`` and ``loss_sweep``
    do; callers normalize and add their regularization.  One instance
    binds ``(gradient, X, y, batch_rows)`` and keeps its staging ring and
    padded tail; ``device=None`` is the card."""

    def __init__(self, gradient, X, y, batch_rows: Optional[int] = None,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "the streamed CostFun over a mesh (data parallelism) is not "
                "ported to tpu_sgd_torch yet (ROADMAP A5); use the JAX "
                "package tpu_sgd for it")
        self.gradient = gradient
        self.device = resolve_device(device)
        Xh = host_tensor(X)
        if Xh.dim() != 2 or Xh.shape[0] == 0:
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
        self.cap = int(min(max(1, int(batch_rows)), n))
        self.n_chunks = math.ceil(n / self.cap)
        self._slots = ring_slots(DEFAULT_PREFETCH_DEPTH)
        self._ring = PinnedRing({"x": ((self.cap, d), xdt),
                                 "y": ((self.cap,), torch.float32)},
                                self._slots, self.device)
        self._tail = None  # (pinned X, pinned y, valid mask on the card)

    # -- chunk feed --------------------------------------------------------
    def _tail_chunk(self):
        """The last chunk zero-padded to ``cap`` rows in host buffers
        (pinned on the card's host), with its valid mask on the card;
        built once."""
        if self._tail is None:
            ring = self._ring
            s = (self.n_chunks - 1) * self.cap
            v = self.n - s
            spec = ring.host[0]
            pin = ring.cuda
            Xp = torch.zeros(spec["x"].shape, dtype=spec["x"].dtype,
                             pin_memory=pin)
            yp = torch.zeros(spec["y"].shape, dtype=torch.float32,
                             pin_memory=pin)
            Xp[:v].copy_(self.X[s:])
            yp[:v].copy_(self.y[s:])
            valid = torch.zeros((self.cap,), dtype=torch.bool)
            valid[:v] = True
            self._tail = (Xp, yp, valid.to(self.device))
        return self._tail

    def _stream(self, fn):
        """``fn(Xc, yc, mask)`` on every chunk in order, its outputs added
        into accumulators on the card (the first chunk's, copied); returns
        the accumulators."""
        ring = self._ring
        slots = self._slots
        last = self.n_chunks - 1
        ragged = self.n % self.cap != 0

        def produce(i):
            slot = i % slots
            host = ring.claim(slot)
            dev = ring.dev[slot]
            if i == last and ragged:
                Xp, yp, _ = self._tail_chunk()
                ring.send(slot, [(dev["x"], Xp), (dev["y"], yp)])
            else:
                s = i * self.cap
                host["x"].copy_(self.X[s:s + self.cap])
                host["y"].copy_(self.y[s:s + self.cap])
                ring.send(slot, [(dev["x"], host["x"]),
                                 (dev["y"], host["y"])])
            return i, slot

        accs = None
        with Prefetcher(produce, range(self.n_chunks),
                        depth=DEFAULT_PREFETCH_DEPTH) as feed:
            for i, slot in feed:
                dev = ring.take(slot)
                mask = self._tail_chunk()[2] if i == last and ragged \
                    else None
                out = fn(dev["x"], dev["y"], mask)
                if accs is None:
                    accs = [t.clone() for t in out]
                else:
                    for a, t in zip(accs, out):
                        a += t
                ring.release(slot)
        ring.drain()
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
