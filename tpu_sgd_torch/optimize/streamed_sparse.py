"""Host-streamed SGD over SPARSE features, never densified: the port of
``tpu_sgd/optimize/streamed_sparse.py``.

The dataset stays in host memory as CSR arrays (any torch sparse layout
is read once into them), and every sampled batch ships as fixed-shape CSR
components ``(crow, col, val)`` staged in a pinned slot
(``io.sparse_wire.stage_sparse_batch``), with the labels and the valid
mask.  On the card the worker's side stream builds the batch's transposed
CSR into the slot (``ops.sparse.transpose_csr_into``: a stable sort, no
host read), and the step runs the two products of the deterministic CSR
kernel (``ops/csrc/csr_products.cu``): no ``(rows, d)`` dense tensor is
made anywhere, and the wire carries about ``nnz / (rows * d)`` of the
dense bytes.

Shape discipline: a sparse batch varies in rows and entries, so the
staging pads to ONE ``(row_cap, nse_cap)`` shape a run: ``row_cap`` by
the dense driver's binomial cap, ``nse_cap`` by a pre-pass over the whole
run's sample sequence (``io.sparse_wire.plan_sparse_batches``; the sample
is a function of ``(seed, i)``, so a resumed run plans the same cap).
The padding entries add exact zeros.

The dense streamed driver's contracts hold (``optimize/streamed.py``, the
same loops): Bernoulli sampling from ``np.random.default_rng(seed + i)``
(the dense driver's rows exactly) or full batch; prefetch depth 2 against
0 and K = 8 against K = 1 bitwise; checkpoint, resume and preemption at
block boundaries bitwise.  Full batch sends the components ONCE (its
transposed copy built once on the card); ``resident_cadence >= 2`` on it
runs windows of C blocks.  Each staged batch is a checksummed frame
through the ``io.sparse_chunk`` corrupting failpoint, behind
``io.device_put``; staging passes ``io.sparse_wire``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.io.integrity import seal, verify
from tpu_sgd_torch.io.prefetch import PinnedRing, Prefetcher, ring_slots
from tpu_sgd_torch.io.sparse_wire import (csr_host, plan_sparse_batches,
                                          sparse_batch_index_dtype,
                                          stage_sparse_batch)
from tpu_sgd_torch.io.wire import host_tensor
from tpu_sgd_torch.obs.counters import record_wire
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.ops.gradients import Gradient
from tpu_sgd_torch.ops.sparse import _csr, transpose_csr, transpose_csr_into
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.optimize.streamed import (HostSampler, _StreamedRun,
                                             execute, frame_view)
from tpu_sgd_torch.reliability.failpoints import corruptpoint, failpoint

Tensor = torch.Tensor


class _Batches(list):
    """One sparse batch a step of a slot (a list the block runner can
    hold a weak reference to)."""


def optimize_host_streamed_sparse(
    gradient: Gradient,
    updater: Updater,
    config: SGDConfig,
    X,
    y,
    initial_weights,
    device=None,
    listener=None,
    checkpoint_manager=None,
    checkpoint_every: int = 10,
    prefetch_depth: int = 2,
    retry_policy=None,
    stop_signal=None,
    superstep_k: int = 1,
    resident_cadence: int = 0,
    wire_compress=None,
    check_numerics: bool = False,
) -> Tuple[Tensor, np.ndarray]:
    """Run mini-batch SGD with the SPARSE dataset resident on the host;
    ``X`` is a CPU sparse tensor.  Returns ``(weights, loss_history)``
    with the dense streamed driver's semantics (see the module
    docstring)."""
    from tpu_sgd_torch.optimize.gradient_descent import _coerce_w0

    cfg = config
    if cfg.mini_batch_fraction < 1.0 and cfg.sampling != "bernoulli":
        raise NotImplementedError(
            "host-streamed sparse training supports bernoulli sampling or "
            f"full batch (got sampling={cfg.sampling!r}; sliced/indexed "
            "need a dense row layout)")
    if wire_compress is not None:
        warnings.warn(
            "wire_compress applies to the update-shaped wires; the sparse "
            "FEED is already compressed — CSR components are the wire "
            "format here", RuntimeWarning, stacklevel=3)
    dev = resolve_device(device)
    indptr, cols, vals, (n, d) = csr_host(X)
    if vals.dtype != np.float32:
        vals = vals.astype(np.float32)  # the CSR kernel's value type
    w0 = _coerce_w0(gradient, initial_weights, d, dev)
    if n == 0:
        return w0, np.zeros((0,), np.float32)
    yh = host_tensor(y).to(torch.float32).contiguous()
    sampler = HostSampler(cfg, n)
    full_batch = sampler.frac >= 1.0
    if full_batch:
        nse_cap = max(1, int(vals.shape[0]))
    else:
        nse_cap = plan_sparse_batches(indptr, sampler.sample_rows,
                                      cfg.num_iterations, sampler.cap)
    K = max(1, int(superstep_k))
    C = max(0, int(resident_cadence))
    if C >= 2 and K <= 1:
        warnings.warn(
            "device residency rides the fused superstep executor; pass "
            "superstep_k >= 2 to engage it", RuntimeWarning, stacklevel=3)
        C = 0
    if C >= 2 and not full_batch:
        warnings.warn(
            "device residency applies to the full-batch sparse feed "
            "(components transfer once); a bernoulli-sampled sparse "
            "stream's per-batch host hop IS the data feed, so the "
            "superstep driver runs", RuntimeWarning, stacklevel=3)
        C = 0
    run = _SparseRun(gradient, updater, cfg, dev, sampler, K, C, None,
                     prefetch_depth, retry_policy, listener,
                     checkpoint_every, stop_signal, check_numerics,
                     csr=(indptr, cols, vals, d), yh=yh, nse_cap=nse_cap)
    return execute(run, w0, checkpoint_manager)


class _SparseRun(_StreamedRun):
    """The sparse feed: fixed-shape CSR batches staged into pinned
    ``(K, ...)`` component slots, each step's transposed copy built on the
    card."""

    def __init__(self, *args, csr, yh, nse_cap):
        super().__init__(*args)
        self.indptr, self.cols, self.vals, self.d = csr
        self.yh = yh
        self.nse_cap = int(nse_cap)
        self.idt = sparse_batch_index_dtype(self.sampler.cap, self.nse_cap,
                                            self.d)

    def _frame(self, host: dict, wire: str) -> None:
        """Seal, pass through ``io.sparse_chunk``, verify and count one
        staged frame."""
        names = ("crow", "col", "val", "y", "v")
        failpoint("io.device_put")
        frame = tuple(frame_view(host[k]) for k in names)
        with span("ingest.checksum"):
            ck = seal(*frame)
            verify("io.sparse_chunk", ck,
                   *corruptpoint("io.sparse_chunk", frame))
        phys = sum(host[k].numel() * host[k].element_size() for k in names)
        steps = host["y"].shape[0] if host["y"].dim() == 2 else 1
        logical = (steps * self.sampler.cap * self.d * 4
                   + host["y"].numel() * 4 + host["v"].numel())
        record_wire(wire, logical_nbytes=logical, physical_nbytes=phys)

    def _full_data(self):
        """The whole CSR on the card, sent once inside the retry scope,
        and its transposed copy built there once."""
        n, cap = self.sampler.n, self.sampler.cap

        def put():
            with span("ingest.produce"):
                host = {"crow": torch.from_numpy(self.indptr.astype(
                            np.int32 if self.idt == torch.int32
                            else np.int64)),
                        "col": torch.from_numpy(self.cols).to(self.idt),
                        "val": torch.from_numpy(
                            np.ascontiguousarray(self.vals)),
                        "y": self.yh,
                        "v": torch.ones((cap,), dtype=torch.bool)}
                if self.nse_cap > self.vals.shape[0]:  # an empty matrix
                    host = self._staged_full(host)
                self._frame(host, "csr")
            return {k: v.to(self.dev) for k, v in host.items()}

        dv = (self.retry_policy.call(put) if self.retry_policy is not None
              else put())
        Xd = _csr(dv["crow"], dv["col"], dv["val"], (n, self.d))
        return Xd, dv["y"], dv["v"], transpose_csr(Xd)

    def _staged_full(self, host: dict) -> dict:
        """An all-empty matrix staged with its one padding entry."""
        crow, col, val, _ = stage_sparse_batch(
            self.indptr, self.cols, self.vals,
            np.zeros((0,), np.int64), self.sampler.cap, self.nse_cap)
        return dict(host, crow=crow, col=col, val=val)

    def _slot_data(self, slot: int):
        dv = self.ring.dev[slot]
        cap, d, K = self.sampler.cap, self.d, self.K
        X = _Batches(_csr(dv["crow"][t], dv["col"][t], dv["val"][t],
                          (cap, d)) for t in range(K))
        Xt = _Batches(_csr(dv["crow_t"][t], dv["row_t"][t], dv["val_t"][t],
                           (d, cap)) for t in range(K))
        return X, dv["y"], dv["v"], Xt

    def _ring_feed(self, i0: int, N: int) -> PinnedRing:
        K, cap, nse, d = self.K, self.sampler.cap, self.nse_cap, self.d
        slots = ring_slots(self.depth)
        idt = self.idt
        self.ring = ring = PinnedRing(
            {"crow": ((K, cap + 1), idt), "col": ((K, nse), idt),
             "val": ((K, nse), torch.float32),
             "y": ((K, cap), torch.float32), "v": ((K, cap), torch.bool)},
            slots, self.dev,
            device_specs={"crow_t": ((K, d + 1), idt),
                          "row_t": ((K, nse), idt),
                          "val_t": ((K, nse), torch.float32)})
        empty = np.zeros((0,), np.int64)

        def produce(base: int):
            # the slot is the item's, so a retried attempt refills it
            slot = (base - i0) // K % slots
            host = ring.claim(slot)
            steps = min(K, N - base + 1)
            for t in range(K):
                # a tail step stages an empty batch: no entries but the
                # padding, all rows invalid (a no-op update, fixed shape)
                rows = self.sampler.sample_rows(base + t) if t < steps \
                    else empty
                stage_sparse_batch(
                    self.indptr, self.cols, self.vals, rows, cap, nse,
                    out=(host["crow"][t], host["col"][t], host["val"][t],
                         host["v"][t]))
                yb = host["y"][t]
                yb.zero_()
                yb[:rows.shape[0]] = self.yh[torch.from_numpy(rows)]
            self._frame(host, "csr")
            dev = ring.dev[slot]
            names = ("crow", "col", "val", "y", "v")

            def transposed():
                for t in range(K):
                    transpose_csr_into(dev["crow"][t], dev["col"][t],
                                       dev["val"][t], d, dev["crow_t"][t],
                                       dev["row_t"][t], dev["val_t"][t])

            ring.send(slot, [(dev[k], host[k]) for k in names], transposed)
            return slot, steps

        self.feed = Prefetcher(produce, range(i0, N + 1, K),
                               depth=self.depth,
                               retry_policy=self.retry_policy)
        return ring
