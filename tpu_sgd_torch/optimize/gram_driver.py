"""Chunked-gather driver for block-ALIGNED sufficient-statistics SGD: the
port of ``tpu_sgd/optimize/gram_driver.py``.

Each outer step advances ``chunk_iters`` iterations: it draws the K window
starts of those iterations, gathers all K window endpoints from the prefix
stacks with ``index_select`` on device indices (2·K ``(d, d)`` rows, the
same bytes the per-iteration driver reads, in K-fold larger transfers),
then runs the K updates from the gathered differences.

The contract is unchanged from ``make_run`` (``optimize/
gradient_descent.py``): the same per-iteration window stream
(``_window_start`` after ``_seed_for(seed, i)``), per-iteration loss
history including the previous iteration's reg value, realized-count
normalization, and per-iteration weight-delta convergence.  A run that
converges inside a chunk masks the chunk's remaining updates to no-ops on
the device and stops at the chunk boundary, so it records exactly as many
losses as the per-iteration driver.  The host reads the convergence flag
once per chunk, and only when ``convergence_tol > 0``.  Applies to
block-aligned windows only (virtual statistics, or resident ones in
aligned mode) with sliced sampling.
"""

from __future__ import annotations

import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import true_f32_matmul
from tpu_sgd_torch.ops.gradients import acc_dtype, matmul_dtype
from tpu_sgd_torch.ops.gram import (
    aligned_window_blocks,
    aligned_window_k1,
    aligned_window_terms,
)
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.optimize import gradient_descent as gd


def make_chunked_gram_run(updater: Updater, config: SGDConfig, *, n: int,
                          block_rows: int, chunk_iters: int = 16):
    """``run(initial_weights, data: GramData, y) -> (weights, loss_history,
    n_recorded)``, the ``make_run`` return contract.  ``y`` is accepted
    for signature parity and never read (the statistics carry it)."""
    cfg = config
    K = int(chunk_iters)
    if K < 1:
        raise ValueError(f"chunk_iters must be positive, got {chunk_iters}")
    m = max(1, round(cfg.mini_batch_fraction * n))
    B = int(block_rows)
    nbf = n // B
    mb = aligned_window_blocks(m, B, nbf)
    check_conv = cfg.convergence_tol > 0.0
    num_iters = cfg.num_iterations

    def run(initial_weights, data, y, valid=None):
        del y, valid  # statistics-only execution
        PG, Pb, Pyy = data.PG, data.Pb, data.Pyy
        sd = PG.dtype
        cd = acc_dtype(matmul_dtype(data))
        dev = PG.device
        # a device count, as make_run divides by: on the card a division
        # by a host scalar runs as a multiplication by its reciprocal
        count = torch.full((), float(mb * B), dtype=cd, device=dev)
        gen = torch.Generator(device=dev)
        w = initial_weights
        _, reg_val = updater.compute(w, torch.zeros_like(w), 0.0, 1,
                                     cfg.reg_param)
        losses = torch.full((num_iters,), float("nan"), dtype=torch.float32,
                            device=dev)
        n_rec = torch.zeros((1,), dtype=torch.int64, device=dev)
        conv = torch.zeros((), dtype=torch.bool, device=dev)
        base = 1
        while base <= num_iters:
            idx = range(base, min(base + K, num_iters + 1))
            starts = []
            for i in idx:
                gen.manual_seed(gd._seed_for(cfg.seed, i))
                starts.append(gd._window_start(gen, n, m, dev))
            k1s = aligned_window_k1(torch.cat(starts), n, m, B, nbf, mb)
            k2s = k1s + mb
            # the chunk's window statistics in bulk gathers
            Gd = PG.index_select(0, k2s) - PG.index_select(0, k1s)
            bd = Pb.index_select(0, k2s) - Pb.index_select(0, k1s)
            yyd = Pyy.index_select(0, k2s) - Pyy.index_select(0, k1s)
            for t, i in enumerate(idx):
                active = ~conv
                with true_f32_matmul():
                    g_sum, loss_sum = aligned_window_terms(
                        Gd[t], bd[t], yyd[t], w.to(sd))
                # as make_run divides the window's sums (cast to the
                # accumulation dtype) by the count: the two drivers agree
                # bitwise
                loss_i = loss_sum.to(cd) / count + reg_val
                g_mean = (g_sum.to(cd) / count).to(w.dtype)
                new_w, new_reg = updater.compute(w, g_mean, cfg.step_size, i,
                                                 cfg.reg_param)
                kept = losses.index_select(0, n_rec)
                losses.index_copy_(0, n_rec, torch.where(
                    active, loss_i.to(torch.float32).reshape(1), kept))
                n_rec += active.to(torch.int64)
                if check_conv and i > 1:
                    diff = torch.linalg.vector_norm(new_w - w)
                    w_norm = torch.linalg.vector_norm(new_w)
                    conv = conv | (active & (
                        diff < cfg.convergence_tol
                        * torch.clamp(w_norm, min=1.0)))
                w = torch.where(active, new_w, w)
                reg_val = torch.where(active, new_reg, reg_val)
            base += K
            if check_conv and bool(conv):  # the host sync, once a chunk
                break
        return w, losses, n_rec

    return run
