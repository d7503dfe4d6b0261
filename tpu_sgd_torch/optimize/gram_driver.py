"""Chunked-gather driver for block-ALIGNED sufficient-statistics SGD: the
port of ``tpu_sgd/optimize/gram_driver.py``.

Each outer step (a *chunk*) advances ``chunk_iters`` iterations: it draws
the K window starts of those iterations, gathers all K window endpoints
from the prefix stacks with ``index_select`` on device indices (2·K
``(d, d)`` rows, the same bytes the per-iteration driver reads, in K-fold
larger transfers), then runs the K updates from the gathered differences.

The contract is unchanged from ``make_run`` (``optimize/
gradient_descent.py``): the same per-iteration window stream (its
``_Sampler`` of ``_window_start`` draws), per-iteration loss history
including the previous iteration's reg value, realized-count
normalization, and per-iteration weight-delta convergence.  A chunk runs
from state on the device (``gradient_descent._RunState``: weights, reg
value, iteration counter, convergence flag, history), so on a CUDA device
one chunk is one captured CUDA graph, replayed for every later full chunk
where the capture repays itself (``gradient_descent._BlockRunner``).  A
run that converges inside a chunk masks the chunk's remaining updates to
no-ops on the device and stops at the chunk boundary, so it records
exactly as many losses as the per-iteration driver.  The host reads the
convergence flag once per chunk, and only when ``convergence_tol > 0``.
Applies to block-aligned windows only (virtual statistics, or resident
ones in aligned mode) with sliced sampling.
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
    for signature parity and never read (the statistics carry it).  The
    chunk's graph and buffers are kept for the next call on the same
    bundle."""
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
    K = min(K, num_iters)
    cache: dict = {}

    def chunk(st, data, sampler, steps):
        data = data[0]
        PG, Pb, Pyy = data.PG, data.Pb, data.Pyy
        sd = PG.dtype
        cd = acc_dtype(matmul_dtype(data))
        # a device count, as make_run divides by: on the card a division
        # by a host scalar runs as a multiplication by its reciprocal
        count = torch.full((), float(mb * B), dtype=cd, device=PG.device)
        starts = torch.cat([sampler.draw() for _ in range(steps)])
        k1s = aligned_window_k1(starts, n, m, B, nbf, mb)
        k2s = k1s + mb
        # the chunk's window statistics in bulk gathers
        Gd = PG.index_select(0, k2s) - PG.index_select(0, k1s)
        bd = Pb.index_select(0, k2s) - Pb.index_select(0, k1s)
        yyd = Pyy.index_select(0, k2s) - Pyy.index_select(0, k1s)
        w, reg_val = st.w, st.reg
        for t in range(steps):
            active = ~st.conv
            with true_f32_matmul():
                g_sum, loss_sum = aligned_window_terms(
                    Gd[t], bd[t], yyd[t], w.to(sd))
            # as make_run divides the window's sums (cast to the
            # accumulation dtype) by the count: the two drivers agree
            # bitwise
            loss_i = loss_sum.to(cd) / count + reg_val
            g_mean = (g_sum.to(cd) / count).to(w.dtype)
            new_w, new_reg = updater.compute(w, g_mean, cfg.step_size, st.i,
                                             cfg.reg_param)
            w, reg_val = gd._record_step(st, active, active, loss_i, w,
                                         new_w, reg_val, new_reg,
                                         cfg.convergence_tol)
            st.i += 1
        st.w.copy_(w)
        st.reg.copy_(reg_val)

    def run(initial_weights, data, y, valid=None):
        del y, valid  # statistics-only execution
        w0 = initial_weights

        def make():
            sampler = gd._Sampler(
                cfg.seed, data.device,
                lambda gen: gd._window_start(gen, n, m, data.device))
            return gd._BlockRunner(
                chunk, gd._RunState(w0, num_iters), (data, None, None, None),
                sampler, K, gd.CUDA_GRAPHS and w0.is_cuda, adaptive=True)

        runner = gd._run_runner(cache, make, data, None, None, None, w0)
        st = runner.state
        _, reg0 = updater.compute(w0, torch.zeros_like(w0), 0.0, 1,
                                  cfg.reg_param)
        st.reset(w0, reg0, 1)
        runner.begin(data, None, None, None, num_iters)
        try:
            gd._run_blocks(runner, num_iters, check_conv)
        finally:
            runner.end()
        return st.w.clone(), st.losses.clone(), st.n_rec.clone()

    run.cache = cache
    return run
