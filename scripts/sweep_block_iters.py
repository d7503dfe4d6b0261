#!/usr/bin/env python3
"""K of the unobserved SGD run on one NVIDIA card.

    python3 scripts/sweep_block_iters.py

Run from the root of the repository on a machine with a card.  On
``chip_smoke.py``'s config 4 matrix (10,000,000 x 1000 bf16, frac 0.1), for
the sliced row (the window kernel) and the aligned statistics row, at 20
and 100 iterations: the warm wall ms per iteration of ``make_run`` with
``RUN_BLOCK_ITERS`` = 5, 10, 20, with ``convergence_tol`` 0 (no flag read)
and 1e-12 (a flag read each block, never converging).  With the flag read,
the shipped read at each block boundary and a read one block late (the
flag copied to pinned memory behind each block and read after the next
block is queued, defined here only) are timed in turns (now, late, late,
now).  Each number is the best of three runs ending in ``synchronize``.
Prints one JSON line per setting, then the card's name and power limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tpu_sgd_torch as tst  # noqa: E402
from tpu_sgd_torch.ops import _build  # noqa: E402
from tpu_sgd_torch.optimize import gradient_descent as gd  # noqa: E402

SHIPPED = gd._run_blocks


def late_read(runner, num_iterations, check_conv):
    """The flag of block b read after block b + 1 is queued."""
    st = runner.state
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    done = None
    i0 = 1
    while i0 <= num_iterations:
        steps = min(runner.k, num_iterations - i0 + 1)
        runner.run(i0, steps)
        i0 += steps
        if not check_conv:
            continue
        if done is not None:
            done.synchronize()
            if bool(host):
                break
        host.copy_(st.conv, non_blocking=True)
        done = torch.cuda.Event()
        done.record()


def wall(X, y, grams, k, tol, iters, row, reader):
    gd.RUN_BLOCK_ITERS = k
    gd._run_blocks = reader
    try:
        opt = cs._obs_optimizer(torch, tst, row, grams)
        opt.set_num_iterations(iters).set_convergence_tol(tol)
        w0 = torch.zeros(X.shape[1], device="cuda")
        for _ in range(2):  # warm-up; a repeated run captures its block
            opt.optimize_with_history((X, y), w0)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, h = opt.optimize_with_history((X, y), w0)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t) / iters)
    finally:
        gd._run_blocks = SHIPPED
        gd.RUN_BLOCK_ITERS = 10
    cs.check(len(h) == iters, f"{row}: {len(h)} losses")
    return min(walls)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_block_iters: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    X, y, _ = cs.make_full_data(torch, cs.FULL_ROWS, cs.FULL_D)
    grams = {"aligned": tst.GramLeastSquaresGradient.build(
        X, y, block_rows=cs.GRAM_BLOCK, aligned=True, device="cuda")}
    for row in ("sliced", "stats_aligned"):
        for iters in (20, 100):
            for k in (5, 10, 20):
                out = {"row": row, "iterations": iters, "K": k,
                       "no_flag_ms": wall(X, y, grams, k, 0.0, iters, row,
                                          SHIPPED)}
                turns = {"now": [], "late": []}
                for name in ("now", "late", "late", "now"):
                    reader = SHIPPED if name == "now" else late_read
                    turns[name].append(wall(X, y, grams, k, 1e-12, iters,
                                            row, reader))
                out["flag_now_ms"] = turns["now"]
                out["flag_late_ms"] = turns["late"]
                cs.emit(out)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
