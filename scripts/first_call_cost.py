#!/usr/bin/env python3
"""What a first call of the unobserved SGD run costs on one NVIDIA card,
with its blocks eager, always captured, or captured by the shipped rule.

    python3 scripts/first_call_cost.py

Run from the root of the repository on a machine with a card.  On
``chip_smoke.py``'s config 4 matrix (10,000,000 x 1000 bf16, frac 0.1):

* ``first_call``: for each row of phase ``observed`` (Bernoulli, indexed,
  sliced, sliced-vpu, statistics exact / aligned / chunked,
  ``ChunkedGradient``) at 20 and 100 iterations, the wall ms of one
  ``optimize_with_history`` on a fresh optimizer (nothing cached), ending
  in ``synchronize``: every block eager (``CUDA_GRAPHS = False``), the
  block captured after the warm-up whatever it costs (``forced``:
  ``_capture_repays`` patched to say yes, ``CAPTURE_MIN_REPLAYS`` = 0),
  and the shipped rule (``gradient_descent._capture_repays``), in turns
  (eager, forced, shipped, shipped, forced, eager).  With each captured
  mode: the warm-up block's host ms and its ms on the card (between two
  events, idle gaps included), the capture's ms, its cost in warm-up
  blocks of host time, and whether the run captured.
  One eager run of each row goes first, so that the process's one-off
  start-up (kernel modules, library handles) is not in any number.
* ``memory``: for the indexed, sliced, aligned-statistics and
  ``ChunkedGradient`` rows, at ``RUN_BLOCK_ITERS`` = 5, 10 and 20, the
  peak allocated and the reserved bytes above the run's start of a first
  run of 4 K iterations, eager and forced (the cache emptied before each).
* ``stream``: config 5's micro-batches (2,000 x 50, 25 and 50 iterations
  each, ``StreamingLinearRegressionWithSGD``), ms per micro-batch over
  10 batches, in the three modes in turns.

Prints one JSON line per measurement, then the card's name and power
limit.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import tpu_sgd_torch as tst  # noqa: E402
from tpu_sgd_torch.ops import _build  # noqa: E402
from tpu_sgd_torch.optimize import gradient_descent as gd  # noqa: E402

SHIPPED = gd._capture_repays
MIN_REPLAYS = gd.CAPTURE_MIN_REPLAYS
MODES = ("eager", "forced", "shipped", "shipped", "forced", "eager")


def _mode(mode):
    """Set the module for ``mode``; returns the undo."""
    gd.CUDA_GRAPHS = mode != "eager"
    forced = mode == "forced"
    gd._capture_repays = (lambda *a: True) if forced else SHIPPED
    gd.CAPTURE_MIN_REPLAYS = 0 if forced else MIN_REPLAYS

    def undo():
        gd.CUDA_GRAPHS = True
        gd._capture_repays = SHIPPED
        gd.CAPTURE_MIN_REPLAYS = MIN_REPLAYS

    return undo


def _runner(opt):
    return opt._run_cache[1].cache.get("runner") if opt._run_cache else None


def _runner_facts(r):
    if r is None or r.warm_host_ms is None:
        return {}
    out = {"warm_host_ms": r.warm_host_ms,
           "warm_card_ms": r.warm_card_ms,
           "captured": r.graph is not None, "replays": r.replays,
           "capture_ms": r.capture_ms}
    if r.capture_ms is not None:
        out["capture_in_warm_blocks"] = r.capture_ms / r.warm_host_ms
    return out


def first_call(X, y, grams, row, iters, mode):
    undo = _mode(mode)
    try:
        opt = cs._obs_optimizer(torch, tst, row, grams)
        opt.set_num_iterations(iters)
        w0 = torch.zeros(X.shape[1], device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, h = opt.optimize_with_history((X, y), w0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
    finally:
        undo()
    cs.check(len(h) == iters and bool(np.all(np.isfinite(h))),
             f"{row}: history {h}")
    return ms, h, _runner_facts(_runner(opt))


def memory(X, y, grams, row, k, mode):
    gd.RUN_BLOCK_ITERS = k
    undo = _mode(mode)
    try:
        opt = cs._obs_optimizer(torch, tst, row, grams)
        opt.set_num_iterations(4 * k)
        w0 = torch.zeros(X.shape[1], device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        a0 = torch.cuda.memory_allocated()
        r0 = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        opt.optimize_with_history((X, y), w0)
        torch.cuda.synchronize()
        out = {"peak_extra_allocated_bytes":
               torch.cuda.max_memory_allocated() - a0,
               "extra_reserved_bytes": torch.cuda.memory_reserved() - r0,
               "captured": (_runner(opt) is not None
                            and _runner(opt).graph is not None)}
        del opt
    finally:
        undo()
        gd.RUN_BLOCK_ITERS = 10
    return out


def stream(iters, mode):
    d = 50
    w_true = np.linspace(-1, 1, d).astype(np.float32)
    batches = [tst.linear_data(2_000, d, weights=w_true, eps=0.05,
                               seed=10 + i)[:2] for i in range(10)]
    undo = _mode(mode)
    try:
        alg = tst.StreamingLinearRegressionWithSGD(step_size=0.3,
                                                   num_iterations=iters)
        alg.set_initial_weights(np.zeros(d, np.float32))
        captured = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for Xb, yb in batches:
            alg.train_on_batch(Xb, yb)
            r = _runner(alg.algorithm.optimizer)
            captured += int(r is not None and r.graph is not None)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / len(batches)
        w = alg.latest_model().weights.cpu().numpy()
    finally:
        undo()
    return ms, w, captured


def main() -> int:
    if not torch.cuda.is_available():
        print("first_call_cost: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    X, y, _ = cs.make_full_data(torch, cs.FULL_ROWS, cs.FULL_D)
    grams = {
        "exact": tst.GramLeastSquaresGradient.build(
            X, y, block_rows=cs.GRAM_BLOCK, device="cuda"),
        "aligned": tst.GramLeastSquaresGradient.build(
            X, y, block_rows=cs.GRAM_BLOCK, aligned=True, device="cuda")}
    for row in cs.OBS_ROWS:
        first_call(X, y, grams, row, 20, "eager")  # process start-up
        for iters in (20, 100):
            out = {"row": row, "iterations": iters}
            ref = None
            for mode in MODES:
                ms, h, facts = first_call(X, y, grams, row, iters, mode)
                ref = h if ref is None else ref
                cs.check(np.array_equal(h, ref),
                         f"{row} {iters} {mode}: history differs")
                out.setdefault(f"{mode}_ms", []).append(ms)
                if facts:
                    out.setdefault(f"{mode}_facts", []).append(facts)
            cs.emit({"first_call": out})
    for row in ("indexed", "sliced", "stats_aligned", "chunked_gradient"):
        for k in (5, 10, 20):
            cs.emit({"memory": {"row": row, "K": k, **{
                mode: memory(X, y, grams, row, k, mode)
                for mode in ("eager", "forced")}}})
    del X, y, grams
    torch.cuda.empty_cache()
    for iters in (25, 50):
        out = {"iterations": iters}
        ref = None
        for mode in MODES:
            ms, w, captured = stream(iters, mode)
            ref = w if ref is None else ref
            cs.check(np.array_equal(w, ref),
                     f"stream {iters} {mode}: weights differ")
            out.setdefault(f"{mode}_ms_per_batch", []).append(ms)
            out.setdefault(f"{mode}_batches_captured", []).append(captured)
        cs.emit({"stream": out})
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
