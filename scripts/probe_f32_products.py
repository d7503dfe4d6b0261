#!/usr/bin/env python3
"""Two measurements behind the port's bf16 products with f32 outputs, on
one NVIDIA card:

1. precision: the Gram ``XᵀX`` of 300,000 x 1000 bf16 rows against an f64
   reference, as one product with an f32 output, as an f32 product of the
   upcast X, and in 4,096-row blocks whose f32 products are added in f64
   (what ``tpu_sgd_torch/optimize/normal.py`` does);
2. layout: ``X @ Wᵀ`` (rows of T f32 values, misaligned unless T is a
   multiple of 4) against ``W @ Xᵀ`` (rows of n values) for T trial or
   class columns, X 2,560,000 x 1000 bf16 (what ``margins_of`` computes).

    python3 scripts/probe_f32_products.py

Prints one JSON line with the card's name and power limit.  Needs CUDA.
"""

import json
import subprocess
import sys

import torch


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), "torch": torch.__version__}

    a = torch.randn(300_000, 1000, device="cuda", generator=gen).bfloat16()
    ref = a.double().T @ a.double()

    def rel(G):
        return float((G.double() - ref).abs().max() / ref.abs().max())

    blocks = a[:73 * 4096].reshape(73, 4096, 1000)  # the full blocks
    tail = a[73 * 4096:]
    Gb = torch.bmm(blocks.transpose(1, 2), blocks,
                   out_dtype=torch.float32).sum(0, dtype=torch.float64)
    Gb += torch.mm(tail.T, tail, out_dtype=torch.float32).double()
    out["gram_rel_err"] = {
        "one_product_f32_out": rel(torch.mm(a.T, a, out_dtype=torch.float32)),
        "f32_upcast": rel(a.float().T @ a.float()),
        "blocks_4096_f64_sum": rel(Gb)}
    del a, ref, blocks, tail, Gb

    X = torch.randn(2_560_000, 1000, device="cuda", generator=gen).bfloat16()
    out["layout_ms"] = {}
    for T in (25, 32, 225, 232):
        W = torch.randn(T, 1000, device="cuda", generator=gen).bfloat16()
        out["layout_ms"][T] = {
            "X_Wt": ms(lambda: torch.mm(X, W.T, out_dtype=torch.float32)),
            "W_Xt": ms(lambda: torch.mm(W, X.T, out_dtype=torch.float32))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
