#!/usr/bin/env python3
"""Sweep two launch parameters of the port's fused-sums CUDA kernel on one
card: blocks per SM that the register budget is fitted to
(``kMinBlocksPerSM``) and rows per warp (``kRowsPerWarp``).

    python3 scripts/sweep_fused_sums.py

Each variant is built from a copy of ``tpu_sgd_torch/ops/csrc/fused_sums.cu``
with the two constants replaced, then timed (CUDA events) on 10M x 1000
bf16 data, each call launched in ``fused_sums.cu`` directly
(``cuda_kernels._launch``; the wrappers send these widths to
``window_sums.cu``): the batch under a 10% mask, a 1M-row window, and a
1M-row window of f32 data.  Variants run in one
order, then in the reverse order.  Prints one line per variant:
``(min_blocks, rows_per_warp) [(b1_ms, b2_ms, f32_window_ms,
max_spill_bytes), ...]`` (spill -1: already built), then the card's name
and power limit.
"""

import os
import re
import sys
import tempfile
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import tpu_sgd_torch as tst  # noqa: E402
from tpu_sgd_torch.ops import _build  # noqa: E402
from tpu_sgd_torch.ops import cuda_kernels as ck  # noqa: E402


def variant_sources(src):
    out = {}
    for mb in (2, 3, 4):
        for rpw in (4, 8):
            d = Path(tempfile.mkdtemp())
            s = re.sub(r"constexpr int kMinBlocksPerSM = \d+;",
                       f"constexpr int kMinBlocksPerSM = {mb};", src)
            s = re.sub(r"constexpr int kRowsPerWarp = \d+;",
                       f"constexpr int kRowsPerWarp = {rpw};", s)
            (d / "fused_sums.cu").write_text(s)
            out[(mb, rpw)] = d
    return out


def main():
    if not torch.cuda.is_available():
        print("sweep_fused_sums: needs a CUDA card", file=sys.stderr)
        return 1
    variants = variant_sources((_build.CSRC / "fused_sums.cu").read_text())
    X, y, _ = cs.make_full_data(torch, 10_000_000, 1000)
    pw = tst.LeastSquaresGradient().pointwise
    w = torch.randn(1000, device="cuda") / 30
    mask = torch.rand(10_000_000, device="cuda") < 0.1
    st = torch.tensor([1234], device="cuda")
    zero = torch.tensor([0], device="cuda")
    Xf = X[:2_000_000].float().contiguous()
    yf = y[:2_000_000]
    res = {}
    order = list(variants.items())
    for items in (order, order[::-1]):
        for key, d in items:
            _build.CSRC = d
            _build._loaded.clear()
            log = _build.build_all(["fused_sums"])["fused_sums"]["log"]
            spill = max([int(b) for b in
                         re.findall(r"(\d+) bytes spill", log)] or [-1])
            # fused_sums.cu itself (the wrappers route these shapes to
            # window_sums.cu): the masked batch, a window, an f32 window
            b1 = cs.time_ms(torch, lambda: ck._launch(
                pw, X, y, w, mask, None, 1, X.shape[0]), 10)
            b2 = cs.time_ms(torch, lambda: ck._launch(
                pw, X, y, w, None, st, 2000, 500 * 2000), 20)
            f32 = cs.time_ms(torch, lambda: ck._launch(
                pw, Xf, yf, w, None, zero, 1000, 1000 * 1000), 10)
            res.setdefault(key, []).append((b1, b2, f32, spill))
    for k, v in res.items():
        print(k, v, flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
