#!/usr/bin/env python3
"""What bounds the window kernel (``tpu_sgd_torch/ops/csrc/window_sums.cu``)
on one NVIDIA card, at 65,536 and 1,000,000 rows of a 2,000,000 x 1000 bf16
X (least squares):

1. phases: the kernel as built, and copies of its source with the margin
   pass, the column pass or both left out (their sums are wrong; only the
   time counts), so the copies-only variant shows what the bulk-copy ring
   alone reaches;
2. ring plans: rows a stage, stages, and blocks an SM, beside the plan
   ``window_stage_plan`` picks;
3. the old window path (``csrc/fused_sums.cu``) in the same run.

Times are device ms of one call: launches captured in a CUDA graph, the
replay timed with events (``chip_smoke.graph_ms``).

    python3 scripts/probe_window_kernel.py

Builds the variants in a temporary directory; prints one JSON line per
measurement, then one with the card's name and power limit.  Needs CUDA.
"""

import ctypes
import json
import os
import shutil
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

MARGIN = "for (int c = lane; c < nvec; c += 32) {"
COLUMN = "for (int r = 0; r < nr; ++r) {\n        const float cf = coeff[r];"


def variants(src: str) -> dict:
    """The source with the margin pass, the column pass or both removed."""
    no_margin = src.replace(MARGIN, "for (int c = lane; c < 0; c += 32) {")
    no_column = COLUMN.replace("r < nr", "r < 0")
    return {"window_sums": src,
            "window_sums_no_margin": no_margin,
            "window_sums_no_column": src.replace(COLUMN, no_column),
            "window_sums_copies_only": no_margin.replace(COLUMN, no_column)}


def loader(name: str):
    def load():
        lib = _build.load(name)
        fn = lib.tsgd_window_sums
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, i, i, p, p, p, p, p, ll, ll, ll, i, i, i, i, i,
                       p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.tsgd_window_error_string.argtypes = [ctypes.c_int]
        lib.tsgd_window_error_string.restype = ctypes.c_char_p
        return lib
    return load


def plan(rows: int, stages: int, blocks: int, row_bytes: int, d: int):
    return ck.StagePlan(rows, stages, ck.WINDOW_CLUSTER, blocks,
                        rows * row_bytes,
                        stages * (rows * row_bytes + ck.WINDOW_LABEL_BYTES)
                        + 8 * d)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    src = (_build.CSRC / "window_sums.cu").read_text()
    if MARGIN not in src or COLUMN not in src:
        print("the kernel's source no longer has the probed loops",
              file=sys.stderr)
        return 1
    old_src = (_build.CSRC / "fused_sums.cu").read_text()
    tmp = Path(tempfile.mkdtemp())
    try:
        _build.CSRC, _build.BUILD_DIR = tmp, tmp / "_build"
        _build._loaded.clear()
        sources = {**variants(src), "fused_sums": old_src}
        for name, text in sources.items():
            (tmp / f"{name}.cu").write_text(text)
        report = _build.build_all(list(sources))
        print(json.dumps({k: cs.ptxas_report(v["log"])
                          for k, v in report.items()}), flush=True)
        run()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line(),
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def run() -> None:
    n, d = 2_000_000, 1000
    gen = torch.Generator(device="cuda").manual_seed(3)
    X = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    y = torch.randn(n, generator=gen, device="cuda")
    w = torch.randn(d, generator=gen, device="cuda") / d ** 0.5
    pw = tst.LeastSquaresGradient().pointwise
    plans = {"planned": ck.window_stage_plan(d, 2, True)}
    for rows, stages, blocks in ((16, 2, 2), (8, 6, 2), (16, 6, 1),
                                 (8, 8, 1)):
        plans[f"R{rows}_S{stages}_{blocks}_an_SM"] = plan(
            rows, stages, blocks, 2 * d, d)
    stock = ck._window_library
    try:
        for rows, s0 in ((65536, 123457), (1_000_000, 500_001)):
            start = torch.tensor([s0], device="cuda")
            bound = cs._bound_ms(rows, d, 2, 0)[0]
            for name in variants(""):
                ck._window_library = loader(name)
                for pname, p in plans.items():
                    if name != "window_sums" and pname != "planned":
                        continue

                    def call(p=p):
                        return ck._launch_window(pw, X, y, w, None, start, 1,
                                                 rows, p)

                    print(json.dumps({
                        "rows": rows, "source": name, "plan": pname,
                        "stage_rows": p.stage_rows, "stages": p.stages,
                        "blocks_per_sm": p.blocks_per_sm,
                        "device_ms": cs.graph_ms(torch, call),
                        "bound_ms": bound}), flush=True)
            ck._window_library = stock
            print(json.dumps({
                "rows": rows, "source": "fused_sums (old window path)",
                "device_ms": cs.graph_ms(torch, lambda: ck._launch(
                    pw, X, y, w, None, start, 1, rows)),
                "bound_ms": bound}), flush=True)
    finally:
        ck._window_library = stock


if __name__ == "__main__":
    sys.exit(main())
