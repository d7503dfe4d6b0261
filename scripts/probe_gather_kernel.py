#!/usr/bin/env python3
"""What the gather entry of the window kernel (``gather_main`` in
``tpu_sgd_torch/ops/csrc/window_sums.cu``, masked ``fused_gradient_sums``)
costs on one NVIDIA card, on config 4's 10,000,000 x 1000 bf16 matrix
(least squares, ``chip_smoke.make_full_data``):

1. spread: the same bytes under masks that separate the number of copies,
   the producer's walk over the mask and the rows' spread: the window
   entry over 1M rows; the gather entry over the same rows all live, every
   other row of 2M, runs of 16 rows in every 32 of 2M, a random half of
   2M, every 10th row of 10M, runs of 16 in every 160 of 10M, a random
   tenth of 10M;
2. variants: the source as built (each label lands by a 4-byte
   ``cp.async`` on the tile's full barrier; the margins load both rows of
   a warp without a branch) against a copy of it whose labels are plain
   loads stored at the deal, and one whose gather margins skip a missing
   second row by a branch, as the window entry's do; at random 1%, 10%,
   20% and 30% of 10M rows, a 1.25M-row shard at 10%, the streamed
   CostFun's tail (a 16,000-row prefix of 128,000), every other row of 2M
   and all of 1M.  Each copy is held bitwise to the built source at every
   mask (the same rows in each tile, the same sums);
3. ring: the planned ring (16 rows a stage) against 8 rows a stage (6
   stages), at 10%;
4. with ``--parent DIR``: ``DIR/window_sums.cu`` (an earlier version of
   the source, its window entry alone) built beside it, each
   ``window_main`` instance's registers and spills against the tree's,
   and B2's windows of 1,000,000, 65,536 and 125,000 rows bitwise equal
   and timed in turns (parent, tree, tree, parent).

Times are device ms of one call: launches captured in a CUDA graph, the
replay timed with events (``chip_smoke.graph_ms``); variants in turns,
forward then backward.

    python3 scripts/probe_gather_kernel.py [--parent DIR]

Builds the variants in a temporary directory; prints one JSON line per
measurement, then one with the card's name and power limit.  Needs CUDA.
"""

import ctypes
import json
import math
import os
import re
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

LABELS = (("copy4_async(s_y + slot + e, y + r + e);",
           "s_y[slot + e] = __ldg(y + r + e);"),)
BRANCH = ("if (GATHER || in[k]) {", "if (in[k]) {")


def variants(src: str) -> dict:
    """The built source and its copies (by file name)."""
    labels = src
    for a, b in LABELS:
        labels = labels.replace(a, b)
    return {"window_sums": src, "window_sums_plain_labels": labels,
            "window_sums_margin_branch": src.replace(*BRANCH)}


def instances(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in a ``-Xptxas
    -v`` log, by its mangled name less the anonymous namespace's (which
    holds a hash of the file)."""
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w*?_cu_[0-9a-f]{8}", "_ZN",
                      part.split("'")[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        out[name] = (int(regs.group(1)) if regs else None,
                     int(spill.group(1)) if spill else None)
    return out


def bind_parent(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tsgd_window_sums.argtypes = [i, i, i, p, p, p, p, p, ll, ll, ll, i,
                                     i, i, i, i, p, p, p, p, p, p, p]
    lib.tsgd_window_sums.restype = ctypes.c_int
    lib.tsgd_window_error_string.argtypes = [ctypes.c_int]
    lib.tsgd_window_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    parent = (Path(sys.argv[sys.argv.index("--parent") + 1])
              if "--parent" in sys.argv else None)
    src = (_build.CSRC / "window_sums.cu").read_text()
    if any(a not in src for a, _ in LABELS) or BRANCH[0] not in src:
        print("the kernel's source no longer has the probed lines",
              file=sys.stderr)
        return 1
    tmp = tempfile.mkdtemp()
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        _build.CSRC = _build.Path(tmp)
        _build.BUILD_DIR = _build.Path(tmp) / "_build"
        _build._loaded.clear()
        sources = variants(src)
        for name, text in sources.items():
            (_build.CSRC / f"{name}.cu").write_text(text)
        if parent is not None:
            (_build.CSRC / "parent_window_sums.cu").write_text(
                (parent / "window_sums.cu").read_text())
        report = _build.build_all(
            list(sources) + ([] if parent is None
                             else ["parent_window_sums"]))
        print(json.dumps({k: cs.ptxas_entries(v["log"]).get("gather_main")
                          for k, v in report.items()}), flush=True)
        libs = {k: ck._bind_window(_build.load(k)) for k in sources}
        run(libs)
        if parent is not None:
            mine = instances(report["window_sums"]["log"])
            theirs = instances(report["parent_window_sums"]["log"])
            win = {k: v for k, v in mine.items() if "window_main" in k}
            print(json.dumps({
                "section": "parent", "window_main_instances": len(win),
                "same_registers_and_spills": all(
                    theirs.get(k) == v for k, v in win.items()),
                "registers": sorted({v[0] for v in win.values()}),
                "max_spill_bytes": max(v[1] or 0 for v in win.values())}),
                flush=True)
            run_parent(libs["window_sums"],
                       bind_parent(_build.load("parent_window_sums")))
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._loaded.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"nvidia_smi": cs.nvidia_smi_line(),
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def run(libs: dict) -> None:
    X, y, _ = cs.make_full_data(torch, cs.FULL_ROWS, cs.FULL_D)
    n, d = X.shape
    pw = tst.LeastSquaresGradient().pointwise
    w = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") / math.sqrt(d)
    u = torch.rand(n, generator=torch.Generator(device="cuda").manual_seed(6),
                   device="cuda")
    idx = torch.arange(n, device="cuda")
    plan = ck.window_plan_for(X)
    built = libs["window_sums"]

    def call(lib, rows, mask, p=plan):
        Xa, ya = X[:rows], y[:rows]

        def f():
            _build._loaded["window_sums"] = lib
            try:
                return ck._launch_window(pw, Xa, ya, w, mask, None, 1, rows,
                                         p, gather=mask is not None)
            finally:
                _build._loaded["window_sums"] = built
        return f

    def emit(section, case, rows, mask, times):
        live = rows if mask is None else int(mask.sum())
        bound = cs._bound_ms(live, d, 2, 0 if mask is None else rows)[0]
        print(json.dumps({"section": section, "case": case, "rows": rows,
                          "live": live, "bound_ms": bound, **times}),
              flush=True)

    def turns(fns):
        out = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            out[k].append(cs.graph_ms(torch, fns[k]))
        return {"device_ms": out}

    # 1. spread
    m1 = torch.ones(1_000_000, dtype=torch.bool, device="cuda")
    i2 = idx[:2_000_000]
    spread = {
        "window_1M": (1_000_000, None),
        "all_of_1M": (1_000_000, m1),
        "every_other_of_2M": (2_000_000, i2 % 2 == 0),
        "runs_16_of_32_of_2M": (2_000_000, (i2 // 16) % 2 == 0),
        "random_half_of_2M": (2_000_000, u[:2_000_000] < 0.5),
        "every_10th_of_10M": (n, idx % 10 == 0),
        "runs_16_of_160_of_10M": (n, (idx // 16) % 10 == 0),
        "random_tenth_of_10M": (n, u < 0.1),
    }
    for case, (rows, mask) in spread.items():
        t = [cs.graph_ms(torch, call(built, rows, mask)) for _ in range(2)]
        emit("spread", case, rows, mask, {"device_ms": t})
    # 2. variants
    tail = torch.zeros(128_000, dtype=torch.bool, device="cuda")
    tail[:16_000] = True
    deal = {
        "random_1pct": (n, u < 0.01), "random_10pct": (n, u < 0.1),
        "random_20pct": (n, u < 0.2), "random_30pct": (n, u < 0.3),
        "shard_10pct": (1_250_000, u[:1_250_000] < 0.1),
        "costfun_tail_prefix": (128_000, tail),
        "every_other_of_2M": (2_000_000, i2 % 2 == 0),
        "all_of_1M": (1_000_000, m1),
    }
    for case, (rows, mask) in deal.items():
        ref = call(built, rows, mask)()
        for name, lib in libs.items():
            got = call(lib, rows, mask)()
            cs.check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                     f"{name} at {case}: not bitwise the built source")
        emit("variants", case, rows, mask,
             turns({k: call(lib, rows, mask) for k, lib in libs.items()}))
    # 3. ring
    r8 = ck.StagePlan(8, 6, ck.WINDOW_CLUSTER, 2, 8 * 2 * d,
                      6 * (8 * 2 * d + ck.WINDOW_LABEL_BYTES) + 8 * d)
    mask = u < 0.1
    emit("ring", "random_10pct", n, mask,
         turns({"planned_R16_S3": call(built, n, mask),
                "R8_S6": call(built, n, mask, r8)}))


def run_parent(built, parent) -> None:
    X, y, _ = cs.make_full_data(torch, 2_000_000, cs.FULL_D)
    d = X.shape[1]
    pw = tst.LeastSquaresGradient().pointwise
    w = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda") / math.sqrt(d)
    start = torch.tensor([123_457], device="cuda")

    def call(lib, rows):
        def f():
            _build._loaded["window_sums"] = lib
            try:
                return ck.fused_window_sums(pw, X, y, w, start, rows,
                                            tile_m=1)
            finally:
                _build._loaded["window_sums"] = built
        return f

    for rows in (1_000_000, 65_536, 125_000):
        a, b = call(parent, rows)(), call(built, rows)()
        cs.check(all(torch.equal(u, v) for u, v in zip(a, b)),
                 f"B2 at {rows} rows: the tree's bits differ from the "
                 "parent's")
        out = {"parent": [], "tree": []}
        for k in ("parent", "tree", "tree", "parent"):
            out[k].append(cs.graph_ms(torch, call(
                parent if k == "parent" else built, rows)))
        print(json.dumps({"section": "parent", "case": f"B2 {rows} rows",
                          "bitwise_equal": True,
                          "bound_ms": cs._bound_ms(rows, d, 2, 0)[0],
                          "device_ms": out}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
