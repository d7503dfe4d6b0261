#!/usr/bin/env python3
"""Whether the ring kernel's instances for rows of whole 16-byte units on a
16-byte aligned base (``window_main<F, T, CPT, true>``,
``gather_main<..., true>`` in ``tpu_sgd_torch/ops/csrc/window_sums.cu``)
compile to the same SASS as an earlier version of the source, whose
instances have no ``ALIGNED`` flag.  Equal SASS means equal instructions,
equal order of additions and equal times at those widths.

    python3 scripts/probe_unaligned_ring.py --parent DIR

``DIR/window_sums.cu`` is the earlier source (for example unpacked from
``git archive``).  Builds both with the repo's flags in a temporary
directory and compares them instance by instance, addresses and encodings
dropped.  Prints one JSON line; exits 1 when an instance differs.  Needs
the CUDA toolkit's ``nvcc``, ``cuobjdump`` and ``cu++filt``; no card.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_sgd_torch.ops import _build  # noqa: E402

CUDA = os.environ.get("CUDA_HOME", "/usr/local/cuda")


def sass_by_kernel(lib: str) -> dict:
    """Each kernel's SASS in a built library, by its demangled name: the
    instructions alone, addresses and encodings dropped."""
    dump = subprocess.run([os.path.join(CUDA, "bin", "cuobjdump"), "-sass",
                           lib], capture_output=True, text=True, check=True)
    out, name, mangled = {}, None, []
    for line in dump.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            mangled.append(name)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            out[name].append(re.sub(r"\s+", " ", m.group(1)).strip())
    names = subprocess.run(
        [os.path.join(CUDA, "bin", "cu++filt")], input="\n".join(mangled),
        capture_output=True, text=True, check=True).stdout.splitlines()
    return {re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", d)
            .replace("(bool)1", "true").replace("(bool)0", "false"): out[m]
            for m, d in zip(mangled, names)}


def aligned_sass(tree_lib: str, parent_lib: str) -> dict:
    """The tree's ALIGNED instances against the parent's, by SASS."""
    tree, parent = sass_by_kernel(tree_lib), sass_by_kernel(parent_lib)
    pairs = {name: parent.get(name.replace(", true>", ">")) == code
             for name, code in tree.items()
             if ", true>" in name and "_main<" in name}
    differ = sorted(k for k, equal in pairs.items() if not equal)
    return {"instances": len(pairs), "all_equal": bool(pairs) and not differ,
            "differ": differ}


def main() -> int:
    if "--parent" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[sys.argv.index("--parent") + 1])
    tmp = tempfile.mkdtemp()
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    try:
        _build.CSRC = Path(tmp)
        _build.BUILD_DIR = Path(tmp) / "_build"
        sources = {"window_sums": csrc / "window_sums.cu",
                   "parent_window_sums": parent / "window_sums.cu"}
        for name, path in sources.items():
            shutil.copy(path, _build.CSRC / f"{name}.cu")
        report = _build.build_all(list(sources))
        result = aligned_sass(report["window_sums"]["path"],
                              report["parent_window_sums"]["path"])
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"aligned_sass": result}), flush=True)
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
