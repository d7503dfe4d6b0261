"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``_build/lib<name>-<hash>.so`` (the hash covers the source, the headers of
``csrc/`` it may include and the flags, so an edited source never loads a
stale library).  Nothing is built when a module is imported: :func:`load`
builds on first use, and :func:`build_all` starts one ``nvcc`` per source
at once.  ``_build/`` is git-ignored.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # optimize a source's kernels on every core: window_sums.cu's 96
    # instances build in about half the time, to the same SASS
    "-split-compile=0",
)
SOURCES = ("fused_sums", "window_sums", "csr_products")
#: the directory of the headers the sources share (on nvcc's include path)
INCLUDE = Path(__file__).with_name("csrc")

_loaded: Dict[str, ctypes.CDLL] = {}

#: memo-key declaration (tpu_sgd_torch/analysis): the loaded libraries are
#: keyed by source name; the library path hashes the source, the shared
#: headers and the flags, so a changed source builds a new library file
GRAFTLINT_MEMO = {"_loaded": ("name",)}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc was not found on PATH or under CUDA_HOME; the CUDA "
            "kernels of tpu_sgd_torch are built with it on first use"
        )
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(INCLUDE.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(proc, tmp, out)`` or
    ``None`` when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every source in parallel (one ``nvcc`` each); returns, per
    source, the library path, the seconds it took (0 when it was already
    built) and the compiler's output (``-Xptxas -v``: registers, shared
    memory and spills of each kernel).  Raises ``RuntimeError`` with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    report = {}
    for name, job in started.items():
        if job is None:
            report[name] = {"path": str(library_path(name)), "seconds": 0.0,
                            "log": ""}
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a reader never sees half a library
        report[name] = {"path": str(out),
                        "seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib: Optional[ctypes.CDLL] = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
