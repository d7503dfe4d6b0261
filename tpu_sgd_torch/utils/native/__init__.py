"""The native C++ LIBSVM parser, loaded with ctypes: the port's copy of
``tpu_sgd/utils/native`` (the parser only; the JAX package's row gather is
``torch.index_select`` here).

``libsvm_parser.cpp`` is compiled at first use with the host C++ compiler
(``$CXX``, else ``g++``) into ``_build/libsvm_parser-<hash>.so`` (the hash
covers the source and the flags, so an edited source never loads a stale
library; ``_build/`` is git-ignored), written under a temporary name and
renamed, so concurrent first uses never load half a library.  Nothing is
built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).with_name("libsvm_parser.cpp")
BUILD_DIR = Path(__file__).with_name("_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsvm_parser-{digest[:16]}.so"


def build() -> Path:
    """Compile the parser unless it is built; returns the library's path.
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.parse_libsvm_count.restype = ctypes.c_int64
            lib.parse_libsvm_count.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),  # n_rows out
                ctypes.POINTER(ctypes.c_int64),  # n_nz out
            ]
            lib.parse_libsvm_fill.restype = ctypes.c_int64
            lib.parse_libsvm_fill.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ]
            _lib = lib
    return _lib


def parse_libsvm(path: str):
    """Parse a LIBSVM file natively: ``(labels, rows, cols, vals,
    max_index)``, as the Python parser returns them.  Raises ``IOError``
    on a file it cannot read or parse (a 0 index, a malformed token)."""
    lib = _load()
    n_rows = ctypes.c_int64()
    n_nz = ctypes.c_int64()
    rc = lib.parse_libsvm_count(path.encode(), ctypes.byref(n_rows),
                                ctypes.byref(n_nz))
    if rc != 0:
        raise IOError(f"native parser failed to open/scan {path} (rc={rc})")
    labels = np.empty((n_rows.value,), np.float32)
    rows = np.empty((n_nz.value,), np.int64)
    cols = np.empty((n_nz.value,), np.int64)
    vals = np.empty((n_nz.value,), np.float32)
    max_idx = lib.parse_libsvm_fill(path.encode(), labels, rows, cols, vals)
    if max_idx < 0:
        raise IOError(f"native parser failed to parse {path} (rc={max_idx})")
    return labels, rows, cols, vals, int(max_idx)
