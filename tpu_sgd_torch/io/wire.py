"""Opt-in wire format for the host->device hop: the port of
``tpu_sgd/io/wire.py``.

The host-streamed paths move every sampled batch over PCIe, so the bytes
on the wire are the feed's cost.  ``wire_dtype="bfloat16"`` casts each
batch on the HOST (in its pinned staging slot), moves half the bytes, and
the card's kernels accumulate in f32 as for any bf16 X: accumulation
precision is unchanged, only the INPUT values are rounded to bf16 (~0.4%
relative).  bf16 is torch's own type, so the port needs no ``ml_dtypes``
(numpy has no bf16; a bf16 host dataset is a CPU torch tensor).

When that is safe: the north-star host dataset is already bf16 (zero
rounding), and SGD on f32 data tolerates input rounding far below its own
sampling noise.  When it is not: runs that must be bit-reproducible
against an f32 resident run, or data whose information lives below bf16's
8 mantissa bits.  The default is OFF (``wire_dtype=None``: the data
dtype).
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch


def as_torch_dtype(name) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name
    (``"bfloat16"``, ``"float32"``, ``np.float16`` ...)."""
    if isinstance(name, torch.dtype):
        return name
    if isinstance(name, str) and name in ("bfloat16", "bf16"):
        return torch.bfloat16
    return torch.from_numpy(np.zeros((0,), np.dtype(name))).dtype


def resolve_wire_dtype(wire_dtype, data_dtype) -> Optional[torch.dtype]:
    """The host-side cast target of a streaming path, or None for
    "transfer as-is" (no cast, bit-identical wire).

    ``None`` passes through; a wire dtype equal to the data dtype also
    resolves to None (nothing to cast).  Non-floating wire dtypes raise:
    an int wire would silently truncate every element."""
    if wire_dtype is None:
        return None
    wd = as_torch_dtype(wire_dtype)
    if not wd.is_floating_point:
        raise ValueError(
            f"wire_dtype must be a floating dtype, got {wd}; use "
            "'bfloat16' (half the bytes) or None (data dtype)")
    if wd == as_torch_dtype(data_dtype):
        return None
    return wd


def host_tensor(a) -> torch.Tensor:
    """A host array (numpy array, ``np.memmap`` or CPU tensor, a
    ``torch.from_file`` map included) as a CPU tensor, never copied: the
    ranks of a mesh on one host map ONE file, and a copy per rank would
    multiply the host memory.  A read-only array (``np.load(...,
    mmap_mode="r")``) is wrapped as it is: the streamed paths only read
    their host rows."""
    if isinstance(a, torch.Tensor):
        if a.is_cuda:
            raise ValueError(
                "host streaming takes host data (a numpy array or a CPU "
                "tensor); this tensor already lies on the card")
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        with warnings.catch_warnings():
            # torch warns that it cannot protect a read-only buffer;
            # nothing here writes to it
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(a)
    return torch.from_numpy(a)


def wire_cast(a, wire: Optional[torch.dtype]) -> torch.Tensor:
    """Host cast to the resolved wire dtype (the tensor itself when the
    wire is None or already matches: zero-copy)."""
    t = host_tensor(a)
    if wire is None or t.dtype == wire:
        return t
    return t.to(wire)
