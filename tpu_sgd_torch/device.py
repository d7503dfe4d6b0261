"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point of ``tpu_sgd_torch`` takes ``device=None`` and resolves it
here, so the rule lives in one place: ``None`` means ``"cuda"``, and a run
that asked for the card never drops to the CPU silently.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises
    ``RuntimeError``; ``"cpu"`` is honoured (the tests pass it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_sgd_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run the plain PyTorch path on the CPU"
        )
    return dev


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (numpy array, tensor or sequence) as a tensor on ``device``;
    a tensor already there with the right dtype is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch cannot wrap a read-only buffer
    return torch.as_tensor(x, dtype=dtype, device=device)


@contextlib.contextmanager
def true_f32_matmul():
    """Run the enclosed float32 matmuls in true f32 on a CUDA device: no
    TF32, and no reduced-precision reduction in bf16 products.  The
    settings are process-wide, so they are restored on exit.  (The normal
    equations' loss is a difference of ``|y|^2``-sized terms, and a
    correlation matrix must not carry TF32's ~1e-3 error.)"""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = prev
