"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point of ``tpu_sgd_torch`` takes ``device=None`` and resolves it
here, so the rule lives in one place: ``None`` means ``"cuda"``, and a run
that asked for the card never drops to the CPU silently.
"""

from __future__ import annotations

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
