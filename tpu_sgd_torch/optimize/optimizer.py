"""The Optimizer plugin boundary: the port of ``tpu_sgd/optimize/optimizer.py``.

``data`` is an ``(X, y)`` pair of tensors (or arrays) and weights are 1-D
tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
Dataset = Tuple[Tensor, Tensor]  # (X: (n, d), y: (n,))


class Optimizer:
    """Anything that maps ``(data, initial_weights) -> weights``."""

    def optimize(self, data: Dataset, initial_weights: Tensor) -> Tensor:
        raise NotImplementedError
