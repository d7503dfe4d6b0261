"""Weight updaters: the port of ``tpu_sgd/ops/updaters.py``.

Contract: ``compute(weights_old, gradient, step_size, iter, reg_param) ->
(weights_new, reg_val)``; the effective step is ``step_size / sqrt(iter)``,
computed in float32 as the JAX package does, and ``reg_val`` is the
regularization value of the *new* weights.  ``iter_num`` is a host integer,
so the step never needs the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _this_step(step_size, iter_num) -> float:
    """``step_size / sqrt(iter)`` rounded through float32, like
    ``step_size / jnp.sqrt(jnp.asarray(iter_num, jnp.float32))``."""
    return float(np.float32(step_size) / np.sqrt(np.float32(iter_num)))


class Updater:
    """Base plugin. Subclasses implement :meth:`compute`."""

    def compute(
        self,
        weights_old: torch.Tensor,
        gradient: torch.Tensor,
        step_size: float,
        iter_num: int,
        reg_param: float,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class SimpleUpdater(Updater):
    """Plain SGD step, no regularization: ``w' = w - (eta/sqrt(t)) * g``."""

    def compute(self, weights_old, gradient, step_size, iter_num, reg_param):
        w = weights_old - _this_step(step_size, iter_num) * gradient
        return w, torch.zeros((), dtype=w.dtype, device=w.device)


class L1Updater(Updater):
    """Lasso prox step: gradient step, then soft-thresholding of the
    *post-step* weights by ``reg_param * eta_t``;
    ``reg_val = reg_param * ||w'||_1``."""

    def compute(self, weights_old, gradient, step_size, iter_num, reg_param):
        this_step = _this_step(step_size, iter_num)
        w = weights_old - this_step * gradient
        shrink = float(np.float32(reg_param) * np.float32(this_step))
        w = torch.sign(w) * torch.clamp(torch.abs(w) - shrink, min=0.0)
        reg_val = reg_param * torch.sum(torch.abs(w))
        return w, reg_val


class SquaredL2Updater(Updater):
    """Ridge step: ``w' = w * (1 - eta_t * reg) - eta_t * g``;
    ``reg_val = 0.5 * reg * ||w'||^2``."""

    def compute(self, weights_old, gradient, step_size, iter_num, reg_param):
        this_step = _this_step(step_size, iter_num)
        decay = float(np.float32(1.0) - np.float32(this_step)
                      * np.float32(reg_param))
        w = weights_old * decay - this_step * gradient
        reg_val = 0.5 * reg_param * torch.sum(w * w)
        return w, reg_val
