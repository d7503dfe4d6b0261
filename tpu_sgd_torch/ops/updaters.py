"""Weight updaters: the port of ``tpu_sgd/ops/updaters.py``.

Contract: ``compute(weights_old, gradient, step_size, iter, reg_param) ->
(weights_new, reg_val)``; the effective step is ``step_size / sqrt(iter)``,
computed in float32 as the JAX package does, and ``reg_val`` is the
regularization value of the *new* weights.  ``iter_num`` is a host integer
or an integer tensor of one element on the weights' device (the
optimizer's iteration counter): the step is computed on the device from
it, so a captured CUDA graph that advances the counter takes each
iteration's own step.  It equals the host's ``np.float32(step_size) /
np.sqrt(np.float32(iter))`` bit for bit (pinned for iter = 1 … 10⁶ in
``tests/test_torch_superstep.py`` and by ``chip_smoke.py`` on the card):
the square root is taken in float64 and rounded once to float32, since
torch's vectorized float32 square root on the CPU is not correctly
rounded in every case, and the float32 division is.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _f32(value, device) -> torch.Tensor:
    """A host scalar as a float32 0-d tensor, made by a fill (rounded to
    nearest, as ``np.float32`` rounds): no host-to-device copy, so it can
    be captured."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _this_step(step_size, iter_num, device=None) -> torch.Tensor:
    """``step_size / sqrt(iter)`` in float32 on the device, like
    ``step_size / jnp.sqrt(jnp.asarray(iter_num, jnp.float32))``.  A
    one-element counter gives a 0-d step; a longer integer tensor gives
    the step of each of its entries."""
    if isinstance(iter_num, torch.Tensor):
        t = iter_num.to(torch.float64)
        if t.numel() == 1:
            t = t.reshape(())
    else:
        t = torch.full((), float(iter_num), dtype=torch.float64,
                       device=device)
    root = torch.sqrt(t).to(torch.float32)
    # a tensor divided by a tensor: on the card a division by a host
    # scalar runs as a multiplication by its reciprocal
    return torch.div(_f32(step_size, t.device), root)


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
        this_step = _this_step(step_size, iter_num, weights_old.device)
        w = weights_old - this_step * gradient
        return w, torch.zeros((), dtype=w.dtype, device=w.device)


class L1Updater(Updater):
    """Lasso prox step: gradient step, then soft-thresholding of the
    *post-step* weights by ``reg_param * eta_t``;
    ``reg_val = reg_param * ||w'||_1``."""

    def compute(self, weights_old, gradient, step_size, iter_num, reg_param):
        this_step = _this_step(step_size, iter_num, weights_old.device)
        w = weights_old - this_step * gradient
        shrink = _f32(reg_param, w.device) * this_step
        w = torch.sign(w) * torch.clamp(torch.abs(w) - shrink, min=0.0)
        reg_val = reg_param * torch.sum(torch.abs(w))
        return w, reg_val


class SquaredL2Updater(Updater):
    """Ridge step: ``w' = w * (1 - eta_t * reg) - eta_t * g``;
    ``reg_val = 0.5 * reg * ||w'||^2``."""

    def compute(self, weights_old, gradient, step_size, iter_num, reg_param):
        dev = weights_old.device
        this_step = _this_step(step_size, iter_num, dev)
        decay = _f32(1.0, dev) - this_step * _f32(reg_param, dev)
        w = weights_old * decay - this_step * gradient
        reg_val = 0.5 * reg_param * torch.sum(w * w)
        return w, reg_val
