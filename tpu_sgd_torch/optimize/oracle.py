"""Independent oracles for the workload configs' pass criteria: the port of
``tpu_sgd/optimize/oracle.py``.

Config 1/4's least-squares objective has an exact minimizer through
:class:`NormalEquations`; config 2's logistic + L2 objective is smooth and
strongly convex, so a tight-tolerance L-BFGS run reaches its optimum to
far more digits than the 1% criterion; config 3's hinge + L1 objective
gets a tight OWL-QN run.  :func:`full_objective` evaluates the exact
objective each optimizer family minimizes (mean loss + its reg term), so
the gap ``(L(w) - L(w*)) / L(w*)`` is well-defined.

Tensors stay on their device; numpy inputs go to ``device`` (``None``:
the card).  Subgradient descent on the nonsmooth hinge converges at
O(1/sqrt(t)), so config 3's SGD criterion is a looser objective bound
plus accuracy parity (see the JAX module).
"""

from __future__ import annotations

import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gradients import (
    Gradient,
    HingeGradient,
    LogisticGradient,
)


def _place(X, device):
    """The device of a tensor X, else ``device`` resolved."""
    return X.device if isinstance(X, torch.Tensor) else resolve_device(device)


def full_objective(
    gradient: Gradient, X, y, weights, reg_param: float = 0.0,
    reg: str = "none", device=None,
) -> float:
    """Exact full-dataset objective ``mean loss + reg term`` for
    ``weights``.  ``reg``: 'none', 'l2' (0.5·λ‖w‖², the SquaredL2Updater
    objective) or 'l1' (λ‖w‖₁, the L1Updater/OWLQN objective)."""
    if reg not in ("none", "l2", "l1"):
        raise ValueError(f"unknown reg kind {reg!r}")
    dev = _place(X, device)
    X = as_tensor(X, dev)
    if not X.dtype.is_floating_point or X.dtype == torch.float64:
        X = X.to(torch.float32)
    w = as_tensor(weights, dev, torch.float32)
    _, loss_sum, count = gradient.batch_sums(
        X, as_tensor(y, dev, torch.float32), w)
    val = float(loss_sum) / float(count)
    if reg == "l2":
        val += 0.5 * reg_param * float(torch.sum(w * w))
    elif reg == "l1":
        val += reg_param * float(torch.sum(torch.abs(w)))
    return val


def least_squares_oracle(X, y, device=None):
    """Exact least-squares minimizer via the normal equations (config 1/4)."""
    from tpu_sgd_torch.optimize.normal import NormalEquations

    dev = _place(X, device)
    return NormalEquations(device=dev).optimize(
        (X, y), torch.zeros((X.shape[1],), dtype=torch.float32)
    )


def logistic_l2_oracle(X, y, reg_param: float, max_iterations: int = 400,
                       device=None):
    """Near-exact logistic+L2 minimizer: tight-tolerance LBFGS (config 2)."""
    from tpu_sgd_torch.ops.updaters import SquaredL2Updater
    from tpu_sgd_torch.optimize.lbfgs import LBFGS

    opt = LBFGS(
        LogisticGradient(), SquaredL2Updater(), reg_param=reg_param,
        convergence_tol=1e-12, max_num_iterations=max_iterations,
        device=_place(X, device),
    )
    return opt.optimize((X, y), torch.zeros((X.shape[1],),
                                            dtype=torch.float32))


def hinge_l1_oracle(X, y, reg_param: float, max_iterations: int = 500,
                    device=None):
    """Tight OWL-QN run on hinge+L1 (config 3's reference point)."""
    from tpu_sgd_torch.optimize.owlqn import OWLQN

    opt = OWLQN(
        HingeGradient(), reg_param=reg_param, convergence_tol=1e-12,
        max_num_iterations=max_iterations, device=_place(X, device),
    )
    return opt.optimize((X, y), torch.zeros((X.shape[1],),
                                            dtype=torch.float32))


def objective_gap(
    gradient: Gradient, X, y, weights, oracle_weights,
    reg_param: float = 0.0, reg: str = "none", device=None,
):
    """Relative optimality gap ``(L(w) - L(w*)) / max(L(w*), eps)`` plus the
    two objective values, for reporting."""
    L = full_objective(gradient, X, y, weights, reg_param, reg, device)
    L_star = full_objective(gradient, X, y, oracle_weights, reg_param, reg,
                            device)
    return (L - L_star) / max(abs(L_star), 1e-12), L, L_star


__all__ = [
    "full_objective",
    "least_squares_oracle",
    "logistic_l2_oracle",
    "hinge_l1_oracle",
    "objective_gap",
]
