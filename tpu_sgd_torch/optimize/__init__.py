"""The optimizer boundary: mini-batch gradient descent, L-BFGS, OWL-QN and
the normal equations."""

from tpu_sgd_torch.optimize.gradient_descent import (
    GradientDescent,
    make_run,
    make_step,
    run_mini_batch_sgd,
)
from tpu_sgd_torch.optimize.lbfgs import LBFGS, run_lbfgs
from tpu_sgd_torch.optimize.normal import NormalEquations
from tpu_sgd_torch.optimize.optimizer import Optimizer
from tpu_sgd_torch.optimize.owlqn import OWLQN

__all__ = ["GradientDescent", "LBFGS", "NormalEquations", "OWLQN",
           "make_run", "make_step", "run_mini_batch_sgd", "run_lbfgs",
           "Optimizer"]
