"""The optimizer boundary and mini-batch gradient descent."""

from tpu_sgd_torch.optimize.gradient_descent import (
    GradientDescent,
    make_run,
    make_step,
    run_mini_batch_sgd,
)
from tpu_sgd_torch.optimize.optimizer import Optimizer

__all__ = ["GradientDescent", "make_run", "make_step", "run_mini_batch_sgd",
           "Optimizer"]
