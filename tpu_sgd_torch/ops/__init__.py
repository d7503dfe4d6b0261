"""Gradients, updaters and the fused CUDA kernels of the port."""

from tpu_sgd_torch.ops.cuda_kernels import (
    FusedGradient,
    fused_gradient_sums,
    fused_window_sums,
    fused_window_sums_vpu,
)
from tpu_sgd_torch.ops.gradients import (
    Gradient,
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
)
from tpu_sgd_torch.ops.updaters import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
    Updater,
)

__all__ = [
    "FusedGradient", "fused_gradient_sums", "fused_window_sums",
    "fused_window_sums_vpu", "Gradient", "HingeGradient",
    "LeastSquaresGradient", "LogisticGradient", "L1Updater",
    "SimpleUpdater", "SquaredL2Updater", "Updater",
]
