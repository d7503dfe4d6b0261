"""Gradients, updaters, sparse features, the sufficient statistics of least
squares and the fused CUDA kernels of the port."""

from tpu_sgd_torch.ops.cuda_kernels import (
    FusedGradient,
    fused_gradient_sums,
    fused_window_sums,
    fused_window_sums_vpu,
)
from tpu_sgd_torch.ops.gradients import (
    ChunkedGradient,
    Gradient,
    HingeGradient,
    LeastSquaresGradient,
    LogisticGradient,
    MultinomialLogisticGradient,
)
from tpu_sgd_torch.ops.gram import GramData, GramLeastSquaresGradient
from tpu_sgd_torch.ops.sparse import (
    append_bias_auto,
    append_bias_sparse,
    csr_from_triple,
    is_sparse,
    load_libsvm_file_csr,
    row_matrix,
    sparse_data,
    take_rows,
)
from tpu_sgd_torch.ops.updaters import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
    Updater,
)

__all__ = [
    "FusedGradient", "fused_gradient_sums", "fused_window_sums",
    "fused_window_sums_vpu", "ChunkedGradient", "Gradient",
    "GramData", "GramLeastSquaresGradient", "HingeGradient",
    "LeastSquaresGradient", "LogisticGradient",
    "MultinomialLogisticGradient", "append_bias_auto",
    "append_bias_sparse", "csr_from_triple", "is_sparse",
    "load_libsvm_file_csr", "row_matrix", "sparse_data", "take_rows",
    "L1Updater",
    "SimpleUpdater", "SquaredL2Updater", "Updater",
]
