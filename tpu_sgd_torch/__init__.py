"""PyTorch/CUDA port of ``tpu_sgd``: mini-batch and streaming SGD,
L-BFGS, OWL-QN and the normal equations for generalized linear models, on
dense or sparse features, least squares also from block-prefix Gram
statistics, on one NVIDIA H100, with evaluation metrics,
feature scaling, column statistics and model persistence, and the
observed driver's planes: listeners and event logs (``utils.events``),
checkpoints (``utils.checkpoint``), fault injection, retry and the
training supervisor (``reliability``), span tracing and the windowed
time series (``obs``), and serving (``serve``: micro-batched endpoints
with admission control and hot reload; ``tenant``: many tenants' models
on one weight slab).
``train()`` plans its schedule (``plan``: resident, from statistics, or
streamed from host memory) unless told ``schedule="off"``.
SGD runs K iterations a host call, as one CUDA graph replay on the card,
on one device or data-parallel over a ``torch.distributed`` mesh
(``parallel``).

The JAX package ``tpu_sgd`` stays the reference; this package imports
nothing of it, nor JAX.  Its hot step, the fused ``(grad_sum, loss_sum,
count)`` of a mini-batch, is a CUDA kernel written by hand for Hopper
(``ops/csrc/fused_sums.cu``), built with ``nvcc`` on first use.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from tpu_sgd_torch.config import MeshConfig, SGDConfig
from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.evaluation import (
    BinaryClassificationMetrics,
    MulticlassMetrics,
    RegressionMetrics,
)
from tpu_sgd_torch.feature import (
    Normalizer,
    StandardScaler,
    StandardScalerModel,
)
from tpu_sgd_torch.interop import (
    glm_model_from_numpy,
    gram_data_from_numpy,
    multinomial_model_from_numpy,
    sgd_config_from_dict,
)
from tpu_sgd_torch.linalg import BLAS, DenseVector, SparseVector, Vectors
from tpu_sgd_torch.models import *  # noqa: F401,F403
from tpu_sgd_torch.models import __all__ as _models_all
from tpu_sgd_torch.ops import *  # noqa: F401,F403
from tpu_sgd_torch.ops import __all__ as _ops_all
from tpu_sgd_torch.optimize import (
    LBFGS,
    OWLQN,
    GradientDescent,
    NormalEquations,
    Optimizer,
    run_lbfgs,
    run_mini_batch_sgd,
)
from tpu_sgd_torch.parallel import data_mesh, make_mesh
# the bare `plan` FUNCTION is not exported: the package attribute
# `tpu_sgd_torch.plan` must keep naming the MODULE
from tpu_sgd_torch.plan import (
    CostModel,
    Plan,
    device_budget,
    plan_for,
    plan_quasi_newton,
)
from tpu_sgd_torch.stat import MultivariateStatisticalSummary, col_stats, corr
from tpu_sgd_torch.utils.mlutils import (
    a9a_like_data,
    linear_data,
    logistic_data,
    svm_data,
)

__all__ = (
    ["SGDConfig", "MeshConfig", "data_mesh", "make_mesh", "resolve_device", "glm_model_from_numpy",
     "gram_data_from_numpy",
     "multinomial_model_from_numpy", "sgd_config_from_dict", "Vectors",
     "DenseVector", "SparseVector", "BLAS", "GradientDescent", "LBFGS",
     "NormalEquations", "OWLQN", "Optimizer", "run_mini_batch_sgd",
     "CostModel", "Plan", "device_budget", "plan_for", "plan_quasi_newton",
     "run_lbfgs", "Normalizer", "StandardScaler", "StandardScalerModel",
     "RegressionMetrics", "BinaryClassificationMetrics",
     "MulticlassMetrics", "col_stats", "corr",
     "MultivariateStatisticalSummary", "a9a_like_data", "linear_data",
     "logistic_data", "svm_data"]
    + list(_models_all) + list(_ops_all)
)
