"""GLM harness and the model families."""

from tpu_sgd_torch.models.classification import (
    LogisticRegressionModel,
    LogisticRegressionWithLBFGS,
    LogisticRegressionWithSGD,
    MultinomialLogisticRegressionModel,
    SVMModel,
    SVMWithSGD,
)
from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
)
from tpu_sgd_torch.models.labeled_point import LabeledPoint, to_arrays
from tpu_sgd_torch.models.regression import (
    LassoModel,
    LassoWithOWLQN,
    LassoWithSGD,
    LinearRegressionModel,
    LinearRegressionWithLBFGS,
    LinearRegressionWithNormal,
    LinearRegressionWithSGD,
    RidgeRegressionModel,
    RidgeRegressionWithSGD,
)
from tpu_sgd_torch.models.streaming import (
    StreamingLinearAlgorithm,
    StreamingLinearRegressionWithSGD,
    StreamingLogisticRegressionWithSGD,
)

__all__ = [
    "LogisticRegressionModel", "LogisticRegressionWithSGD", "SVMModel",
    "SVMWithSGD", "GeneralizedLinearAlgorithm", "GeneralizedLinearModel",
    "LabeledPoint", "to_arrays", "LassoModel", "LassoWithOWLQN",
    "LassoWithSGD", "LinearRegressionModel", "LinearRegressionWithLBFGS",
    "LinearRegressionWithNormal", "LinearRegressionWithSGD",
    "LogisticRegressionWithLBFGS", "MultinomialLogisticRegressionModel",
    "RidgeRegressionModel", "RidgeRegressionWithSGD",
    "StreamingLinearAlgorithm", "StreamingLinearRegressionWithSGD",
    "StreamingLogisticRegressionWithSGD",
]
