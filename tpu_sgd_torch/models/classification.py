"""Classification model families: logistic regression and linear SVM, the
port of ``tpu_sgd/models/classification.py:24-181``.

Reference defaults: step=1.0, iters=100, reg=0.01, frac=1.0 and the
squared-L2 updater; config 3 swaps the SVM's updater for L1.  Thresholds
are mutable and clearable (``clear_threshold`` makes ``predict`` return raw
scores).  The multinomial family waits for ROADMAP A1.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
)
from tpu_sgd_torch.models.regression import apply_train_options
from tpu_sgd_torch.ops.gradients import HingeGradient, LogisticGradient
from tpu_sgd_torch.ops.updaters import SquaredL2Updater
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent


class _ThresholdedModel(GeneralizedLinearModel):
    _default_threshold = 0.5

    def __init__(self, weights, intercept: float = 0.0, device=None):
        super().__init__(weights, intercept, device)
        self.threshold = self._default_threshold

    def set_threshold(self, t: float):
        self.threshold = float(t)
        return self

    def clear_threshold(self):
        """After this, ``predict`` returns raw scores (reference parity)."""
        self.threshold = None
        return self

    def score(self, margin):
        raise NotImplementedError

    def predict_point(self, margin):
        s = self.score(margin)
        if self.threshold is None:
            return s
        return (s > self.threshold).to(torch.float32)


class LogisticRegressionModel(_ThresholdedModel):
    """Sigmoid score thresholded at 0.5 by default."""

    def score(self, margin):
        return torch.sigmoid(margin)


class SVMModel(_ThresholdedModel):
    """Raw margin thresholded at 0.0 by default."""

    _default_threshold = 0.0

    def score(self, margin):
        return margin


class _BinaryClassifierWithSGD(GeneralizedLinearAlgorithm):
    _gradient_cls = None
    _model_cls = None

    def __init__(
        self,
        step_size: float = 1.0,
        num_iterations: int = 100,
        reg_param: float = 0.01,
        mini_batch_fraction: float = 1.0,
        device=None,
    ):
        super().__init__()
        self.optimizer = (
            GradientDescent(self._gradient_cls(), SquaredL2Updater(),
                            device=device)
            .set_step_size(step_size)
            .set_num_iterations(num_iterations)
            .set_reg_param(reg_param)
            .set_mini_batch_fraction(mini_batch_fraction)
        )

    def validators(self, X, y):
        """Binary label validator ([U] DataValidators.binaryLabelValidator)."""
        if isinstance(y, torch.Tensor):
            bad = (y != 0.0) & (y != 1.0)
            if bool(bad.any()):
                found = torch.unique(y[bad])[:5].cpu().numpy()
                raise ValueError(
                    f"Classification labels should be 0 or 1; found {found}")
            return
        y = np.asarray(y)
        bad = np.logical_and(y != 0.0, y != 1.0)
        if bad.any():
            raise ValueError(
                "Classification labels should be 0 or 1; found "
                f"{np.unique(y[bad])[:5]}"
            )

    def create_model(self, weights, intercept):
        return self._model_cls(weights, intercept)

    @classmethod
    def train(
        cls,
        data,
        num_iterations: int = 100,
        step_size: float = 1.0,
        reg_param: float = 0.01,
        mini_batch_fraction: float = 1.0,
        initial_weights=None,
        intercept: bool = False,
        updater=None,
        mesh=None,
        sampling: str = None,
        host_streaming: bool = False,
        schedule: str = None,
        device=None,
    ):
        alg = cls(step_size, num_iterations, reg_param, mini_batch_fraction,
                  device=device)
        alg.set_intercept(intercept)
        if updater is not None:
            alg.optimizer.set_updater(updater)
        apply_train_options(alg, mesh, sampling, host_streaming,
                            schedule=schedule)
        return alg.run(data, initial_weights)


class LogisticRegressionWithSGD(_BinaryClassifierWithSGD):
    """Binary logistic regression via SGD (config 2, BASELINE.json:8)."""

    _gradient_cls = LogisticGradient
    _model_cls = LogisticRegressionModel

    @classmethod
    def train(cls, data, num_iterations: int = 100, step_size: float = 1.0,
              mini_batch_fraction: float = 1.0, initial_weights=None,
              reg_param: float = 0.0, **kw):
        """Reference static parity: ``train(input, numIterations,
        stepSize, miniBatchFraction[, initialWeights])`` — the fraction is
        the FOURTH positional and the static call trains UNREGULARIZED
        (the reference's companion object hardcodes regParam 0.0; the
        constructor keeps the 0.01 class default)."""
        return super().train(
            data, num_iterations, step_size, reg_param=reg_param,
            mini_batch_fraction=mini_batch_fraction,
            initial_weights=initial_weights, **kw)


class SVMWithSGD(_BinaryClassifierWithSGD):
    """Linear SVM via hinge-loss SGD (config 3, BASELINE.json:9)."""

    _gradient_cls = HingeGradient
    _model_cls = SVMModel
