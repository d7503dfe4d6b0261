"""Regression model families, SGD-trained: the port of the ``*WithSGD``
families of ``tpu_sgd/models/regression.py``.

Each family is the GLM harness plus a (Gradient, Updater) pair and the
reference's defaults: step=1.0, iters=100, frac=1.0; reg=0.0 for plain
linear, 0.01 for Lasso/Ridge.  The quasi-Newton and normal-equations
families wait for ROADMAP A7/A8, model persistence for A4.
"""

from __future__ import annotations

from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
)
from tpu_sgd_torch.ops.gradients import LeastSquaresGradient
from tpu_sgd_torch.ops.updaters import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
)
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent


class LinearRegressionModel(GeneralizedLinearModel):
    """Prediction is the raw margin ``x.w + b``."""

    def predict_point(self, margin):
        return margin


class LassoModel(LinearRegressionModel):
    pass


class RidgeRegressionModel(LinearRegressionModel):
    pass


def apply_train_options(alg, mesh=None, sampling=None,
                        host_streaming=False, sufficient_stats=False,
                        schedule=None):
    """The static ``train`` options shared by every SGD family; those of
    later slices raise ``NotImplementedError`` through their setters."""
    if mesh is not None:
        alg.optimizer.set_mesh(mesh)
    if sampling is not None:
        alg.optimizer.set_sampling(sampling)
    if host_streaming:
        alg.optimizer.set_host_streaming(True)
    if sufficient_stats:
        alg.optimizer.set_sufficient_stats(True)
    if schedule is not None:
        alg.set_schedule(schedule)


class _RegressionWithSGD(GeneralizedLinearAlgorithm):
    _gradient_cls = LeastSquaresGradient
    _updater_cls = SimpleUpdater
    _model_cls = LinearRegressionModel
    _default_reg = 0.0

    def __init__(
        self,
        step_size: float = 1.0,
        num_iterations: int = 100,
        reg_param: float = None,
        mini_batch_fraction: float = 1.0,
        device=None,
    ):
        super().__init__()
        if reg_param is None:
            reg_param = self._default_reg
        self.optimizer = (
            GradientDescent(self._gradient_cls(), self._updater_cls(),
                            device=device)
            .set_step_size(step_size)
            .set_num_iterations(num_iterations)
            .set_reg_param(reg_param)
            .set_mini_batch_fraction(mini_batch_fraction)
        )

    def create_model(self, weights, intercept):
        return self._model_cls(weights, intercept)

    @classmethod
    def train(
        cls,
        data,
        num_iterations: int = 100,
        step_size: float = 1.0,
        reg_param: float = None,
        mini_batch_fraction: float = 1.0,
        initial_weights=None,
        intercept: bool = False,
        mesh=None,
        sampling: str = None,
        host_streaming: bool = False,
        sufficient_stats: bool = False,
        schedule: str = None,
        device=None,
    ):
        """Static train() parity with the reference's object methods.
        ``sampling`` picks the mini-batch sampler (``SGDConfig.sampling``);
        ``device=None`` trains on the card.  ``mesh``, ``host_streaming``,
        ``sufficient_stats`` and a ``schedule`` other than ``"off"`` belong
        to later slices and raise ``NotImplementedError``."""
        alg = cls(step_size, num_iterations, reg_param, mini_batch_fraction,
                  device=device)
        alg.set_intercept(intercept)
        apply_train_options(alg, mesh, sampling, host_streaming,
                            sufficient_stats, schedule)
        return alg.run(data, initial_weights)


class LinearRegressionWithSGD(_RegressionWithSGD):
    """Least squares, no regularization (config 1, BASELINE.json:7)."""

    @classmethod
    def train(cls, data, num_iterations: int = 100, step_size: float = 1.0,
              mini_batch_fraction: float = 1.0, initial_weights=None, **kw):
        """Reference static parity: ``train(input, numIterations,
        stepSize, miniBatchFraction, initialWeights)`` — the fraction is
        the FOURTH positional (there is no regParam slot)."""
        return super().train(
            data, num_iterations, step_size,
            mini_batch_fraction=mini_batch_fraction,
            initial_weights=initial_weights, **kw)


class LassoWithSGD(_RegressionWithSGD):
    """Least squares + L1 prox updater."""

    _updater_cls = L1Updater
    _model_cls = LassoModel
    _default_reg = 0.01


class RidgeRegressionWithSGD(_RegressionWithSGD):
    """Least squares + squared-L2 updater."""

    _updater_cls = SquaredL2Updater
    _model_cls = RidgeRegressionModel
    _default_reg = 0.01
