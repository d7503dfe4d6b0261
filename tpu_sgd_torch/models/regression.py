"""Regression model families: the port of ``tpu_sgd/models/regression.py``.

The ``*WithSGD`` families are the GLM harness plus a (Gradient, Updater)
pair and the reference's defaults: step=1.0, iters=100, frac=1.0; reg=0.0
for plain linear, 0.01 for Lasso/Ridge.  ``LassoWithOWLQN``,
``LinearRegressionWithLBFGS`` and ``LinearRegressionWithNormal`` put the
quasi-Newton and exact solvers behind the same harness.  Models save and
load in the JAX package's format (``utils/persistence.py``).
"""

from __future__ import annotations

from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
    load_model,
    save_model,
)
from tpu_sgd_torch.ops.gradients import LeastSquaresGradient
from tpu_sgd_torch.ops.updaters import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
)
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.optimize.lbfgs import LBFGS
from tpu_sgd_torch.optimize.normal import NormalEquations
from tpu_sgd_torch.optimize.owlqn import OWLQN


class LinearRegressionModel(GeneralizedLinearModel):
    """Prediction is the raw margin ``x.w + b``."""

    def predict_point(self, margin):
        return margin

    save = save_model
    load = classmethod(load_model)


class LassoModel(LinearRegressionModel):
    pass


class RidgeRegressionModel(LinearRegressionModel):
    pass


def apply_train_options(alg, mesh=None, sampling=None,
                        host_streaming=False, sufficient_stats=False,
                        schedule=None):
    """The static ``train`` options shared by every SGD family (a mesh
    with host streaming on a 2-D mesh raises when the run starts).
    ``schedule``: the planner's policy (``set_schedule``; None keeps
    ``"auto"``)."""
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
        ``device=None`` trains on the card.  ``mesh`` (a
        ``parallel.Mesh``, 1-D or 2-D) trains on this rank's rows.  With
        no schedule-related argument the execution planner
        (``tpu_sgd_torch/plan.py``) picks the schedule and logs one
        ``plan: ...`` line; ``schedule=`` forces a named schedule or turns
        planning off (``"off"``).  Manual flags always win over the
        planner."""
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


class LassoWithOWLQN(GeneralizedLinearAlgorithm):
    """Lasso via OWL-QN (upstream Spark's Breeze ``OWLQN``): exact zeros on
    null coordinates and quasi-Newton convergence, with the harness and
    model class of ``LassoWithSGD``."""

    _model_cls = LassoModel

    def __init__(self, reg_param: float = 0.01,
                 max_num_iterations: int = 100, device=None):
        super().__init__()
        self.optimizer = OWLQN(
            LeastSquaresGradient(),
            reg_param=reg_param,
            max_num_iterations=max_num_iterations,
            device=device,
        )

    def set_intercept(self, flag: bool):
        # the bias is the appended LAST column; upstream gives it zero L1
        # strength, so it is never shrunk to 0
        self.optimizer.set_penalize_intercept(not flag)
        return super().set_intercept(flag)

    def create_model(self, weights, intercept):
        return self._model_cls(weights, intercept)

    @classmethod
    def train(cls, data, reg_param: float = 0.01,
              max_num_iterations: int = 100, intercept: bool = False,
              sufficient_stats: bool = False, device=None):
        alg = cls(reg_param, max_num_iterations, device=device)
        alg.set_intercept(intercept)
        if sufficient_stats:
            alg.optimizer.set_sufficient_stats(True)
        return alg.run(data)


class LinearRegressionWithLBFGS(GeneralizedLinearAlgorithm):
    """Least squares via L-BFGS behind the same harness; the natural pairing
    for ``set_feature_scaling`` (unit-variance columns condition the
    inverse-Hessian pairs)."""

    _model_cls = LinearRegressionModel

    def __init__(self, reg_param: float = 0.0,
                 max_num_iterations: int = 100,
                 convergence_tol: float = 1e-6, device=None):
        super().__init__()
        self.optimizer = LBFGS(
            LeastSquaresGradient(),
            SquaredL2Updater(),
            reg_param=reg_param,
            max_num_iterations=max_num_iterations,
            convergence_tol=convergence_tol,
            device=device,
        )

    def create_model(self, weights, intercept):
        return self._model_cls(weights, intercept)

    @classmethod
    def train(cls, data, reg_param: float = 0.0,
              max_num_iterations: int = 100, intercept: bool = False,
              feature_scaling: bool = False, mesh=None,
              sufficient_stats: bool = False, device=None):
        alg = cls(reg_param, max_num_iterations, device=device)
        alg.set_intercept(intercept)
        alg.set_feature_scaling(feature_scaling)
        if mesh is not None:
            alg.optimizer.set_mesh(mesh)
        if sufficient_stats:
            alg.optimizer.set_sufficient_stats(True)
        return alg.run(data)


class LinearRegressionWithNormal(GeneralizedLinearAlgorithm):
    """Exact least squares via the one-pass normal-equations solver
    (upstream ``spark.ml``'s WeightedLeastSquares "normal" solver), with
    the harness, intercept handling and model class of the SGD family;
    ``reg_param > 0`` gives exact ridge regression."""

    _model_cls = LinearRegressionModel

    def __init__(self, reg_param: float = 0.0, device=None):
        super().__init__()
        self.optimizer = NormalEquations(reg_param, device=device)

    def create_model(self, weights, intercept):
        return self._model_cls(weights, intercept)

    @classmethod
    def train(cls, data, reg_param: float = 0.0, intercept: bool = False,
              mesh=None, device=None):
        alg = cls(reg_param, device=device)
        alg.set_intercept(intercept)
        if mesh is not None:
            alg.optimizer.set_mesh(mesh)
        return alg.run(data)
