"""Classification model families: logistic regression (SGD, or L-BFGS,
binary or multinomial) and linear SVM, the port of
``tpu_sgd/models/classification.py``.

Reference defaults: step=1.0, iters=100, reg=0.01, frac=1.0 and the
squared-L2 updater; config 3 swaps the SVM's updater for L1.  Thresholds
are mutable and clearable (``clear_threshold`` makes ``predict`` return raw
scores).  Models save and load in the JAX package's format
(``utils/persistence.py``).  The multinomial model predicts a dense batch
through ``predict_dense_bucketed`` (the bucketed ``X @ Wᵀ`` of
``ops/bucketed.py`` and the pivot rule on the device, the path the
serving engine takes), a sparse one through the CSR product.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
    _as_arrays,
    _single,
    load_model,
    save_model,
)
from tpu_sgd_torch.models.regression import apply_train_options
from tpu_sgd_torch.ops.bucketed import (DEFAULT_BUCKETS, bucketed_matvec,
                                        dense_rows)
from tpu_sgd_torch.ops.gradients import (
    HingeGradient,
    LogisticGradient,
    MultinomialLogisticGradient,
    f32_product,
    pivot_class_traced,
)
from tpu_sgd_torch.ops.sparse import append_bias_auto
from tpu_sgd_torch.ops.updaters import SquaredL2Updater
from tpu_sgd_torch.optimize.gradient_descent import GradientDescent
from tpu_sgd_torch.optimize.lbfgs import LBFGS
from tpu_sgd_torch.utils.mlutils import append_bias


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

    def _decide(self, scores):
        if self.threshold is None:
            return scores
        return (scores > self.threshold).to(torch.float32)

    def predict_point(self, margin):
        return self._decide(self.score(margin))


class LogisticRegressionModel(_ThresholdedModel):
    """Sigmoid score thresholded at 0.5 by default."""

    _activation = "sigmoid"

    def score(self, margin):
        return torch.sigmoid(margin)


class SVMModel(_ThresholdedModel):
    """Raw margin thresholded at 0.0 by default."""

    _default_threshold = 0.0

    def score(self, margin):
        return margin


for _cls in (LogisticRegressionModel, SVMModel):
    _cls.save = save_model
    _cls.load = classmethod(load_model)


def _check_labels(y, num_classes: int) -> None:
    """Labels must be integers in ``[0, num_classes)``; a tensor is
    checked on its device."""
    if isinstance(y, torch.Tensor):
        bad = (y < 0) | (y >= num_classes) | (y != torch.floor(y))
        found = torch.unique(y[bad])[:5].cpu().numpy() if bool(bad.any()) \
            else None
    else:
        yv = np.asarray(y)
        bad = (yv < 0) | (yv >= num_classes) | (yv != np.floor(yv))
        found = np.unique(yv[bad])[:5] if bad.any() else None
    if found is not None:
        raise ValueError(
            f"Classification labels should be integers in [0, "
            f"{num_classes}); found {found}"
        )


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


class MultinomialLogisticRegressionModel(GeneralizedLinearModel):
    """K-class logistic model over flat ``(K-1)*D`` weights with pivot
    class 0 (the reference's ``LogisticRegressionModel`` with
    ``numClasses > 2``).  Trained with an intercept, each class's
    intercept is its last weight (the bias-column convention), recorded
    in ``has_intercept_column`` so that predict never guesses from the
    input width."""

    def __init__(self, weights, intercept: float = 0.0, num_classes: int = 2,
                 num_features: int = None, has_intercept_column: bool = False,
                 device=None):
        super().__init__(weights, intercept, device)
        self.num_classes = int(num_classes)
        if num_features is None:
            num_features = self.weights.shape[-1] // (self.num_classes - 1)
        self.num_features = int(num_features)
        self.has_intercept_column = bool(has_intercept_column)

    def _check_width(self, width: int) -> None:
        expect = self.num_features - (1 if self.has_intercept_column else 0)
        if width != expect:
            raise ValueError(
                f"expected {expect}-feature input, got {width}"
            )

    def predict(self, X):
        """Predicted classes (float32) for one feature vector or a batch,
        on the weights' device.  A dense batch goes through
        :meth:`predict_dense_bucketed`, the serving engine's path; a
        sparse one, or one that needs autograd, through ``X @ Wᵀ`` in f32
        (the CSR kernel for a sparse X on the card) and the pivot rule."""
        if self._plain_route(X):
            Xb = self._batch(X)
            self._check_width(int(Xb.shape[-1]))
            if self.has_intercept_column:
                Xb = append_bias_auto(Xb)
            W = self.weights.reshape(self.num_classes - 1, Xb.shape[-1])
            out = pivot_class_traced(f32_product(Xb, W.T))
        else:
            out = self.predict_dense_bucketed(X)
        return out[0] if _single(X) else out

    def predict_dense_bucketed(self, X, buckets=None) -> torch.Tensor:
        """The one home of the dense multinomial decision path:
        validation, the bias column, per-class margins through the
        bucketed matvec (``ops/bucketed.py``) and the pivot argmax, all
        on the weights' device.  ``predict`` and the serving engine both
        route here, so serving results equal ad-hoc prediction; the
        engine passes its own ``buckets`` and fetches the classes.
        Returns float32 classes, batch-shaped."""
        Xt = dense_rows(X)
        if Xt.dim() == 1:  # batch-shaped: (d,) scores as (1,)
            Xt = Xt[None]
        self._check_width(int(Xt.shape[-1]))
        if self.has_intercept_column:
            Xt = append_bias(Xt)
        W = self.weights.reshape(self.num_classes - 1, Xt.shape[-1])
        margins = bucketed_matvec(
            Xt, W.T, 0.0, DEFAULT_BUCKETS if buckets is None else buckets)
        return pivot_class_traced(margins)


MultinomialLogisticRegressionModel.save = save_model
MultinomialLogisticRegressionModel.load = classmethod(load_model)


class LogisticRegressionWithLBFGS(GeneralizedLinearAlgorithm):
    """Logistic regression via L-BFGS, binary or multinomial (the
    reference's ``LogisticRegressionWithLBFGS``): ``set_num_classes(K)``
    switches to the multinomial gradient (pivot class 0, ``(K-1)*D``
    weights).  ``device=None`` trains on the card."""

    def __init__(
        self,
        num_corrections: int = 10,
        convergence_tol: float = 1e-6,
        max_num_iterations: int = 100,
        reg_param: float = 0.0,
        device=None,
    ):
        super().__init__()
        self.num_classes = 2
        self.optimizer = LBFGS(
            LogisticGradient(),
            SquaredL2Updater(),
            num_corrections=num_corrections,
            convergence_tol=convergence_tol,
            max_num_iterations=max_num_iterations,
            reg_param=reg_param,
            device=device,
        )

    def set_num_classes(self, k: int):
        if k < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = int(k)
        if k == 2:
            self.optimizer.set_gradient(LogisticGradient())
        else:
            self.optimizer.set_gradient(MultinomialLogisticGradient(k))
        return self

    def validators(self, X, y):
        _check_labels(y, self.num_classes)

    def _weight_dim(self) -> int:
        if self.num_classes == 2:
            return self.num_features
        return (self.num_classes - 1) * self.num_features

    def run(self, data, initial_weights=None, initial_intercept: float = 0.0):
        if not (self.num_classes > 2 and self.add_intercept):
            return super().run(data, initial_weights, initial_intercept)
        # The bias column gives each class its own intercept as its last
        # weight; the harness's scalar split does not apply.
        X, y = _as_arrays(data)
        if X.shape[0] == 0:
            raise ValueError("empty input")
        d = X.shape[1]
        scaler = None
        if self.use_feature_scaling:
            # the harness's scale -> train -> rescale pass, before the
            # bias column, so each class's intercept slot stays unscaled
            from tpu_sgd_torch.feature import StandardScaler

            scaler = StandardScaler(with_mean=False, with_std=True).fit(X)
            X = scaler.transform(X)
        X = append_bias_auto(X)
        K = self.num_classes
        if initial_weights is None:
            w0 = np.zeros((K - 1, d), np.float32)
            has_bias_slots = False
        else:
            # both layouts: (K-1)*d (bias slots added here) and
            # (K-1)*(d+1) (a trained intercept model's own weights, the
            # warm-start contract)
            w0 = np.asarray(
                initial_weights.cpu() if isinstance(initial_weights,
                                                    torch.Tensor)
                else initial_weights, np.float32)
            if w0.size == (K - 1) * (d + 1):
                w0 = w0.reshape(K - 1, d + 1)
                has_bias_slots = True
            elif w0.size == (K - 1) * d:
                w0 = w0.reshape(K - 1, d)
                has_bias_slots = False
            else:
                raise ValueError(
                    f"initial_weights has size {w0.size} but expected "
                    f"{(K - 1) * d} ((num_classes-1) * num_features) "
                    f"or {(K - 1) * (d + 1)} (with per-class bias "
                    "slots, e.g. a trained intercept model's weights)"
                )
        if scaler is not None:
            # user weights arrive in original space: feature slots move
            # into scaled space, bias slots are unscaled
            std = scaler.std.cpu().numpy()
            w0 = w0.copy()
            w0[:, :d] = w0[:, :d] * std[None, :]
        if not has_bias_slots:
            bias0 = np.full((K - 1, 1), float(initial_intercept), np.float32)
            w0 = np.concatenate([w0, bias0], axis=1)
        w0 = np.asarray(w0, np.float32).reshape(-1)
        if self.validate_data:
            self.validators(X, y)
        # the schedule contract holds on this branch too: zero-flag runs
        # plan, and set_schedule forces or raises, as in the harness
        self._auto_plan(X, y)
        weights = self.optimizer.optimize((X, y), w0)
        if scaler is not None:
            W = weights.reshape(K - 1, d + 1).clone()
            W[:, :d] = W[:, :d] * scaler.factor.to(W.device)[None, :]
            weights = W.reshape(-1)
        return MultinomialLogisticRegressionModel(
            weights, 0.0, self.num_classes, X.shape[1],
            has_intercept_column=True,
        )

    def create_model(self, weights, intercept):
        if self.num_classes > 2:
            return MultinomialLogisticRegressionModel(
                weights, intercept, self.num_classes, self.num_features
            )
        return LogisticRegressionModel(weights, intercept)

    @classmethod
    def train(cls, data, max_num_iterations: int = 100,
              reg_param: float = 0.0, initial_weights=None,
              intercept: bool = False, num_classes: int = 2, mesh=None,
              device=None):
        alg = cls(max_num_iterations=max_num_iterations, reg_param=reg_param,
                  device=device)
        alg.set_intercept(intercept)
        alg.set_num_classes(num_classes)
        if mesh is not None:
            alg.optimizer.set_mesh(mesh)
        return alg.run(data, initial_weights)
