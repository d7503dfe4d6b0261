"""Carry parameters from the JAX package into the port, as numpy and plain
values (this module imports nothing of ``tpu_sgd``).

    jax_model = tpu_sgd.LinearRegressionWithSGD.train(...)
    model = glm_model_from_numpy(LinearRegressionModel,
                                 np.asarray(jax_model.weights),
                                 jax_model.intercept)
    cfg = sgd_config_from_dict(dataclasses.asdict(jax_optimizer.config))
    # a streaming model: its latest weights and intercept, as numpy
    m = jax_stream.latest_model()
    stream = StreamingLinearRegressionWithSGD(...).set_initial_weights(
        np.asarray(m.weights), m.intercept)
    # a multinomial model: its flat weights and class layout
    model = multinomial_model_from_numpy(
        np.asarray(jax_model.weights), jax_model.num_classes,
        jax_model.has_intercept_column)

Models also cross in either direction through ``model.save(path)`` and
``Model.load(path)``: both packages write the same format.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_sgd_torch.config import SGDConfig


def glm_model_from_numpy(model_cls, weights: np.ndarray, intercept: float,
                         device=None):
    """A port model of ``model_cls`` with the given weights (copied to
    ``device``, ``None``: the card) and intercept."""
    return model_cls(np.asarray(weights, np.float32), float(intercept),
                     device=device)


def sgd_config_from_dict(values: dict) -> SGDConfig:
    """An ``SGDConfig`` from the JAX ``SGDConfig``'s fields (e.g.
    ``dataclasses.asdict``); an unknown field raises ``ValueError``."""
    names = {f.name for f in dataclasses.fields(SGDConfig)}
    unknown = sorted(set(values) - names)
    if unknown:
        raise ValueError(f"SGDConfig has no field(s) {unknown}")
    return SGDConfig(**values)


def multinomial_model_from_numpy(weights: np.ndarray, num_classes: int,
                                 has_intercept_column: bool = False,
                                 num_features: int = None, device=None):
    """A port ``MultinomialLogisticRegressionModel`` from a JAX one's flat
    ``(K-1)*D`` weights, class count and intercept-column flag."""
    from tpu_sgd_torch.models.classification import (
        MultinomialLogisticRegressionModel,
    )

    return MultinomialLogisticRegressionModel(
        np.asarray(weights, np.float32), 0.0, int(num_classes),
        num_features, bool(has_intercept_column), device=device)
