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
