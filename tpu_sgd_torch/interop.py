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

    # sufficient statistics built by the JAX package, as numpy
    d = jax_gram.data
    data = gram_data_from_numpy(
        np.asarray(d.PG), np.asarray(d.Pb), np.asarray(d.Pyy),
        np.asarray(d.G_tot), np.asarray(d.b_tot), np.asarray(d.yy_tot),
        d.block_rows, d.shape, str(d.dtype), X=np.asarray(d.X))

Models also cross in either direction through ``model.save(path)`` and
``Model.load(path)``, and statistics through ``GramData.save`` /
``GramData.load``: both packages write the same formats.
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


def gram_data_from_numpy(PG, Pb, Pyy, G_tot, b_tot, yy_tot,
                         block_rows: int, logical_shape, logical_dtype,
                         X=None, device=None):
    """A port ``GramData`` on ``device`` (``None``: the card) from the six
    statistics arrays of a JAX ``GramData``, its block rows, the logical
    shape and dtype (a name such as ``"bfloat16"``), and optionally the
    rows ``X`` (a tensor keeps its dtype; without X the bundle is
    virtual)."""
    from tpu_sgd_torch.device import as_tensor, resolve_device
    from tpu_sgd_torch.ops.gram import GramData

    dev = resolve_device(device)
    stats = [as_tensor(np.asarray(a), dev)
             for a in (PG, Pb, Pyy, G_tot, b_tot, yy_tot)]
    if X is not None:
        X = as_tensor(X, dev)
    return GramData(X, *stats, int(block_rows),
                    logical_shape=tuple(logical_shape),
                    logical_dtype=logical_dtype)


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
