"""Streaming (online) SGD over micro-batches: the port of
``tpu_sgd/models/streaming.py``.

As in the reference, online learning re-runs the batch optimizer on each
micro-batch, warm-started from the latest weights and intercept: there is
no separate online code path.  A "DStream" is any iterable of ``(X, y)``
micro-batches, dense or sparse; ``train_on`` folds the model through it
(config 5).  Checkpointing and resume wait for the checkpoint plane
(ROADMAP A11).
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.models.classification import LogisticRegressionWithSGD
from tpu_sgd_torch.models.glm import (
    GeneralizedLinearAlgorithm,
    GeneralizedLinearModel,
)
from tpu_sgd_torch.models.regression import LinearRegressionWithSGD
from tpu_sgd_torch.ops.sparse import is_sparse

Batch = Tuple[np.ndarray, np.ndarray]


class StreamingLinearAlgorithm:
    """Fold a GLM through a stream of micro-batches with warm restarts.
    The model lives on the algorithm's optimizer's device."""

    def __init__(self, algorithm: GeneralizedLinearAlgorithm):
        self.algorithm = algorithm
        self.model: Optional[GeneralizedLinearModel] = None
        self._batch_count = 0
        self.loss_history: list = []
        self._model_update_listeners: list = []

    def latest_model(self) -> GeneralizedLinearModel:
        if self.model is None:
            raise RuntimeError(
                "Model must be initialized (set_initial_weights) or trained "
                "before use"
            )
        return self.model

    def set_initial_weights(self, weights, intercept: float = 0.0):
        """Start from ``weights`` (numpy, a list or a tensor) and
        ``intercept``: also how a model trained elsewhere, the JAX
        package's included, is carried in as numpy."""
        dev = resolve_device(self.algorithm.optimizer.device)
        w = as_tensor(weights, dev, torch.float32)
        self.model = self.algorithm.create_model(w, intercept)
        return self

    def set_checkpoint(self, manager_or_directory, every: int = 1,
                       history_tail: int = None):
        raise NotImplementedError(
            "streaming checkpoints need the checkpoint plane, not ported to "
            "tpu_sgd_torch yet (ROADMAP A11); use the JAX package tpu_sgd "
            "for it"
        )

    @classmethod
    def resume_from(cls, directory: str, every: int = 1, **init_kwargs):
        raise NotImplementedError(
            "streaming resume needs the checkpoint plane, not ported to "
            "tpu_sgd_torch yet (ROADMAP A11); use the JAX package tpu_sgd "
            "for it"
        )

    def add_model_update_listener(self, callback):
        """Register ``callback(model, batch_index)``, called after every
        micro-batch that updates the model.  A listener's exception
        propagates to the training loop."""
        if not callable(callback):
            raise TypeError(f"callback must be callable, got {callback!r}")
        self._model_update_listeners.append(callback)
        return self

    def remove_model_update_listener(self, callback):
        self._model_update_listeners.remove(callback)
        return self

    def on_model_update(self):
        """Call the registered listeners with the current model and stream
        position."""
        for cb in self._model_update_listeners:
            cb(self.model, self._batch_count)

    def train_on_batch(self, X, y) -> GeneralizedLinearModel:
        """One micro-batch update (the body of the reference's
        ``foreachRDD``), dense or sparse.  Every batch, an empty one
        included, advances the batch count (the stream position); an
        empty batch skips its update, as the reference skips empty
        RDDs."""
        if not is_sparse(X) and not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if X.shape[0] == 0:
            self._batch_count += 1
            return self.model
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        self.model = self.algorithm.run_warm((X, y), self.model)
        self._batch_count += 1
        hist = getattr(self.algorithm.optimizer, "loss_history", None)
        if hist is not None and len(hist):
            self.loss_history.append(float(hist[-1]))
        self.on_model_update()
        return self.model

    def train_on(self, stream: Iterable[Batch],
                 skip: Optional[int] = None) -> GeneralizedLinearModel:
        """Consume a whole stream (``trainOn(DStream)``), dropping the
        first ``skip`` micro-batches (default 0: without resume there is no
        consumed prefix to skip)."""
        skip = skip or 0
        for i, (X, y) in enumerate(stream):
            if i < skip:
                continue
            self.train_on_batch(X, y)
        return self.model

    def predict_on(self, stream: Iterable) -> Iterator[torch.Tensor]:
        """Lazily map prediction over a stream of feature batches, with the
        model current when each batch is consumed (``predictOn``)."""
        for X in stream:
            yield self.latest_model().predict(X)

    def predict_on_values(
        self, stream: Iterable[Tuple[object, object]]
    ) -> Iterator[Tuple[object, torch.Tensor]]:
        """Keyed variant (``predictOnValues``)."""
        for key, X in stream:
            yield key, self.latest_model().predict(X)


class StreamingLinearRegressionWithSGD(StreamingLinearAlgorithm):
    """``device=None`` trains on the card and raises without one."""

    def __init__(
        self,
        step_size: float = 0.1,
        num_iterations: int = 50,
        mini_batch_fraction: float = 1.0,
        reg_param: float = 0.0,
        device=None,
    ):
        resolve_device(device)
        super().__init__(
            LinearRegressionWithSGD(
                step_size, num_iterations, reg_param, mini_batch_fraction,
                device=device,
            )
        )


class StreamingLogisticRegressionWithSGD(StreamingLinearAlgorithm):
    """``device=None`` trains on the card and raises without one."""

    def __init__(
        self,
        step_size: float = 0.1,
        num_iterations: int = 50,
        mini_batch_fraction: float = 1.0,
        reg_param: float = 0.0,
        device=None,
    ):
        resolve_device(device)
        super().__init__(
            LogisticRegressionWithSGD(
                step_size, num_iterations, reg_param, mini_batch_fraction,
                device=device,
            )
        )
