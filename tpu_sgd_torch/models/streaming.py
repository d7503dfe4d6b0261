"""Streaming (online) SGD over micro-batches: the port of
``tpu_sgd/models/streaming.py``.

As in the reference, online learning re-runs the batch optimizer on each
micro-batch, warm-started from the latest weights and intercept: there is
no separate online code path.  A "DStream" is any iterable of ``(X, y)``
micro-batches, dense or sparse; ``train_on`` folds the model through it
(config 5).

Driver recovery: ``set_checkpoint`` persists the latest model and the
stream position every K micro-batches through the shared
``CheckpointManager`` (the JAX package's format; the intercept rides the
npz ``x_`` extras), and ``resume_from`` rebuilds the algorithm mid-stream
from the newest checkpoint; with a replayable stream the resumed run
reproduces the uninterrupted run's weights and loss history exactly,
because each micro-batch update is deterministic in ``(warm-start
weights, batch)``.
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
        self.checkpoint_manager = None
        self.checkpoint_every = 1
        self.checkpoint_history_tail = None
        self._resume_skip = 0
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
        """Persist (latest model, batch index, cumulative loss history)
        every ``every`` micro-batches: kill the driver mid-stream and
        :meth:`resume_from` restarts from the newest checkpoint.  Accepts
        a ``CheckpointManager`` or a directory path.

        ``history_tail`` bounds the persisted loss history to its last N
        entries.  The default (None, full history) keeps resume BITWISE
        identical to the uninterrupted run, but re-serializes the whole
        history every checkpoint (O(N²) cumulative I/O over a long
        stream); an unbounded stream with frequent checkpoints should set
        a tail (the resumed run's history then starts at the tail,
        weights still exact)."""
        import os

        from tpu_sgd_torch.utils.checkpoint import CheckpointManager

        if isinstance(manager_or_directory, (str, os.PathLike)):
            manager_or_directory = CheckpointManager(
                str(manager_or_directory))
        self.checkpoint_manager = manager_or_directory
        self.checkpoint_every = max(1, int(every))
        if history_tail is not None and int(history_tail) < 1:
            raise ValueError(
                f"history_tail must be positive, got {history_tail}"
            )
        self.checkpoint_history_tail = (
            None if history_tail is None else int(history_tail))
        return self

    @classmethod
    def resume_from(cls, directory: str, every: int = 1, **init_kwargs):
        """Rebuild a streaming algorithm mid-stream from the newest
        checkpoint in ``directory`` (written by :meth:`set_checkpoint`, by
        this package or the JAX package): latest model, batch index and
        loss history are restored, and checkpointing continues into the
        same directory.  Construct with the SAME hyper-parameters as the
        interrupted run (``init_kwargs``, ``device`` included): they are
        not stored in the checkpoint.

        With a stream replayed from the beginning, the next
        :meth:`train_on` skips the already-consumed micro-batches and the
        run reproduces the uninterrupted weights and history exactly; a
        LIVE stream that only yields new batches should be consumed with
        ``train_on(stream, skip=0)``."""
        import warnings

        from tpu_sgd_torch.utils.checkpoint import CheckpointManager

        self = cls(**init_kwargs)
        manager = CheckpointManager(directory)
        ck = manager.restore()
        if ck is None:
            raise FileNotFoundError(
                f"no checkpoint to resume from in {directory!r}"
            )
        if "intercept" not in ck["extras"]:
            raise ValueError(
                f"{directory!r} holds a non-streaming checkpoint "
                f"(config_key={ck['config_key']!r}); streaming resume "
                "needs one written by set_checkpoint"
            )
        expect_key = f"stream:{type(self.algorithm).__name__}"
        if ck["config_key"] != expect_key:
            warnings.warn(
                f"resuming a checkpoint written by {ck['config_key']!r} "
                f"with {expect_key!r} — construct the same streaming "
                "family/hyper-parameters as the interrupted run",
                RuntimeWarning,
                stacklevel=2,
            )
        self.set_checkpoint(manager, every=every)
        self.set_initial_weights(ck["weights"],
                                 float(ck["extras"]["intercept"]))
        self._batch_count = int(ck["iteration"])
        self.loss_history = [float(v) for v in ck["loss_history"]]
        self._resume_skip = self._batch_count
        return self

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

    def _maybe_checkpoint(self):
        if (self.checkpoint_manager is not None
                and self.model is not None
                and self._batch_count % self.checkpoint_every == 0):
            m = self.model
            self.checkpoint_manager.save(
                self._batch_count,  # = batches consumed (stream position)
                m.weights.detach().cpu().numpy(),
                0.0,
                np.asarray(
                    self.loss_history if self.checkpoint_history_tail
                    is None
                    else self.loss_history[-self.checkpoint_history_tail:],
                    np.float64,
                ),
                config_key=f"stream:{type(self.algorithm).__name__}",
                extras={
                    "intercept": np.asarray(float(m.intercept), np.float64),
                },
            )

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
            self._maybe_checkpoint()
            return self.model
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        self.model = self.algorithm.run_warm((X, y), self.model)
        self._batch_count += 1
        hist = getattr(self.algorithm.optimizer, "loss_history", None)
        if hist is not None and len(hist):
            self.loss_history.append(float(hist[-1]))
        self._maybe_checkpoint()
        self.on_model_update()
        return self.model

    def train_on(self, stream: Iterable[Batch],
                 skip: Optional[int] = None) -> GeneralizedLinearModel:
        """Consume a whole stream (``trainOn(DStream)``), dropping the
        first ``skip`` micro-batches: by default the number already
        consumed when this instance was rebuilt by :meth:`resume_from`
        (so a stream replayed from the beginning continues where the
        interrupted run stopped), else 0; pass ``0`` for a live stream
        that only yields new batches.  The resume skip is consumed by the
        first ``train_on`` call."""
        if skip is None:
            skip = self._resume_skip
        self._resume_skip = 0
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
