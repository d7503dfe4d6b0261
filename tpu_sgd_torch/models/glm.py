"""Generalized linear model harness: the port of ``tpu_sgd/models/glm.py``.

Owns what the reference's harness owns: input validation, feature-count
discovery, the intercept (a bias column appended LAST, as
``MLUtils.appendBias``, sparse for sparse features), calling
``optimizer.optimize``, splitting the
intercept back out, the opt-in feature-scaling pass, and ``create_model``.
Before the optimizer runs, the execution planner (``tpu_sgd_torch/plan.py``)
picks its schedule unless ``set_schedule("off")`` or a manual schedule
flag says otherwise (``GeneralizedLinearAlgorithm._auto_plan``).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.linalg import SparseVector
from tpu_sgd_torch.models.labeled_point import LabeledPoint, to_arrays
from tpu_sgd_torch.ops.bucketed import (bucketed_matvec, dense_rows,
                                        plain_margins)
from tpu_sgd_torch.ops.sparse import (
    append_bias_auto,
    csr_from_triple,
    is_sparse,
    row_matrix,
    to_csr,
)
from tpu_sgd_torch.optimize.optimizer import Optimizer

DatasetLike = Union[Tuple, Iterable[LabeledPoint]]


def _as_arrays(data: DatasetLike):
    """``(X, y)`` as given (tensors, sparse ones included, stay where they
    are, so a dataset already on the card is never copied), or the
    columnar form of a collection of LabeledPoints."""
    if isinstance(data, tuple) and len(data) == 2:
        X, y = data
        if not isinstance(X, torch.Tensor):
            X = np.asarray(X)
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y)
        return X, y
    return to_arrays(data)


def _single(X) -> bool:
    """Whether ``X`` is one feature vector (predict returns a scalar)."""
    return (isinstance(X, SparseVector)
            or (is_sparse(X) and X.dim() == 1) or np.ndim(X) == 1)


def _dense_batch(X):
    """A dense vector or batch as a 2-D tensor where it lies (a vector as
    one row), for the bucketed matvec."""
    Xt = dense_rows(X)
    return Xt[None] if Xt.dim() == 1 else Xt


def _host_numpy(t) -> np.ndarray:
    """Predictions as a host numpy array (a copy: the chunk's buffers are
    reused)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.asarray(t)


def _concat(outs) -> np.ndarray:
    return np.concatenate(outs) if outs else np.zeros((0,), np.float32)


def _csr_rows(X, start: int, stop: int):
    """Rows ``[start, stop)`` of a CSR tensor as a CSR tensor (views of
    its entries)."""
    crow = X.crow_indices()
    lo, hi = int(crow[start]), int(crow[stop])
    return torch.sparse_csr_tensor(
        crow[start:stop + 1] - crow[start], X.col_indices()[lo:hi],
        X.values()[lo:hi], size=(stop - start, X.shape[1]),
        check_invariants=False)


class GeneralizedLinearModel:
    """Weights + intercept + prediction rule (abstract ``predict_point``).
    ``weights`` is a ``(d,)`` float32 tensor; a numpy array moves to
    ``device`` (``None``: the card)."""

    #: the activation the bucketed scores carry (``"sigmoid"`` for the
    #: logistic family), so that ``predict`` and the serving engine score
    #: a dense batch through one and the same bucketed pass
    _activation = None

    def __init__(self, weights, intercept: float = 0.0, device=None):
        if isinstance(weights, torch.Tensor) and device is None:
            self.weights = weights.to(torch.float32)
        else:
            self.weights = as_tensor(weights, resolve_device(device),
                                     torch.float32)
        self.intercept = float(intercept)

    def _batch(self, X) -> torch.Tensor:
        """One vector or a batch, dense or sparse (a sparse tensor of any
        layout, or one ``SparseVector``), as a 2-D dense tensor or a CSR
        matrix on the weights' device."""
        if isinstance(X, SparseVector):
            X = csr_from_triple(
                (X.values, X.indices, np.asarray([0, X.indices.size])),
                X.size)
        X = as_tensor(X, self.weights.device)
        if is_sparse(X):
            return to_csr(row_matrix(X))
        return torch.atleast_2d(X)

    def _plain_route(self, X) -> bool:
        """Whether ``X`` takes the plain product rather than the bucketed
        pass: sparse input, and weights or an input that require grad
        (the JAX package sends tracers down its pure-jnp path; the
        bucketed pass runs under ``no_grad``).  ``ops/bucketed.py``
        decides the shape of every other batch."""
        return (isinstance(X, SparseVector) or is_sparse(X)
                or self.weights.requires_grad
                or (isinstance(X, torch.Tensor) and X.requires_grad))

    def predict_margin(self, X) -> torch.Tensor:
        """Raw margin(s) ``x.w + b`` on the weights' device, always
        batch-shaped (a single vector yields shape (1,)).  A dense batch
        goes through the bucketed matvec (``ops/bucketed.py``), as the
        serving engine's batches do; a sparse one, or one that needs
        autograd, takes the plain ``X @ w + b`` in f32 (the CSR kernel
        for a sparse X on the card)."""
        if self._plain_route(X):
            return plain_margins(self._batch(X), self.weights,
                                 self.intercept)
        return bucketed_matvec(_dense_batch(X), self.weights,
                               self.intercept)

    def predict_point(self, margin):
        raise NotImplementedError

    def _decide(self, scores):
        """Predictions from scores that already carry ``_activation``."""
        return self.predict_point(scores)

    def predict_streamed(self, X, batch_rows: int = 1_000_000
                         ) -> np.ndarray:
        """Chunked prediction for host-resident data beyond the card's
        memory: fixed ``batch_rows`` chunks (``io.plan_chunks``) are
        copied into a pinned ring on the prefetcher's worker and sent to
        the card on a side stream while the previous chunk is scored, and
        each chunk's predictions come back to host memory, so the card
        holds two chunks whatever ``len(X)``.  ``X``: a numpy array, a CPU
        tensor (bf16 included) or a CPU sparse tensor (CSR row slices,
        never densified).  Returns a numpy array."""
        from tpu_sgd_torch.io import (PinnedRing, Prefetcher, plan_chunks,
                                      ring_slots)
        from tpu_sgd_torch.io.wire import host_tensor

        if batch_rows <= 0:
            raise ValueError(f"batch_rows must be positive, got {batch_rows}")
        if _single(X):
            return np.asarray(self.predict(X))
        dev = self.weights.device
        if is_sparse(X):
            X = to_csr(X)
            return _concat([
                _host_numpy(self.predict(_csr_rows(X, c.start, c.stop)))
                for c in plan_chunks(X.shape[0], batch_rows)])
        Xh = host_tensor(X)
        if not Xh.is_contiguous():
            Xh = Xh.contiguous()
        plan = plan_chunks(Xh.shape[0], batch_rows)
        if plan.n_chunks == 0:
            return np.zeros((0,), np.float32)
        depth = 2
        slots = ring_slots(depth)
        ring = PinnedRing({"x": ((plan.chunk_rows,) + tuple(Xh.shape[1:]),
                                 Xh.dtype)}, slots, dev)

        def produce(chunk):
            slot = chunk.index % slots
            buf = ring.claim(slot)["x"][:chunk.valid]
            buf.copy_(Xh[chunk.start:chunk.stop])
            ring.send(slot, [(ring.dev[slot]["x"][:chunk.valid], buf)])
            return chunk, slot

        outs = []
        with Prefetcher(produce, plan, depth=depth) as feed:
            for chunk, slot in feed:
                rows = ring.take(slot)["x"][:chunk.valid]
                out = self.predict_point(self.predict_margin(rows))
                ring.release(slot)
                outs.append(_host_numpy(out))
        ring.drain()
        return _concat(outs)

    def predict(self, X):
        """Predict for one feature vector or a batch, dense or sparse, on
        the weights' device.  A dense batch is scored in one bucketed
        pass with the family's activation, the pass the serving engine
        runs, so the two agree bitwise."""
        if self._plain_route(X):
            out = self.predict_point(self.predict_margin(X))
        else:
            out = self._decide(bucketed_matvec(
                _dense_batch(X), self.weights, self.intercept,
                activation=self._activation))
        return out[0] if _single(X) else out

    def __repr__(self):
        return (
            f"{type(self).__name__}(numFeatures={self.weights.shape[-1]}, "
            f"intercept={self.intercept})"
        )


class GeneralizedLinearAlgorithm:
    """Shared training harness; subclasses provide optimizer + create_model."""

    #: subclasses set an Optimizer instance
    optimizer: Optimizer = None

    def __init__(self):
        self.add_intercept = False
        self.validate_data = True
        self.num_features = -1
        self.use_feature_scaling = False
        self.schedule = "auto"

    # -- fluent config, parity with the reference's setters ----------------
    def set_intercept(self, flag: bool):
        self.add_intercept = bool(flag)
        return self

    def set_validate_data(self, flag: bool):
        self.validate_data = bool(flag)
        return self

    def set_feature_scaling(self, flag: bool):
        """Scale features to unit column std before optimizing, then map
        the weights back to original space (the reference harness's
        ``useFeatureScaling`` pass), opt-in on every family as in the JAX
        package.  ``transform`` promotes a bf16 X to an f32 copy."""
        self.use_feature_scaling = bool(flag)
        return self

    def set_num_features(self, n: int):
        self.num_features = int(n)
        return self

    def set_schedule(self, mode: str):
        """Execution-schedule policy (``tpu_sgd_torch/plan.py``).
        ``"auto"`` (default): when no manual schedule flag is set on the
        optimizer, ``run`` probes (shape, dtype, gradient family,
        sampling, free device memory), picks a schedule and logs one
        ``plan: ...`` line on the ``tpu_sgd_torch.plan`` logger.  A
        schedule name (``resident_stock`` / ``resident_gram`` /
        ``partial_residency`` / ``host_streamed`` /
        ``streamed_virtual_gram``) forces it, with a warning when the
        estimate says it loses.  ``"off"``: never plan; the optimizer runs
        exactly as configured.  Manual optimizer flags
        (``set_host_streaming``, ``set_sufficient_stats``,
        ``set_streamed_stats``) always win over ``"auto"``."""
        from tpu_sgd_torch.plan import SCHEDULES

        valid = ("auto", "off")
        if mode not in valid + SCHEDULES:
            raise ValueError(
                f"schedule must be one of {valid + SCHEDULES}, got {mode!r}"
            )
        self.schedule = mode
        return self

    def _auto_plan(self, X, y) -> None:
        """Apply the planner per ``set_schedule``, on the exact matrix the
        optimizer will see (after scaling and the bias column)."""
        if self.schedule == "off":
            return
        opt = self.optimizer
        manual = bool(
            getattr(opt, "host_streaming", False)
            or getattr(opt, "sufficient_stats", False)
            or getattr(opt, "streamed_stats", False)
        )
        # flags a PREVIOUS plan set (last_plan is not None) are the
        # planner's own and must not block planning for a new dataset;
        # the manual setters clear last_plan, so user-set flags win
        if (self.schedule == "auto" and manual
                and getattr(opt, "last_plan", None) is None):
            return  # explicit optimizer flags win
        from tpu_sgd_torch.optimize.lbfgs import LBFGS
        from tpu_sgd_torch.plan import logger, plan_for, plan_quasi_newton

        force = None if self.schedule == "auto" else self.schedule
        # identically shaped repeat runs (the streaming model's
        # micro-batches) skip the probe, the plan and the log
        key = (tuple(X.shape), str(getattr(X, "dtype", "")),
               bool(getattr(X, "is_cuda", False)), force,
               getattr(opt, "config", None), getattr(opt, "mesh", None),
               getattr(opt, "max_num_iterations", None))
        if (getattr(opt, "last_plan", None) is not None
                and getattr(opt, "_plan_key", None) == key):
            return
        if isinstance(opt, LBFGS):
            p = plan_quasi_newton(opt, X, y, force=force)
            if p is not None:
                p.apply_quasi_newton(opt)
        else:
            p = plan_for(opt, X, y, force=force)
            if p is not None:
                p.apply(opt)
        if p is not None:
            opt._plan_key = key
            logger.info(p.describe())
        elif getattr(opt, "last_plan", None) is not None:
            # an input the planner leaves alone (sparse, GramData, a model
            # axis) after a planned run: the previous plan's flags and
            # knobs must not leak onto this dataset
            opt._clear_planned_schedule()
            opt.last_plan = None
            opt._plan_key = None
        if p is None and force is not None:
            raise ValueError(
                f"schedule={force!r} cannot be applied here: this "
                "optimizer/input is not planned (sparse/BCOO or GramData "
                "input, a 2-D data x model mesh, or an optimizer without "
                "schedules) — configure it directly with the optimizer "
                "setters instead"
            )

    # -- hooks -------------------------------------------------------------
    def create_model(self, weights, intercept) -> GeneralizedLinearModel:
        raise NotImplementedError

    def validators(self, X, y) -> None:
        """Input validation hook; classifier subclasses check label sets."""

    # -- training ----------------------------------------------------------
    def run(
        self,
        data: DatasetLike,
        initial_weights=None,
        initial_intercept: float = 0.0,
    ) -> GeneralizedLinearModel:
        X, y = _as_arrays(data)
        if X.shape[0] == 0:
            raise ValueError("empty input")
        if self.num_features < 0:
            self.num_features = X.shape[1]
        if self.validate_data:
            self.validators(X, y)
        if initial_weights is None:
            initial_weights = np.zeros((self._weight_dim(),), np.float32)
        w0 = torch.as_tensor(np.asarray(
            initial_weights.cpu() if isinstance(initial_weights, torch.Tensor)
            else initial_weights, np.float32))
        scaler = None
        if self.use_feature_scaling:
            # Fit BEFORE the bias column exists; initial weights arrive in
            # ORIGINAL space and move into scaled space by w * std, per
            # d-sized block of flat stacked (multinomial) weights.  On a
            # mesh the statistics are every rank's rows', and each rank
            # scales its own rows
            from tpu_sgd_torch.feature import StandardScaler

            scaler = StandardScaler(with_mean=False, with_std=True).fit(
                X, mesh=getattr(self.optimizer, "mesh", None))
            X = scaler.transform(X)
            std = scaler.std.cpu()
            w0 = (w0.reshape(-1, std.shape[0]) * std[None, :]).reshape(
                w0.shape)
        if self.add_intercept:
            Xb = append_bias_auto(X)
            w0 = torch.cat([w0, torch.tensor([initial_intercept],
                                             dtype=torch.float32)])
            self._auto_plan(Xb, y)
            weights = self.optimizer.optimize((Xb, y), w0)
            intercept = float(weights[-1])
            weights = weights[:-1]
        else:
            self._auto_plan(X, y)
            weights = self.optimizer.optimize((X, y), w0)
            intercept = 0.0
        if scaler is not None:
            # margin w'.(x * factor) == (w' * factor).x: transform maps the
            # trained weights back to original space, block-wise
            d = scaler.std.shape[0]
            weights = scaler.transform(weights.reshape(-1, d)).reshape(
                weights.shape)
        return self.create_model(weights, intercept)

    def _weight_dim(self) -> int:
        return self.num_features

    def run_warm(self, data: DatasetLike, model: Optional[GeneralizedLinearModel]):
        """Warm-started run (the streaming mode's building block): re-run
        seeded with the latest weights AND intercept."""
        if model is None:
            return self.run(data)
        return self.run(data, model.weights, model.intercept)



def save_model(model, path: str) -> None:
    """``model.save(path)``: the JAX package's directory format
    (``utils/persistence.py``)."""
    from tpu_sgd_torch.utils.persistence import save_glm_model

    save_glm_model(path, model)


def load_model(cls, path: str, device=None):
    """``Model.load(path, device=None)``: a model of ``cls`` with its
    weights on ``device`` (``None``: the card)."""
    from tpu_sgd_torch.utils.persistence import load_glm_model

    return load_glm_model(path, cls, device=device)
