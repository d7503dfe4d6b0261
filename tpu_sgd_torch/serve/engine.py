"""Shape-bucketed batch prediction for serving: the port of
``tpu_sgd/serve/engine.py``.

Serving sees an endless stream of small, irregularly-sized batches.  Every
dense batch is padded on the host to a small fixed set of row-count
*buckets* and scored at the bucket's shape (``ops/bucketed.py``): one
host-to-device copy of the padded rows, the product and the family's
decision on the device, one device-to-host copy of the result
(:func:`fetch`) — that copy back is the request/response boundary, the
one deliberate sync of a batch.  Weights are data, so a hot model
reload (``serve/registry.py``) swaps weights without adding a shape.

Exactness contract: a library product may tile a batch differently at
each shape, so "same rows, different batch shape" is not bitwise-stable.
The engine therefore keeps no private predict implementation: the
bucketed matvec is the dense path that ``GeneralizedLinearModel.predict``
itself takes (with the family's activation in the same pass, and the
multinomial model's ``predict_dense_bucketed``), so the endpoint and an
ad-hoc ``model.predict`` on the same batch run the same ops at the same
shape and agree bitwise for dense input, on the CPU and on the card, at
the default buckets; a batch beyond the largest bucket runs on both sides
through the one plain product (``ops.bucketed.plain_margins``).

Sparse batches: :func:`stack_rows` coalesces 1-D sparse rows into one CSR
matrix with int32 indices (the port's sparse layout, ``ops/sparse.py``),
and the batch is scored through ``model.predict``'s sparse route: the
CSR kernel (``cuda_kernels.csr_margins``) on the card, its plain twin on
the CPU.  Sparse batches are NOT padded: the JAX package pads ``nse`` to a
power of two and rows to a bucket only to bound its compiled programs,
and the CSR kernel compiles nothing per shape.  A sparse answer matches
the model's own sparse predict to tight tolerance, not bitwise (the
kernel splits a row's additions by its place in the batch), and repeats
bitwise run to run.

The engine serves on one device (``device=None``: the card) and refuses a
model whose weights lie elsewhere: no path drops to the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tpu_sgd_torch.device import resolve_device
from tpu_sgd_torch.linalg import SparseVector
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.ops.bucketed import (DEFAULT_BUCKETS, bucket_for,
                                        bucketed_matvec, fetch,
                                        program_cache_size)
from tpu_sgd_torch.ops.sparse import csr_from_triple, is_sparse


def _sparse_row(x):
    """``(indices, values, width)`` of one 1-D sparse request row (a 1-D
    torch sparse tensor or a ``SparseVector``) as host numpy, or None when
    ``x`` is not a 1-D sparse row."""
    if isinstance(x, SparseVector):
        return x.indices, x.values, x.size
    if is_sparse(x) and x.dim() == 1:
        x = x.to_sparse_coo().coalesce()
        return (x.indices()[0].cpu().numpy(), x.values().cpu().numpy(),
                int(x.shape[0]))
    return None


def _is_sparse_request(x) -> bool:
    return isinstance(x, SparseVector) or is_sparse(x)


def stack_rows(rows):
    """Stack single-row feature vectors (dense 1-D arrays, or 1-D sparse
    vectors: torch sparse tensors or ``SparseVector``s) into one batch
    matrix — the coalescing step of the micro-batcher.  All rows must
    share layout and width.  Dense rows give a host numpy matrix, sparse
    rows a host CSR tensor."""
    if not rows:
        raise ValueError("cannot stack an empty request list")
    if _is_sparse_request(rows[0]):
        first = _sparse_row(rows[0])
        d = -1 if first is None else first[2]
        cols, vals = [], []
        indptr = np.zeros(len(rows) + 1, np.int64)
        for r, x in enumerate(rows):
            parts = _sparse_row(x)
            if parts is None or parts[2] != d:
                raise ValueError(
                    "mixed or mis-shaped sparse rows in one batch")
            cols.append(np.asarray(parts[0], np.int64).reshape(-1))
            vals.append(np.asarray(parts[1]).reshape(-1))
            indptr[r + 1] = indptr[r] + cols[-1].size
        # host-side assembly: requests are concrete, and the batch
        # crosses to the device in the engine
        return csr_from_triple((np.concatenate(vals), np.concatenate(cols),
                                indptr), d, dtype=None)
    arrs = [np.asarray(x) for x in rows]
    d = arrs[0].shape[-1]
    for a in arrs:
        if a.ndim != 1 or a.shape[-1] != d:
            raise ValueError("mixed or mis-shaped dense rows in one batch")
    # promote, never truncate: one int-typed request must not silently
    # floor a float neighbor coalesced into the same batch (float32 floor
    # so integer rows score like everywhere else in the stack)
    out = np.empty((len(arrs), d), np.result_type(np.float32, *arrs))
    for i, a in enumerate(arrs):
        out[i] = a
    return out


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class PredictEngine:
    """Bucket-padded predict for every GLM family.

    Dense batches route through the models' own bucketed path
    (:func:`~tpu_sgd_torch.ops.bucketed.bucketed_matvec` — shared shape
    keys, bitwise-identical results); sparse batches through the model's
    CSR route.  The engine adds oversized-batch handling and the call /
    shape counters the serving metrics read.  It is stateless with
    respect to the model, so the registry can swap models freely.
    """

    def __init__(self, buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 device=None):
        bs = sorted({int(b) for b in buckets})
        if not bs or bs[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = tuple(bs)
        self.max_batch = self.buckets[-1]
        self.device = resolve_device(device)
        self.call_count = 0

    def bucket_for(self, n: int) -> int:
        return bucket_for(n, self.buckets)

    @property
    def compile_count(self) -> int:
        """Distinct padded dense shapes scored in this process (the JAX
        package's compiled-program count; sparse batches add none)."""
        return program_cache_size()

    def check_model(self, model) -> None:
        """Raise unless ``model``'s weights lie on the engine's device."""
        dev = model.weights.device
        if not _same_device(dev, self.device):
            raise ValueError(
                f"the model's weights are on {dev}, and this engine serves "
                f"on {self.device}; build the model (or the registry) on "
                "the engine's device")

    # -- public entry ------------------------------------------------------
    def predict_batch(self, model, X) -> np.ndarray:
        """Score a batch; returns a host numpy array of per-row
        predictions, identical to ``model.predict(X)`` (bitwise for dense
        inputs at the default buckets; a custom bucket set pads to other
        shapes, which a library product may tile at 1-ulp variance)."""
        self.call_count += 1
        self.check_model(model)
        # nests under the batcher's serve.batch span on the flush thread
        sp = span("serve.predict")
        with sp:
            if not _is_sparse_request(X):
                if not isinstance(X, torch.Tensor):
                    X = np.asarray(X)
                if X.ndim == 1:
                    X = X[None]
                sp.set(rows=int(X.shape[0]))
                if X.shape[0] == 0:
                    return np.zeros((0,), np.float32)
                return self._score_dense(model, X)
            if isinstance(X, SparseVector) or X.dim() == 1:
                X = stack_rows([X])  # one sparse vector: a (1, d) batch
            sp.set(rows=int(X.shape[0]), sparse=True)
            return self._score_sparse(model, X)

    def _score_dense(self, model, X) -> np.ndarray:
        """Family dispatch over the shared bucketed matvec, honoring THIS
        engine's bucket set; with the default buckets every op is the one
        ``model.predict`` runs, which makes the results bitwise-equal.
        The scores stay on the device until :func:`fetch`."""
        if hasattr(model, "predict_dense_bucketed"):
            # one shared implementation of the multinomial decision path —
            # the model owns it, the engine only supplies its buckets
            return fetch(model.predict_dense_bucketed(X, self.buckets))
        return fetch(model._decide(bucketed_matvec(
            X, model.weights, model.intercept, self.buckets,
            activation=model._activation)))

    @staticmethod
    def _score_sparse(model, X) -> np.ndarray:
        """The model's own sparse route (the CSR kernel on the card), one
        copy of the batch's three arrays in and of the result out."""
        if X.shape[0] == 0:
            return np.zeros((0,), np.float32)
        with torch.no_grad():
            return fetch(model.predict(X))
