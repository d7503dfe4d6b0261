"""2-D ``(data, model)`` sharded SGD: the port of
``tpu_sgd/parallel/model_parallel.py``.

X is sharded over rows and features: each rank holds the rows of its data
block and the columns of its model block, and w is sharded over features.
Each step the rank's partial margins ``X_block @ w_block`` are combined
over the model axis, the sums over the data axis, and the updater runs on
the rank's block with its reg value combined over the model axis (as are
the convergence norms).  Every combine is the rank-order one of
``parallel/mesh.py``.  The model ranks of one data row hold the same rows
and draw the same sample: the sample stream's shard is the data index.

The sums cannot run in the fused kernels, whose one pass over X serves
both matvecs: the margins' combine sits between them.  They take the JAX
package's base path, two library products around the combine
(``ops.gradients.margin_combined_sums``), chosen by the mesh's shape
alone.

:func:`dp_mp_run_fn` runs on a rank's block; :func:`dp_mp_optimize` takes
a rank's rows with every feature (as a data mesh does), cuts its block
and gathers the trained blocks back into the whole vector on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gradients import Gradient
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.parallel.mesh import DATA_AXIS, Mesh, gather_model

Tensor = torch.Tensor


def pad_features_to_multiple(X, w0, n_shards: int):
    """Zero-pad the feature axis to a multiple of ``n_shards``; zero
    columns stay exactly zero through all three updaters (their gradient
    is 0 and every update maps 0 to 0), so the padding is invisible in the
    result.  Numpy arrays or tensors; returns ``(X, w0, orig_dim)``."""
    d = X.shape[1]
    rem = (-d) % n_shards
    if rem:
        if isinstance(X, Tensor):
            X = torch.cat([X, X.new_zeros((X.shape[0], rem))], dim=1)
            w0 = torch.cat([w0, w0.new_zeros((rem,))])
        else:
            X = np.concatenate([X, np.zeros((X.shape[0], rem), X.dtype)],
                               axis=1)
            w0 = np.concatenate([w0, np.zeros((rem,), w0.dtype)])
    return X, w0, d


def feature_block(mesh: Mesh, X, w0):
    """This rank's model block of ``(X, w0)``: the features zero-padded to
    a multiple of ``n_model``, then columns ``[m·b, (m+1)·b)`` for model
    index ``m`` and block width ``b``, X's block contiguous.  Returns
    ``(X_block, w0_block, orig_dim)``."""
    X, w0, d = pad_features_to_multiple(X, w0, mesh.n_model)
    b = X.shape[1] // mesh.n_model
    lo = mesh.model_index * b
    return X[:, lo:lo + b].contiguous(), w0[lo:lo + b].clone(), d


def dp_mp_run_fn(gradient: Gradient, updater: Updater, config: SGDConfig,
                 mesh: Mesh):
    """The meshed loop on a 2-D mesh: ``run(w_block, X_block, y, valid)
    -> (w_block, loss_history, n_recorded)`` on this rank's block
    (``make_run`` with both combines), the trained block coming back."""
    from tpu_sgd_torch.optimize.gradient_descent import make_run

    return make_run(gradient, updater, config, mesh)


def dp_mp_optimize(gradient: Gradient, updater: Updater, config: SGDConfig,
                   mesh: Mesh, initial_weights, X, y, device=None,
                   run_for=None):
    """Shard this rank's rows (padded to the longest data rank's, as
    ``parallel.shard_dataset`` pads them), cut its feature block, run,
    and return ``(weights[:orig_dim], loss_history, n_recorded)`` with the
    whole weight vector, gathered over the model axis, on every rank.
    ``run_for(X_block)`` supplies the run (default: a new
    :func:`dp_mp_run_fn`)."""
    from tpu_sgd_torch.parallel.data_parallel import shard_dataset

    dev = resolve_device(device)
    rows = Mesh({DATA_AXIS: mesh.size}, mesh.group)
    Xs, ys, valid = shard_dataset(rows, X, as_tensor(y, dev, torch.float32),
                                  dev)
    w0 = as_tensor(initial_weights, dev, torch.float32)
    if Xs.shape[0] == 0:
        return w0, torch.zeros((0,)), torch.zeros((1,), dtype=torch.int64)
    Xb, wb, d = feature_block(mesh, Xs, w0)
    run = (run_for(Xb) if run_for is not None
           else dp_mp_run_fn(gradient, updater, config, mesh))
    wb, losses, n_rec = run(wb, Xb, ys, valid)
    return gather_model(mesh, wb).reshape(-1)[:d], losses, n_rec
