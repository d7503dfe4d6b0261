"""Data-parallel SGD: the port of ``tpu_sgd/parallel/data_parallel.py``.

Each rank holds its own rows, the weights stay replicated, and every step
combines the ranks' ``(grad_sum, loss_sum, count)`` in rank order
(``parallel.mesh.combine_sums``) before the same update runs on every
rank: deterministic replication in place of the reference's
TorrentBroadcast, as in the JAX package.

Uneven row counts follow the JAX package's multi-host rule
(``_shard_dataset_multihost``): the ranks agree on the longest rank's
count by a gather, pad to it with zero rows, and carry a ``valid`` mask
folded into each sample; when every rank arrives equal there is no mask.
:func:`local_rows` cuts a global dataset as the JAX package's
single-process mesh does (``pad_to_multiple``, then contiguous row
blocks), so a run on the cut equals that mesh's run.

The step, superstep and run builders are the optimizer's own
(``optimize/gradient_descent.py``) bound to the mesh: the counterparts of
the JAX package's ``shard_map``-wrapped builders.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gradients import Gradient
from tpu_sgd_torch.ops.sparse import is_sparse, take_rows
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.parallel.mesh import Mesh, all_gather, as_data_mesh

Tensor = torch.Tensor


def pad_to_multiple(
    X: np.ndarray, y: np.ndarray, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zero-pad rows so ``n`` divides evenly; returns (X, y, valid mask)."""
    n = X.shape[0]
    rem = (-n) % n_shards
    valid = np.ones((n + rem,), dtype=bool)
    if rem:
        X = np.concatenate([X, np.zeros((rem,) + X.shape[1:], X.dtype)], axis=0)
        y = np.concatenate([y, np.zeros((rem,), y.dtype)], axis=0)
        valid[n:] = False
    return X, y, valid


def local_rows(X, y, rank: int, n_shards: int):
    """Rank ``rank``'s rows of a global ``(X, y)`` cut into ``n_shards``
    contiguous blocks of ``ceil(n / n_shards)`` rows: the JAX package's
    ``pad_to_multiple`` plus row sharding, without the padding (a rank
    reads only real rows; :func:`shard_dataset` pads them and masks the
    pad).  ``X`` may be a numpy array, a dense tensor or a sparse
    tensor."""
    n = X.shape[0]
    rows = -(-n // n_shards)
    lo = min(n, rank * rows)
    hi = min(n, lo + rows)
    if is_sparse(X):
        return take_rows(X, np.arange(lo, hi)), y[lo:hi]
    return X[lo:hi], y[lo:hi]


def agree(mesh: Mesh, values, device) -> np.ndarray:
    """Every rank's integer ``values``, a ``(ranks, len(values))`` host
    array, identical on every rank."""
    t = torch.tensor(list(values), dtype=torch.int64, device=device)
    return all_gather(mesh, t).cpu().numpy()


def shard_dataset(mesh: Mesh, X, y, device=None
                  ) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """This rank's local rows ``(X, y)`` placed on ``device`` (``None``:
    the card) and padded to the longest rank's count; returns ``(X, y,
    valid)``, ``valid`` None when every rank has the same count (the
    mask-free path), else the bool mask of the real rows.  Tensors
    already in place come back as they are."""
    mesh = as_data_mesh(mesh)
    dev = resolve_device(device)
    X, y = as_tensor(X, dev), as_tensor(y, dev)
    n = X.shape[0]
    counts = agree(mesh, [n], dev)[:, 0]
    target = int(counts.max())
    if int(counts.min()) == target:
        return X, y, None
    pad = target - n
    if pad:
        X = torch.cat([X, X.new_zeros((pad,) + tuple(X.shape[1:]))])
        y = torch.cat([y, y.new_zeros((pad,))])
    return X, y, torch.arange(target, device=dev) < n


def dp_step_fn(gradient: Gradient, updater: Updater, config: SGDConfig,
               mesh: Mesh):
    """One meshed SGD iteration: ``make_step`` with the mesh's combine,
    ``step(w, X, y, i, reg_val, valid, Xt)`` on the rank's local rows."""
    from tpu_sgd_torch.optimize.gradient_descent import make_step

    return make_step(gradient, updater, config, as_data_mesh(mesh))


def dp_shared_superstep_fn(gradient: Gradient, updater: Updater,
                           config: SGDConfig, k: int, mesh: Mesh):
    """``k`` meshed iterations over one shared batch, the observed
    driver's block: ``superstep(w, reg_val, i0, X, y, valid=None,
    Xt=None) -> (w, ys)`` with ``ys`` the host leaves ``(weights, loss,
    reg, count, ‖Δw‖, ‖w‖)`` of the ``k`` steps (the JAX package's
    ``pack_step_ys``)."""
    from tpu_sgd_torch.optimize.gradient_descent import (
        _make_block,
        _make_sampler,
        _RunState,
    )

    mesh = as_data_mesh(mesh)
    block = _make_block(gradient, updater, config, history=False, mesh=mesh)
    samplers = {}

    def superstep(w, reg_val, i0, X, y, valid=None, Xt=None):
        key = (X.shape[0], str(X.device))
        if key not in samplers:
            samplers[key] = _make_sampler(config, X, mesh.rank)
        sampler = samplers[key]
        st = _RunState(w, config.num_iterations, ys_rows=k)
        st.reset(w, reg_val, i0)
        if sampler is not None:
            sampler.seek(i0)
        block(st, (X, y, valid, Xt), sampler, k)
        return st.w.clone(), st.ys_leaves(st.ys.cpu().numpy())

    return superstep


def dp_compressed_step_fn(gradient: Gradient, updater: Updater,
                          config: SGDConfig, topk_frac: float, mesh: Mesh):
    """One meshed iteration over the COMPRESSED wire:
    ``make_compressed_step`` with the mesh, ``step(w, ef, X, y, i, reg_val,
    valid=None, Xt=None) -> (new_w, new_ef, loss, new_reg, count)`` on the
    rank's local rows; ``ef`` is this rank's ``(d,)`` accumulator (row
    ``rank`` of the JAX package's ``(n_shards, d)`` state)."""
    from tpu_sgd_torch.optimize.gradient_descent import make_compressed_step

    return make_compressed_step(gradient, updater, config, topk_frac,
                                as_data_mesh(mesh))


def _compressed_superstep(gradient, updater, config, topk_frac, k, mesh,
                          stacked: bool):
    """The compressed K-step block bound to the mesh (see the two
    builders below)."""
    from tpu_sgd_torch.optimize.gradient_descent import (
        _make_block,
        _make_sampler,
        _RunState,
    )

    mesh = as_data_mesh(mesh)
    block = _make_block(gradient, updater, config, history=False,
                        stacked=stacked, topk_frac=topk_frac, mesh=mesh)
    samplers = {}

    def superstep(w, ef, reg_val, i0, X, y, valid=None, Xt=None):
        steps = int(X.shape[0]) if stacked else int(k)
        sampler = None
        if not stacked:
            key = (X.shape[0], str(X.device))
            if key not in samplers:
                samplers[key] = _make_sampler(config, X, mesh.rank)
            sampler = samplers[key]
            if sampler is not None:
                sampler.seek(int(i0))
        st = _RunState(w, config.num_iterations, ys_rows=steps, extra=ef)
        st.reset(w, reg_val, int(i0), ef)
        block(st, (X, y, valid, Xt), sampler, steps)
        return st.w.clone(), st.extra.clone(), st.ys_leaves(
            st.ys.cpu().numpy())

    return superstep


def dp_compressed_superstep_fn(gradient: Gradient, updater: Updater,
                               config: SGDConfig, topk_frac: float,
                               mesh: Mesh):
    """K meshed compressed steps over PER-STEP batches, the host-streamed
    superchunk: ``superstep(w, ef, reg_val, i0, Xs, ys, valids) -> (w,
    ef, ys_leaves)`` with ``Xs`` the rank's ``(K, rows, d)`` share, the
    accumulator carried through the K steps, and ``ys_leaves`` the six
    host leaves of ``pack_step_ys`` plus a seventh, this rank's ``(K,
    d)`` post-update accumulators (the JAX package's leaf is every
    shard's, ``(K, n_shards, d)``: gather the rows where a checkpoint
    needs them)."""
    return _compressed_superstep(gradient, updater, config, topk_frac, 0,
                                 mesh, stacked=True)


def dp_compressed_shared_superstep_fn(gradient: Gradient, updater: Updater,
                                      config: SGDConfig, topk_frac: float,
                                      k: int, mesh: Mesh):
    """K meshed compressed steps over ONE shared batch (the rank's rows,
    sampled as :func:`dp_shared_superstep_fn` samples them):
    ``superstep(w, ef, reg_val, i0, X, y, valid=None, Xt=None) -> (w, ef,
    ys_leaves)``, the leaves as :func:`dp_compressed_superstep_fn`'s."""
    return _compressed_superstep(gradient, updater, config, topk_frac, k,
                                 mesh, stacked=False)


def dp_run_fn(gradient: Gradient, updater: Updater, config: SGDConfig,
              mesh: Mesh):
    """The whole meshed loop: ``make_run`` with the mesh's combine,
    ``run(w0, X, y, valid, Xt) -> (weights, loss_history, n_recorded)``
    on the rank's local rows."""
    from tpu_sgd_torch.optimize.gradient_descent import make_run

    return make_run(gradient, updater, config, as_data_mesh(mesh))


def dp_optimize(gradient: Gradient, updater: Updater, config: SGDConfig,
                mesh: Mesh, initial_weights, X, y, device=None):
    """Shard this rank's rows, run, return ``(weights, loss_history,
    n_recorded)``."""
    dev = resolve_device(device)
    Xd, yd, valid = shard_dataset(mesh, X, as_tensor(y, dev, torch.float32),
                                  dev)
    w0 = as_tensor(initial_weights, dev, torch.float32)
    return dp_run_fn(gradient, updater, config, mesh)(w0, Xd, yd, valid)
