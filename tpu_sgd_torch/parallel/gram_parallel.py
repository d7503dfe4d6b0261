"""Sufficient statistics on a data mesh, resident half: the port of
``tpu_sgd/parallel/gram_parallel.py``.

Each rank builds the block-prefix statistics of its OWN rows (the same
one-pass build as one device, ``GramLeastSquaresGradient.build``), and
the unchanged meshed run then computes each rank's window sums from them
and combines ``(grad_sum, loss_sum, count)`` in rank order, as the stock
meshed run does.  The sample streams are the stock meshed ones (a window
start per shard), so the run follows the stock meshed sliced run the way
one device's statistics run follows its stock run.  This is what makes
the statistics schedule available in config 4's 8-way data-parallel
frame.

Restriction, as in the JAX package: every rank must hold the same row
count.  A window from statistics is normalized by its full length, a
padded rank's stock window by its realized valid count, so padded ranks
(a ``valid`` mask) take the stock meshed path (``GradientDescent`` does
that by itself).

The quasi-Newton optimizers read only totals (the full-batch sums and the
line-search sweep, never windows): :func:`build_sharded_total_stats`
accumulates each rank's ``(XᵀX, Xᵀy, yᵀy)`` over its rows with an f64
carry, and one rank-order combine of the flattened f64 totals gives every
rank the same bits; the loop then runs unmeshed from them.

The streamed builds on a mesh (``build_streamed_sharded_gram_stats``,
``dp_virtual_gram_run_fn``, ``build_streamed_total_stats``) are the next
slice (ROADMAP A5) and raise.
"""

from __future__ import annotations

import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    GramLeastSquaresGradient,
    _acc_totals,
    _sum_carries,
)
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.parallel.mesh import as_data_mesh, combine


def build_sharded_gram_stats(mesh, Xd, yd,
                             block_rows: int = DEFAULT_BLOCK_ROWS,
                             aligned: bool = False):
    """This rank's block-prefix statistics of its rows ``(Xd, yd)`` (from
    ``shard_dataset`` with no padding), on their device: a bound
    ``GramLeastSquaresGradient`` whose ``.data`` rides where X goes in
    :func:`dp_gram_run_fn`'s run.  The stats dtype is the one device's
    (the wider of f32 and the data dtype; f64 carries).  ``aligned``
    floors window starts to block boundaries, as ``set_gram_options``
    says."""
    as_data_mesh(mesh)  # a real model axis raises
    return GramLeastSquaresGradient.build(Xd, yd, block_rows=block_rows,
                                          aligned=aligned, device=Xd.device)


def dp_gram_run_fn(updater: Updater, config: SGDConfig, mesh,
                   aligned: bool = False):
    """The meshed loop over per-rank statistics: ``run(w0, gram_data, y)
    -> (weights, loss_history, n_recorded)``, ``make_run``'s body with an
    unbound ``GramLeastSquaresGradient`` (least squares) and the data
    mesh's combine."""
    from tpu_sgd_torch.optimize.gradient_descent import make_run

    return make_run(GramLeastSquaresGradient(aligned=aligned), updater,
                    config, as_data_mesh(mesh))


def build_sharded_total_stats(mesh, Xd, yd,
                              block_rows: int = DEFAULT_BLOCK_ROWS):
    """The EXACT total statistics ``(G, b, yy)`` of every rank's rows,
    the same bits on every rank, as a virtual totals-only ``GramData``:
    the quasi-Newton meshed sufficient-statistics substitution.  Each rank
    passes its own rows, on the device it runs on; the ranks agree on the
    block size (the JAX package's, from the longest rank's row count) and
    on the total row count, accumulate their rows' statistics in
    ``block_rows`` blocks with an f64 carry, and combine the flattened f64
    totals in rank order.  Padded rows add nothing, so no rank pads."""
    from tpu_sgd_torch.parallel.data_parallel import agree

    mesh = as_data_mesh(mesh)
    X = torch.as_tensor(Xd) if not isinstance(Xd, torch.Tensor) else Xd
    if not X.dtype.is_floating_point:
        X = X.to(torch.float32)
    dev = X.device
    y = as_tensor(yd, dev)
    if not y.dtype.is_floating_point:
        y = y.to(torch.float32)
    n, d = X.shape
    counts = agree(mesh, [n], dev)[:, 0]
    B = max(1, min(int(block_rows), int(counts.max())))
    G, b, yy = combine(mesh, *_acc_totals(_sum_carries(d, dev), X, y, B))
    sd = GramLeastSquaresGradient._resolve_stats_dtype(X.dtype, None)
    return GramLeastSquaresGradient.totals_only_data(
        G.to(sd), b, yy, int(counts.sum()), d, X.dtype)


def _streamed_half(what: str):
    raise NotImplementedError(
        f"{what} is not ported to tpu_sgd_torch yet (ROADMAP A5, the "
        "streamed half of the meshed statistics); use the JAX package "
        "tpu_sgd for it")


def build_streamed_sharded_gram_stats(mesh, Xh, yh, *args, **kwargs):
    """Per-rank virtual statistics streamed from host rows: not ported
    yet (ROADMAP A5)."""
    _streamed_half("build_streamed_sharded_gram_stats")


def dp_virtual_gram_run_fn(*args, **kwargs):
    """The meshed loop over streamed virtual statistics: not ported yet
    (ROADMAP A5)."""
    _streamed_half("dp_virtual_gram_run_fn")


def build_streamed_total_stats(mesh, Xh, yh, *args, **kwargs):
    """Meshed totals streamed from host rows: not ported yet (ROADMAP
    A5)."""
    _streamed_half("build_streamed_total_stats")
