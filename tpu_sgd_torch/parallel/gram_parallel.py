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

Streamed, from host rows on a mesh (the statistics half of config 4 at
beyond-card scale): the rule of ``optimize/streamed.py`` holds, ranks on
one host act as the JAX package's one process.  Every rank passes the
SAME whole host dataset (a file every rank maps, never a private copy)
and streams only its slice of rows to its card: host rows ``[r·n_local,
r·n_local + n_used)`` for the prefix stacks
(:func:`build_streamed_sharded_gram_stats`, ``n_local = n // k``, whole
blocks only, as the JAX package drops the remainder), and ``[r·n_local,
(r+1)·n_local)`` with the remainder to the last rank for the totals
(:func:`build_streamed_total_stats`, every row counted).  Each rank's
stack is bitwise the resident build of its slice (the streamed build's
own contract).  :func:`dp_virtual_gram_run_fn` runs the meshed loop over
the rank's virtual statistics, ``(grad, loss, count)`` combined in rank
order.  The totals combine the ranks' f64 carries: densely, one gather
and the rank-order sum, the same bits on every rank; or through the
JAX package's compressed merge (``wire_compress="topk:<frac>"``: one
``ErrorFeedback`` over the shards in shard order, f64 here, and its
residual flushed once), which every rank runs on the gathered carries,
so it too ends with the same bits everywhere.  The gather moves the
dense carries either way, and ``record_wire`` counts those bytes: there
is no compressed segment on this wire to count.  A mesh whose ranks lie
on more than one host raises (``parallel.mesh.require_single_host``).
The f64 carries and resume directories are the single-device build's:
a resume directory written by the JAX package (f32 carries) is refused.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    SUM_DTYPE,
    GramData,
    GramLeastSquaresGradient,
    _acc_totals,
    _float_dtype,
    _host_rows,
    _sum_carries,
    streamed_totals_chunking,
)
from tpu_sgd_torch.ops.updaters import Updater
from tpu_sgd_torch.parallel.mesh import (
    all_gather,
    as_data_mesh,
    barrier,
    collective_device,
    combine,
    rank_order_sum,
    require_single_host,
)


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


def _streamed_mesh(mesh, what: str):
    """``(mesh, k, rank)``: the 1-D data view of ``mesh`` (a real model
    axis raises), after the single-host check of the streamed builds."""
    mesh = as_data_mesh(mesh)
    require_single_host(mesh, what)
    return mesh, mesh.size, mesh.rank


def build_streamed_sharded_gram_stats(mesh, Xh, yh,
                                      block_rows: int = DEFAULT_BLOCK_ROWS,
                                      batch_rows=None, resume_dir=None,
                                      wire_dtype=None, prefetch_depth=2,
                                      pipeline=True, device=None):
    """This rank's VIRTUAL block-prefix statistics of its slice of the host
    rows, streamed chunk by chunk to its card (``device``; ``None``: the
    card): the beyond-card statistics build on a data mesh.  Every rank
    passes the same whole host dataset ``(Xh, yh)`` (see the module
    docstring); rank ``r`` streams rows ``[r·n_local, r·n_local +
    n_used)``, ``n_local = n // k`` and ``n_used`` its whole blocks of
    ``B = min(block_rows, n_local)`` rows (the ``n % k`` remainder and each
    slice's ``n_local % B`` tail are dropped, as in the JAX package).
    ``resume_dir``: each rank resumes from ``resume_dir/shard_<r>``.  The
    ingest knobs are ``GramLeastSquaresGradient.build_streamed``'s.

    Returns ``(data, B, n_used)``: ``data`` the rank's virtual
    ``GramData`` (logical shape ``(n_used, d)``), bitwise the resident
    ``build`` of its slice's whole blocks."""
    mesh, k, r = _streamed_mesh(mesh, "streamed statistics")
    dev = resolve_device(device)
    Xh, yh = _host_rows(Xh, yh)
    n, d = Xh.shape
    n_local = n // k
    if n_local < 1:
        raise ValueError(f"{n} rows cannot shard {k} ways")
    B = max(1, min(int(block_rows), n_local))
    nbf = n_local // B
    n_used = nbf * B
    data_dtype = _float_dtype(Xh.dtype)
    sd = GramLeastSquaresGradient._resolve_stats_dtype(data_dtype, None)
    chunk = (max(1, int(batch_rows) // B) if batch_rows else 64) * B
    s = r * n_local
    PG, Pb, Pyy = GramLeastSquaresGradient._streamed_prefix(
        Xh[s:s + n_used], yh[s:s + n_used], B, sd, chunk, dev,
        resume_dir=(None if resume_dir is None
                    else os.path.join(resume_dir, f"shard_{r}")),
        wire_dtype=wire_dtype, prefetch_depth=prefetch_depth,
        pipeline=pipeline)
    data = GramData(None, PG, Pb, Pyy, PG[-1], Pb[-1], Pyy[-1], B,
                    logical_shape=(n_used, d), logical_dtype=data_dtype)
    return data, B, n_used


def dp_virtual_gram_run_fn(updater: Updater, config: SGDConfig, mesh,
                           block_rows: int, n_local: int, d: int,
                           data_dtype_name: str):
    """The meshed loop over each rank's VIRTUAL statistics (no rows on any
    card): ``run(w0, yd, data) -> (weights, loss_history, n_recorded)``,
    ``data`` the rank's ``GramData`` from
    :func:`build_streamed_sharded_gram_stats` (logical shape ``(n_local,
    d)``, ``block_rows`` rows a block), ``yd`` its labels (shape only:
    the virtual windows never read them).  Windows are block-aligned from
    the prefix stacks and ``(grad, loss, count)`` combine in rank order:
    ``make_run``'s body with an unbound ``GramLeastSquaresGradient``."""
    from tpu_sgd_torch.optimize.gradient_descent import make_run

    run = make_run(GramLeastSquaresGradient(), updater, config,
                   as_data_mesh(mesh))

    def virtual_run(w0, yd, data):
        if (tuple(data.shape) != (int(n_local), int(d))
                or data.block_rows != int(block_rows)
                or str(data.dtype) != str(data_dtype_name)):
            raise ValueError(
                f"this run was built for ({n_local}, {d}) "
                f"{data_dtype_name} statistics in blocks of {block_rows}; "
                f"got {tuple(data.shape)} {data.dtype} in blocks of "
                f"{data.block_rows}")
        return run(w0, data, yd)

    return virtual_run


def _split_flat_totals(flat, *, d: int):
    """``(G, b, yy)`` of the flat ``[G.ravel(), b, yy]`` merge vector."""
    dd = d * d
    return flat[:dd].reshape(d, d), flat[dd:dd + d], flat[dd + d]


def build_streamed_total_stats(mesh, Xh, yh,
                               block_rows: int = DEFAULT_BLOCK_ROWS,
                               batch_rows=None, resume_dir=None,
                               wire_dtype=None, prefetch_depth=2,
                               pipeline=True, wire_compress=None,
                               device=None):
    """The EXACT total statistics ``(G, b, yy)`` of host rows on a data
    mesh, the same bits on every rank, as a virtual totals-only
    ``GramData``: the quasi-Newton and normal-equation beyond-card build.
    Every rank passes the same whole host dataset and streams its slice,
    rows ``[r·n_local, (r+1)·n_local)`` (the last rank takes the ``n %
    k`` remainder), into an f64 carry on its card (``device``; ``None``:
    the card); no row is dropped.  ``resume_dir``: rank ``r`` resumes
    from ``resume_dir/shard_<r>``, and rank 0 removes the directory once
    every rank is done.

    The merge: one gather of every rank's flat f64 ``[G, b, yy]`` carry,
    then the rank-order sum, or with ``wire_compress="topk:<frac>"`` the
    JAX package's compressed merge of the gathered carries (rank 0's
    dense, ranks 1..k-1 through one ``ErrorFeedback`` in rank order, its
    residual added once at the end; exact up to the reordering of the
    adds).  ``record_wire`` counts what the gather moves: each rank's
    dense f64 carry."""
    from tpu_sgd_torch.io.sparse_wire import (
        ErrorFeedback,
        parse_wire_compress,
    )
    from tpu_sgd_torch.obs.counters import record_wire

    mesh, k, r = _streamed_mesh(mesh, "streamed totals")
    frac = parse_wire_compress(wire_compress)
    dev = resolve_device(device)
    Xh, yh = _host_rows(Xh, yh)
    n, d = Xh.shape
    if n < k:
        raise ValueError(f"{n} rows cannot shard {k} ways")
    data_dtype = _float_dtype(Xh.dtype)
    sd = GramLeastSquaresGradient._resolve_stats_dtype(data_dtype, None)
    n_local = n // k
    B, chunk = streamed_totals_chunking(n_local, block_rows, batch_rows)
    s = r * n_local
    e = (r + 1) * n_local if r + 1 < k else n
    G, b, yy = GramLeastSquaresGradient._streamed_totals(
        Xh[s:e], yh[s:e], B, sd, chunk, device=dev,
        resume_dir=(None if resume_dir is None
                    else os.path.join(resume_dir, f"shard_{r}")),
        wire_dtype=wire_dtype, prefetch_depth=prefetch_depth,
        pipeline=pipeline, finalize=False, wide=True)
    if resume_dir is not None:
        # a later rank's failure must not make a finished rank re-stream:
        # the shards go only once every rank holds its carry
        barrier(mesh, dev)
        if r == 0:
            shutil.rmtree(resume_dir, ignore_errors=True)
    flat = torch.cat([G.reshape(-1), b.reshape(-1), yy.reshape(1)]).to(
        SUM_DTYPE)
    nbytes = flat.numel() * flat.element_size()
    got = all_gather(mesh, flat.to(collective_device(mesh)))
    record_wire("dense-f64", logical_nbytes=nbytes, physical_nbytes=nbytes)
    if frac is not None and k > 1:
        rows = got.cpu().numpy()
        acc = rows[0].copy()
        ef = ErrorFeedback(acc.shape[0], frac, dtype=np.float64)
        for row in rows[1:]:
            idx, vals = ef.compress(row, record=False)
            acc[idx] += vals  # unique indices: one add each
        acc += ef.residual()
        total = torch.from_numpy(acc).to(dev)
    else:
        total = rank_order_sum(got.unbind(0)).to(dev)
    G, b, yy = _split_flat_totals(total, d=d)
    return GramLeastSquaresGradient.totals_only_data(
        G.to(sd), b, yy, n, d, data_dtype)
