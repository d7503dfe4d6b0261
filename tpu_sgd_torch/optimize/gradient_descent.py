"""Mini-batch gradient descent: the port of ``tpu_sgd/optimize/gradient_descent.py``
(dense and sparse, data resident on the device; one device, or one rank
of a data mesh, ``set_mesh``).

Per iteration, as in the reference's ``runMiniBatchSGD``:

    sample (Bernoulli mask / indexed gather / sliced window)
    -> fused (grad_sum, loss_sum, count)        one CUDA kernel launch
    -> grad /= count -> updater.compute -> convergence check

The JAX package runs the loop as one ``lax.while_loop``.  Here the loop
runs in *blocks* of K iterations from state kept on the device: the
weights, the reg value, the iteration counter (the updater's step
``η/√t`` is computed from it on the device), the convergence flag, the
record count and the loss history.  A block is a Python loop over device
tensors; on a CUDA device the first full block of a run runs eagerly as
the warm-up, the block is then captured once as a CUDA graph, and every
later full block replays it, so K iterations cost one host call.  The
unobserved run captures only where that repays itself: when the card
waited on the host in the warm-up block and ``CAPTURE_MIN_REPLAYS``
replays are ahead, or when the run repeats one on the same tensors; else
its blocks stay eager.  A block shorter than K (a run's tail) runs
eagerly.  The graph, its state buffers and the sample stream are cached
by the identity of the run's tensors (held weakly between runs), so a
second run on the same tensors replays at once.  Once the device flag
says the run converged, the rest of the block is masked to no-ops, so the
weights and the history freeze at the true iteration; the host reads the
flag once a block, and only when ``convergence_tol > 0``.  One read of the
record count and the history ends the run.  The captured replay runs the
kernels of the eager block in the same order: the two are bitwise equal
(``CUDA_GRAPHS = False`` runs every block eagerly, for that comparison).

Listeners, checkpoints and stop signals take the *observed* driver
(:meth:`GradientDescent._optimize_stepwise`, the JAX package's
``_optimize_stepwise``): one eager step and its host bookkeeping an
iteration (``observed_loop_tail``), or with ``set_superstep(K)`` the same
block writing each step's ``(w, loss, reg, count, ‖Δw‖, ‖w‖)`` into K
device rows, fetched once a block and replayed on the host through
``_replay_fused_steps``, or with ``set_residency(C)`` windows of C blocks
(``optimize/resident_driver.py``).  The three give the same history,
events and checkpoints, bitwise.

Least squares on dense data can run from block-prefix Gram statistics
(``set_sufficient_stats``, ``ops/gram.py``): the gradient is rebound to a
``GramLeastSquaresGradient`` and its ``GramData`` bundle rides where X
goes, so each sliced window or full batch costs a ``(d, d)`` matvec
instead of a pass over the rows.  ``set_gram_options(chunk_iters=K)``
sends block-aligned windows through the chunked-gather driver
(``optimize/gram_driver.py``).  ``set_streamed_stats`` builds those
statistics from host rows in one streamed pass
(``GramLeastSquaresGradient.build_streamed``) and runs on them, aligned.

Sparse features (any non-strided layout) train undensified, as the JAX
package's BCOO branch does on one device: X becomes CSR with int32
indices where they fit, the run builds its transposed CSR once, and each
iteration's two products are CSR x vector (``ops/sparse.py``), captured
like the dense path.  Only Bernoulli sampling (or full batch) applies to
them.

Data parallelism (``set_mesh``, ``parallel/``): each rank runs this same
loop on its own rows and draws its own shard's sample; after the local
sums the ranks combine ``(grad_sum, loss_sum, count)`` in rank order
(``parallel.mesh.combine_sums``), so the update, the history and the
convergence test run alike on every rank and the weights stay
replicated.  Under NCCL the gather is captured in the block's CUDA graph
like the kernels; under gloo it goes through the host, and the blocks
stay eager.  Least squares runs from each rank's own prefix statistics
where ``set_sufficient_stats`` applies (``parallel/gram_parallel.py``).
On a 2-D ``(data, model)`` mesh each rank trains its block of the
features (``parallel/model_parallel.py``): the partial margins, the reg
value and the convergence norms combine over the model axis, the sums
over the data axis.

Sampling: iteration ``i``'s sample is a function of ``(seed, i)`` alone —
the contract of the JAX package's ``fold_in(key, i)``, with other bits:
the two packages draw different samples from the same seed (see
:class:`_Sampler`).  Contract kept: ``loss[t] = loss_sum/count +
reg_val(previous weights)``, an empty sample skips the update,
convergence is tested from the second iteration on, and the initial
``reg_val`` comes from a zero-gradient probe update.
"""

from __future__ import annotations

import time
import warnings
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.obs.spans import span
from tpu_sgd_torch.obs.timeseries import observe_scalar
from tpu_sgd_torch.ops import cuda_kernels as ck
from tpu_sgd_torch.ops.gradients import Gradient, LeastSquaresGradient
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    GramData,
    GramLeastSquaresGradient,
)
from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr
from tpu_sgd_torch.ops.updaters import SimpleUpdater, Updater
from tpu_sgd_torch.optimize.optimizer import Dataset, Optimizer
from tpu_sgd_torch.parallel.mesh import (
    Mesh,
    any_rank,
    as_data_mesh,
    barrier,
    combine_model,
    combine_sums,
    has_model_axis,
    require_single_host,
)

Tensor = torch.Tensor

#: iterations in a block of the unobserved run (``make_run``), one CUDA
#: graph replay each.  A run's tail of ``N mod K`` iterations runs
#: eagerly at the host's pace, and its first block is the eager warm-up,
#: so K divides the usual iteration counts (20, 50, 100) and stays small;
#: K = 5, 10 and 20 measured alike at 100 iterations (``PERF.md`` §6).
RUN_BLOCK_ITERS = 10
#: capture full blocks as CUDA graphs on a CUDA device.  ``False`` runs
#: the same blocks eagerly: the reference a captured run is held to,
#: bitwise.
CUDA_GRAPHS = True
#: replays a first run must have ahead before it captures its block
#: (``_capture_repays``): on the card a capture cost 1.2-3 warm-up blocks
#: of host time, now and then far more, and a replay of a host-paced
#: block saved 0.4-0.95 of one; 9 replays repaid it in every host-paced
#: row, 4 did not on config 5 (``scripts/first_call_cost.py``,
#: ``PERF.md`` §6).  So K = 10 captures from 90 iterations.
CAPTURE_MIN_REPLAYS = 8

#: memo-key declaration (tpu_sgd_torch/analysis): the single-slot cache of
#: the previous run's loop, ``(key, run)``, whose runner keeps its captured
#: CUDA graph for the next call; a key field missing here replays another
#: run's graph
GRAFTLINT_MEMO = {
    "GradientDescent._run_cache": (
        "gradient", "updater", "config", "mesh", "X", "gram_chunk_iters",
        # the meshed statistics run's key carries the stack's geometry
        # (B, n_used), which derives from the data, its device and the
        # gram / ingest knobs of the cached stack it was built from
        "y", "dev", "_streamed_gram_dp_entry", "gram_batch_rows",
        "gram_block_rows", "ingest_pipeline", "ingest_prefetch_depth",
        "ingest_wire_dtype",
    ),
}


def _raise_if_nonfinite(losses, first_iteration: int = 1) -> None:
    """The numerics check of ``set_check_numerics``.  ``first_iteration``
    is the iteration of ``losses[0]``: the observed driver checks one loss
    at a time and reports the true iteration."""
    arr = np.asarray(losses)
    bad = np.nonzero(~np.isfinite(arr))[0]
    if bad.size:
        raise FloatingPointError(
            f"non-finite loss at iteration {int(bad[0]) + first_iteration} "
            f"(loss={arr[bad[0]]}); reduce step_size or check the data"
        )


def _coerce_w0(gradient, initial_weights, n_features, device) -> Tensor:
    """Initial weights as float32 master weights on ``device``, with a
    clear error for a wrong length."""
    w0 = as_tensor(initial_weights, device, torch.float32)
    expect_dim = gradient.weight_dim(n_features)
    if w0.shape[-1] != expect_dim:
        raise ValueError(
            f"initial_weights has length {w0.shape[-1]} but this "
            f"gradient needs {expect_dim} for {n_features}-feature data"
        )
    return w0


def _host(t) -> np.ndarray:
    """A tensor as a host numpy array (one copy from the card)."""
    return t.detach().cpu().numpy() if isinstance(t, Tensor) \
        else np.asarray(t)


# -- sampling -----------------------------------------------------------------

def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _seed_for(seed: int, i: int, shard: Optional[int] = None) -> int:
    """The CPU generator seed of iteration ``i``: a function of ``(seed,
    i)`` alone, so iteration ``i`` draws the same sample in any run.
    Mixed by splitmix64, since the CPU generator keeps only the low 32
    bits.  On a mesh the data shard is folded in by one more round (the
    JAX package folds the shard index into every sample key); without
    one the seed is what it always was."""
    z = _splitmix64(((int(seed) & 0xFFFFFFFF) << 32) | (int(i) & 0xFFFFFFFF))
    if shard is not None:
        z = _splitmix64(z ^ (int(shard) & 0xFFFFFFFFFFFFFFFF))
    return z


def _window_start(gen, n: int, m: int, device) -> Tensor:
    """The sliced window's start, a ``(1,)`` device tensor drawn from
    ``gen``: the one window stream of ``make_run`` and the chunked gram
    driver."""
    return torch.randint(0, max(1, n - m + 1), (1,), generator=gen,
                         device=device)


class _Sampler:
    """The sample stream of a run: iteration ``i``'s draw is a function of
    ``(seed, i)`` alone, also across a checkpoint resume at any ``i``.

    On the CPU a generator is reseeded from ``_seed_for(seed, i)`` before
    the draw of iteration ``i``.  A CUDA generator cannot be reseeded
    inside a graph capture, and a replayed graph would keep the seed of
    capture time, so on a CUDA device one Philox generator, seeded from
    ``seed``, serves the run: :meth:`seek` sets its offset to ``stride ·
    (i − 1)`` before the first draw of iteration ``i``, and each draw
    advances it by ``stride``, eagerly or in a replayed graph (the graph
    registers the generator, and each replay reads its offset at replay
    time).  ``stride`` is what one draw advances the offset, measured
    once with a draw of the run's own shape; :meth:`seek` runs on the host
    before each block and never inside a capture.

    On a mesh, ``shard`` (the rank's data index) is folded into every seed
    (:func:`_seed_for`): each shard draws its own stream over its own
    rows, the CUDA generator seeded from ``(seed, shard)``."""

    def __init__(self, seed: int, device: torch.device, draw,
                 shard: Optional[int] = None):
        self.seed = int(seed)
        self.shard = shard
        self.cuda = device.type == "cuda"
        self._draw = draw
        self.gen = torch.Generator(device=device)
        self._next = 1
        self.stride = 0
        if self.cuda:
            self.gen.manual_seed(_seed_for(self.seed, 0, shard))
            before = self.gen.get_offset()
            draw(self.gen)
            self.stride = self.gen.get_offset() - before

    def seek(self, i: int) -> None:
        """Position the stream at iteration ``i``'s draw."""
        if self.cuda:
            self.gen.set_offset(self.stride * (int(i) - 1))
        else:
            self._next = int(i)

    def draw(self) -> Tensor:
        """The next iteration's sample."""
        if not self.cuda:
            self.gen.manual_seed(_seed_for(self.seed, self._next, self.shard))
            self._next += 1
        return self._draw(self.gen)


def _make_sampler(cfg: SGDConfig, X, shard: Optional[int] = None
                  ) -> Optional[_Sampler]:
    """The run's sample stream, or None at full batch: a window start
    (sliced), ``round(frac · n)`` row indices (indexed) or a Bernoulli
    mask (bernoulli), over the ``n`` rows of ``X`` (on a mesh, the rank's
    padded local rows, and ``shard`` its data index)."""
    frac = cfg.mini_batch_fraction
    if frac >= 1.0:
        return None
    n, dev = X.shape[0], X.device
    m = max(1, round(frac * n))
    if cfg.sampling == "sliced":
        # module-level lookup at draw time (tests inject window starts)
        draw = lambda gen: _window_start(gen, n, m, dev)  # noqa: E731
    elif cfg.sampling == "indexed":
        draw = lambda gen: torch.randint(  # noqa: E731
            0, n, (m,), generator=gen, device=dev)
    else:
        draw = lambda gen: torch.rand(  # noqa: E731
            n, generator=gen, device=dev) < frac
    return _Sampler(cfg.seed, dev, draw, shard)


def _model_combiner(mesh):
    """The model axis's combine of a 2-D mesh (``parallel.mesh
    .combine_model`` bound to it), or None on one device or a data
    mesh."""
    if not has_model_axis(mesh):
        return None
    return lambda t: combine_model(mesh, t)


def _make_local_sums(gradient, cfg, margin_combine=None):
    """The per-iteration ``(grad_sum, loss_sum, count)`` recipe from one
    drawn sample (``_make_sampler``; None at full batch) plus the fused
    batch sums.  ``margin_combine``: a 2-D mesh's model-axis combine of
    the partial margins (``_model_combiner``), handed to the gradient as
    its ``margin_axis_name``."""
    indexed = cfg.sampling == "indexed" and cfg.mini_batch_fraction < 1.0
    sliced = cfg.sampling == "sliced" and cfg.mini_batch_fraction < 1.0
    kw = {} if margin_combine is None else {
        "margin_axis_name": margin_combine}

    def local_sums(weights, X, y, sample, valid, Xt=None):
        if sliced:
            # a contiguous window at a random start, drawn on the device;
            # the window kernel reads it in place (assumes exchangeable
            # row order, see SGDConfig.sampling)
            m = max(1, round(cfg.mini_batch_fraction * X.shape[0]))
            return gradient.window_sums(X, y, weights, sample, m,
                                        valid=valid, **kw)
        if indexed:
            Xb, yb = X[sample], y[sample]
            mask = None if valid is None else valid[sample]
        else:
            Xb, yb = X, y
            mask = sample if valid is None else (
                valid if sample is None else sample & valid)
            if Xt is not None:
                return gradient.batch_sums(Xb, yb, weights, mask, Xt=Xt)
        return gradient.batch_sums(Xb, yb, weights, mask, **kw)

    return local_sums


def _make_update(gradient, updater, cfg, mesh=None):
    """The iteration's math after its sample is drawn: ``update(weights,
    X, y, i, reg_val, sample, valid, Xt) -> (new_w, loss_i, new_reg,
    count)`` with ``i`` the ``(1,)`` int64 iteration counter on the
    weights' device.  On a data ``mesh`` the rank's local sums are
    combined over the ranks (``parallel.mesh.combine_sums``) before the
    update, which then runs identically on every rank: the weights stay
    replicated.  On a 2-D ``(data, model)`` mesh ``weights`` and X are
    the rank's feature block: the partial margins are combined over the
    model axis inside the sums, the sums over the data axis, and the reg
    value, a sum over features, over the model axis; every rank of one
    model column then holds the same weight block."""
    model = _model_combiner(mesh)
    local_sums = _make_local_sums(gradient, cfg, model)

    def update(weights, X, y, i, reg_val, sample, valid=None, Xt=None):
        g, l, c = local_sums(weights, X, y, sample, valid, Xt)
        if mesh is not None:
            g, l, c = combine_sums(mesh, g, l, c)
        new_w, loss_i, new_reg = apply_sums(updater, cfg, weights, g, l, c,
                                            i, reg_val, model=model)
        return new_w, loss_i, new_reg, c

    return update


def apply_sums(updater, cfg, weights, g, l, c, i, reg_val, *, denom=None,
               model=None):
    """The iteration's math after its sums are combined: ``(new_w, loss_i,
    new_reg)`` from the combined ``(grad_sum g, loss_sum l, count c)``.
    ``loss_i = l / max(c, 1) + reg_val``, the updater steps on ``g /
    max(c, 1)`` (or on ``g / denom``: the replica store's compressed wire,
    whose ``g`` is already a sum of batch-mean gradients), and an empty
    batch (``c == 0``) leaves the weights and the reg value as they were.
    ``model``: a 2-D mesh's model-axis combine of the reg value.  The one
    definition shared by :func:`_make_update` and the replica store's
    apply (``replica/store.py``), so a τ=0 replica run is the synchronous
    run by construction."""
    has_batch = c > 0
    safe_c = torch.clamp(c, min=1.0)
    loss_i = l / safe_c + reg_val
    new_w, new_reg = updater.compute(
        weights, g / (safe_c if denom is None else denom), cfg.step_size, i,
        cfg.reg_param
    )
    if model is not None:
        new_reg = model(new_reg)
    # Reference behavior on an empty sampled batch: skip the update.
    new_w = torch.where(has_batch, new_w, weights)
    new_reg = torch.where(has_batch, new_reg, reg_val)
    return new_w, loss_i, new_reg


def _make_compressed_update(gradient, updater, cfg, topk_frac: float,
                            mesh=None):
    """:func:`_make_update` over the COMPRESSED wire (top-k with error
    feedback, the JAX package's ``make_compressed_step``): ``update(weights,
    ef, X, y, i, reg_val, sample, valid, Xt) -> (new_w, new_ef, loss_i,
    new_reg, count)``.  The normalized gradient is folded into the
    accumulator ``ef``; the ``k = topk_nnz(d, frac)`` entries of largest
    magnitude (``io.sparse_wire.topk_indices``: the lower index wins a
    tie, every run alike) are the applied update and leave the
    accumulator, the rest stays in it.  An empty sampled batch leaves the
    weights AND the accumulator untouched.

    On a data ``mesh`` the loss and the count combine densely
    (``parallel.mesh.combine``), each rank folds ITS local gradient sum
    over the global count into ITS accumulator, and the ranks' top-k
    segments are the wire (``parallel.mesh.combine_topk``: one gather of
    ``2·k`` entries a rank, added in rank order): the applied update is
    their sum, the same on every rank."""
    from tpu_sgd_torch.io.sparse_wire import topk_indices, topk_nnz
    from tpu_sgd_torch.parallel.mesh import combine, combine_topk

    local_sums = _make_local_sums(gradient, cfg)

    def update(weights, ef, X, y, i, reg_val, sample, valid=None, Xt=None):
        g, l, c = local_sums(weights, X, y, sample, valid, Xt)
        if mesh is not None:
            l, c = combine(mesh, l, c)
        has_batch = c > 0
        safe_c = torch.clamp(c, min=1.0)
        loss_i = l / safe_c + reg_val
        acc = ef + (g / safe_c).to(ef.dtype)
        k = topk_nnz(acc.shape[-1], topk_frac)  # fixed: one shape a run
        top = topk_indices(acc, k)
        if mesh is None:
            sel = torch.zeros(acc.shape, dtype=torch.bool,
                              device=acc.device)
            sel.index_fill_(0, top, True)
            zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
            ghat = torch.where(sel, acc, zero)
            new_ef = torch.where(sel, zero, acc)
        else:
            ghat = combine_topk(mesh, acc.index_select(0, top), top,
                                acc.shape[-1])
            new_ef = acc.index_fill(0, top, 0.0)
        new_w, new_reg = updater.compute(
            weights, ghat.to(weights.dtype), cfg.step_size, i, cfg.reg_param)
        new_w = torch.where(has_batch, new_w, weights)
        new_reg = torch.where(has_batch, new_reg, reg_val)
        new_ef = torch.where(has_batch, new_ef, ef)
        return new_w, new_ef, loss_i, new_reg, c

    return update


def make_compressed_step(gradient: Gradient, updater: Updater,
                         config: SGDConfig, topk_frac: float, mesh=None):
    """One SGD iteration over the compressed wire: ``step(weights, ef, X,
    y, i, reg_val, valid, Xt) -> (new_w, new_ef, loss_i, new_reg_val,
    count)``.  Sampling and the batch sums are :func:`make_step`'s; the
    applied update is the top-k of the error-feedback accumulator ``ef``
    plus the normalized gradient (see :func:`_make_compressed_update`).
    ``ef`` is optimizer state: the caller carries it, checkpoints it
    (``extras={"ef": ...}``) and restores it on resume.  On a 1-D data
    ``mesh`` ``ef`` is this rank's accumulator (the JAX package's row of
    its ``(n_shards, d)`` state) and the segments combine over the
    ranks."""
    cfg = config
    update = _make_compressed_update(gradient, updater, cfg, topk_frac,
                                     mesh)
    samplers = {}

    def step(weights, ef, X, y, i, reg_val, valid=None, Xt=None):
        key = (X.shape[0], str(X.device))
        if key not in samplers:
            samplers[key] = _make_sampler(cfg, X, _shard_of(mesh))
        sampler = samplers[key]
        if not isinstance(i, Tensor):
            if sampler is not None:
                sampler.seek(i)
            i = torch.full((1,), int(i), dtype=torch.int64,
                           device=weights.device)
        sample = None if sampler is None else sampler.draw()
        return update(weights, ef, X, y, i, reg_val, sample, valid, Xt)

    return step


def _shard_of(mesh) -> Optional[int]:
    return None if mesh is None else mesh.rank


def make_step(gradient: Gradient, updater: Updater, config: SGDConfig,
              mesh=None):
    """One SGD iteration: ``step(weights, X, y, i, reg_val, valid, Xt) ->
    (new_weights, loss_i, new_reg_val, count)``; ``loss_i`` already
    includes the previous iteration's ``reg_val``.  ``i`` is a host int
    (the step positions the sample stream at iteration ``i``) or the
    ``(1,)`` int64 counter of a block (the block positioned the stream
    before its first iteration).  ``Xt`` is sparse X's transposed CSR
    (None for dense X).  On a 1-D data ``mesh`` (``parallel.mesh``), X,
    y and valid are the rank's padded local rows, the sample is the
    rank's shard stream, and the sums are combined over the ranks."""
    cfg = config
    update = _make_update(gradient, updater, cfg, mesh)
    samplers = {}

    def sampler_for(X) -> Optional[_Sampler]:
        key = (X.shape[0], str(X.device))
        if key not in samplers:
            samplers[key] = _make_sampler(cfg, X, _shard_of(mesh))
        return samplers[key]

    def step(weights, X, y, i, reg_val, valid=None, Xt=None):
        sampler = sampler_for(X)
        if not isinstance(i, Tensor):
            if sampler is not None:
                sampler.seek(i)
            i = torch.full((1,), int(i), dtype=torch.int64,
                           device=weights.device)
        sample = None if sampler is None else sampler.draw()
        return update(weights, X, y, i, reg_val, sample, valid, Xt)

    return step


# -- blocks of iterations -----------------------------------------------------

class _RunState:
    """The device state of a run: the weights, the reg value, the
    iteration counter, the convergence flag, the record count and the
    loss history; for the observed drivers also ``ys``, one row a step of
    a block (``w``, then loss, reg value, count, ``‖w_t − w_{t−1}‖``,
    ``‖w_t‖``, all float32: the JAX package's ``pack_step_ys``),
    followed by the step's extra carried state when the run carries one
    (``extra``: the compressed wire's error-feedback accumulator)."""

    def __init__(self, w0: Tensor, num_iterations: int, ys_rows: int = 0,
                 extra: Optional[Tensor] = None):
        dev = w0.device
        self.extra = None if extra is None else torch.empty_like(extra)
        extra_cols = 0 if extra is None else extra.numel()
        self.w = torch.empty_like(w0)
        self.reg = torch.zeros((), dtype=torch.float32, device=dev)
        self.i = torch.ones((1,), dtype=torch.int64, device=dev)
        self.conv = torch.zeros((), dtype=torch.bool, device=dev)
        self.n_rec = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.losses = torch.full((num_iterations,), float("nan"),
                                 dtype=torch.float32, device=dev)
        self.ys = (torch.zeros((ys_rows, w0.numel() + 5 + extra_cols),
                               dtype=torch.float32, device=dev)
                   if ys_rows else None)

    def reset(self, w0: Tensor, reg_val, i0: int, extra0=None) -> None:
        """Start a run at iteration ``i0`` from ``w0`` and ``reg_val`` (a
        tensor or a host float), and ``extra0`` where the run carries
        extra state, in place: a captured graph keeps reading these
        buffers."""
        self.w.copy_(w0)
        if self.extra is not None:
            self.extra.copy_(torch.as_tensor(extra0, dtype=self.extra.dtype)
                             .reshape(self.extra.shape))
        if isinstance(reg_val, Tensor):
            self.reg.copy_(reg_val)
        else:
            self.reg.fill_(float(reg_val))
        self.i.fill_(int(i0))
        self.conv.fill_(False)
        self.n_rec.zero_()
        self.losses.fill_(float("nan"))

    def ys_leaves(self, rows: np.ndarray):
        """Host ys rows as the JAX package's six leaves ``(ws, losses,
        regs, counts, delta_norms, weight_norms)``, and a seventh, the
        per-step extra state, when the run carries one."""
        d = self.w.numel()
        leaves = (rows[:, :d], rows[:, d], rows[:, d + 1], rows[:, d + 2],
                  rows[:, d + 3], rows[:, d + 4])
        if self.extra is not None:
            leaves += (rows[:, d + 5:],)
        return leaves


def _global_norms(new_w, w, model):
    """``(‖w_t − w_{t−1}‖, ‖w_t‖)`` of the whole weight vector: on a 2-D
    mesh the squared norms of the rank's block summed over the model axis
    (``model``), then the roots, as the JAX package's ``_global_norms``."""
    if model is None:
        return (torch.linalg.vector_norm(new_w - w),
                torch.linalg.vector_norm(new_w))
    sq = model(torch.stack([torch.sum((new_w - w) ** 2),
                            torch.sum(new_w ** 2)]))
    return torch.sqrt(sq[0]), torch.sqrt(sq[1])


def _record_step(st: _RunState, rec, active, loss_i, w, new_w, reg,
                 new_reg, tol: float, model=None):
    """One iteration's bookkeeping in the unobserved run, on the device:
    record ``loss_i`` when ``rec``, test convergence when ``tol > 0``, and
    return the weights and reg value to carry on (the new ones while
    ``active``: once the flag is set, the rest of the block is a no-op).
    Shared by ``make_run``'s block and the chunked gram driver; ``model``
    is a 2-D mesh's model-axis combine (the norms span every block)."""
    kept = st.losses.index_select(0, st.n_rec)
    st.losses.index_copy_(0, st.n_rec, torch.where(
        rec, loss_i.to(torch.float32).reshape(1), kept))
    st.n_rec += rec.to(torch.int64)
    if tol > 0.0:
        diff, w_norm = _global_norms(new_w, w, model)
        st.conv |= rec & (st.i[0] > 1) & (
            diff < tol * torch.clamp(w_norm, min=1.0))
    return torch.where(active, new_w, w), torch.where(active, new_reg, reg)


def _make_block(gradient, updater, cfg, *, history: bool,
                stacked: bool = False, topk_frac: Optional[float] = None,
                mesh=None):
    """``block(state, data, sampler, steps)``: ``steps`` consecutive
    iterations from ``state`` (a :class:`_RunState`), in place.

    ``history=True`` is the unobserved run's block: each iteration
    records its loss on the device and tests convergence there; once the
    flag is set the rest of the block is masked to no-ops, so the weights,
    the history and the count freeze at the true iteration.
    ``history=False`` is the observed drivers' block: each iteration
    writes its ys row, and the host decides convergence from the rows.

    ``stacked=True`` is the host-streamed superstep's block: ``data``
    holds one batch a step (``X[t]``, ``y[t]``, ``valid[t]``, ``Xt[t]``:
    a ``(K, rows, d)`` superchunk, or lists of sparse batches).
    ``topk_frac`` runs the compressed-wire update, its error-feedback
    accumulator carried in ``state.extra`` and written into each ys
    row.  ``mesh``: the data mesh whose ranks combine each step's sums
    (dense or sparse data; with ``topk_frac`` the segments, each rank's
    accumulator its own), or a 2-D mesh (dense data, ``history=True``:
    the JAX package's observed driver refuses it)."""
    model = _model_combiner(mesh)
    if topk_frac is None:
        update = _make_update(gradient, updater, cfg, mesh)
    else:
        cupdate = _make_compressed_update(gradient, updater, cfg, topk_frac,
                                          mesh)
    tol = cfg.convergence_tol

    def block(st: _RunState, data, sampler, steps: int) -> None:
        X, y, valid, Xt = data
        w, reg, ef = st.w, st.reg, st.extra
        for t in range(steps):
            if stacked:
                Xb, yb, vb = X[t], y[t], valid[t]
                Xtb = None if Xt is None else Xt[t]
            else:
                Xb, yb, vb, Xtb = X, y, valid, Xt
            sample = None if sampler is None else sampler.draw()
            if topk_frac is None:
                new_w, loss_i, new_reg, c = update(w, Xb, yb, st.i, reg,
                                                   sample, vb, Xtb)
            else:
                new_w, ef, loss_i, new_reg, c = cupdate(
                    w, ef, Xb, yb, st.i, reg, sample, vb, Xtb)
            if history:
                active = ~st.conv
                w, reg = _record_step(st, active & (c > 0), active, loss_i,
                                      w, new_w, reg, new_reg, tol, model)
            else:
                f32 = torch.float32
                row = [new_w.reshape(-1), torch.stack([
                    loss_i.to(f32), new_reg.to(f32), c.to(f32),
                    torch.linalg.vector_norm(new_w - w),
                    torch.linalg.vector_norm(new_w)])]
                if topk_frac is not None:
                    row.append(ef.reshape(-1).to(f32))
                st.ys[t].copy_(torch.cat(row))
                w, reg = new_w, new_reg
            st.i += 1
        st.w.copy_(w)
        st.reg.copy_(reg)
        if topk_frac is not None:
            st.extra.copy_(ef)

    return block


def _captures(gradient, cfg: SGDConfig, device, mesh=None) -> bool:
    """Whether a run's full blocks may be captured as CUDA graphs: on a
    CUDA device, unless ``CUDA_GRAPHS`` is off, or the window of ``sliced``
    sampling is sliced on the host (a gradient without a kernel rule,
    ``family=None``, reads the start there), which a capture cannot do, or
    the run's mesh combines over a backend other than NCCL (gloo gathers
    through the host, which a capture cannot do either)."""
    host_window = (cfg.sampling == "sliced" and cfg.mini_batch_fraction < 1.0
                   and getattr(gradient, "family", None) is None)
    host_combine = mesh is not None and mesh.backend != "nccl"
    return (CUDA_GRAPHS and device.type == "cuda" and not host_window
            and not host_combine)


def _capture_repays(replays: int, host_ms: float, card_ms: float) -> bool:
    """Whether capturing a block repays itself within one run: the card
    waited on the host in the eager warm-up block (its time on the card,
    ``card_ms`` between two events, idle gaps included, was no longer
    than the host's ``host_ms`` to issue it, with 10% slack; a block the
    card paces takes longer there), and ``replays`` replays, at least
    ``CAPTURE_MIN_REPLAYS``, are ahead to save the host's time."""
    return card_ms <= 1.1 * host_ms and replays >= CAPTURE_MIN_REPLAYS


class _BlockRunner:
    """Runs the blocks of a run from its device state.

    On a CUDA device with ``capture``, the first full block (``k``
    iterations) runs eagerly as the warm-up; the block is then captured
    once as a CUDA graph (the sample stream's generator registered with
    it) and every later full block replays the graph.  With ``adaptive``
    (the unobserved run), a run captures only when the capture repays
    itself in that run (``_capture_repays``: the warm-up, timed on the
    host and on the card, is read once at the next full block; a run too
    short for ``CAPTURE_MIN_REPLAYS`` replays is not even timed), or when
    it repeats a run on the same tensors; otherwise its blocks stay
    eager.  On a mesh the decision must be the same on every rank, so it
    reads no clock (``timed=False``): a first run captures when
    ``CAPTURE_MIN_REPLAYS`` replays are ahead.
    A capture launches nothing, so the kernel launches it records are
    taken out of the wrappers' counts and added again on each replay
    (``cuda_kernels.captured_launches``): a count stays one per kernel
    the card runs, the frozen tail of a converged block included.  A
    block shorter than ``k`` runs eagerly.  A failed capture or replay
    raises; nothing falls back to the eager loop.

    The runner holds its run's tensors only between :meth:`begin` and
    :meth:`end`; in between runs it keeps weak references, to know a
    repeated run on the same tensors, and its own buffers: the state and
    the graph with its pool.  A tensor built for the run (``owned``:
    sparse X's transposed CSR, a second copy of the data) goes at the
    run's end with the graph that reads it, and the runner serves no
    other run."""

    def __init__(self, block, state: _RunState, data, sampler, k: int,
                 capture: bool, adaptive: bool, owned=None,
                 timed: bool = True):
        self.block = block
        self.state = state
        self.sampler = sampler
        self.k = int(k)
        self.capture = bool(capture)
        self.adaptive = bool(adaptive)
        self.timed = bool(timed)
        self._refs = tuple(None if t is None else weakref.ref(t)
                           for t in data)
        self._owned = owned
        self.data = None
        self.graph = None
        self.launches = None
        self.warm = False
        self._last = 0
        self._repeat = False
        self._decision = None
        self._warm_events = None
        #: host ms to issue the warm-up block, and its ms on the card
        #: (between two events, idle gaps included)
        self.warm_host_ms = None
        self.warm_card_ms = None
        #: one-off ms of the capture (host clock)
        self.capture_ms = None
        #: runs begun, graph replays and eager blocks since construction
        self.runs = 0
        self.replays = 0
        self.eager_blocks = 0

    def same_data(self, X, y, valid, Xt, w0) -> bool:
        """Whether a run on these tensors repeats this runner's."""
        got = tuple(None if r is None else r() for r in self._refs)
        return (got[0] is not None
                and all(a is b for a, b in zip(got, (X, y, valid, Xt)))
                and self.state.w.shape == w0.shape
                and self.state.w.device == w0.device)

    def begin(self, X, y, valid, Xt, last: int) -> None:
        """Hold the run's tensors; the run ends at iteration ``last``."""
        self.data = (X, y, valid, self._owned if Xt is None else Xt)
        self._last = int(last)
        self._repeat = self.runs > 0
        self._decision = None
        self.runs += 1

    def end(self) -> None:
        """Let go of the run's tensors (and of an owned tensor, its graph
        and the runner's claim to the next run)."""
        self.data = None
        if self._owned is not None:
            self._owned = self.graph = None
            self._refs = (None,) * len(self._refs)

    def _may_capture(self, i0: int) -> bool:
        """Whether a run could still capture once the block at ``i0`` has
        warmed up: always on the observed drivers and on a repeated run;
        on a first unobserved run, when ``CAPTURE_MIN_REPLAYS`` full
        blocks follow it."""
        return (not self.adaptive or self._repeat
                or (self._last - i0 + 1) // self.k - 1
                >= CAPTURE_MIN_REPLAYS)

    def _capture_now(self, i0: int) -> bool:
        """Whether this run captures the block at ``i0`` (decided once a
        run, at its first full block after the warm-up, from the warm-up's
        times)."""
        if not self.adaptive or self._repeat:
            return True
        if self._decision is None:
            replays = (self._last - i0 + 1) // self.k
            if not self.timed:
                self._decision = replays >= CAPTURE_MIN_REPLAYS
                return self._decision
            start, stop = self._warm_events
            stop.synchronize()
            self.warm_card_ms = start.elapsed_time(stop)
            self._decision = _capture_repays(replays, self.warm_host_ms,
                                             self.warm_card_ms)
        return self._decision

    def _eager(self, steps: int) -> None:
        self.block(self.state, self.data, self.sampler, steps)
        self.eager_blocks += 1

    def _warm_up(self, steps: int) -> None:
        """The first full block, eager; timed on the host and on the card
        when a first unobserved run is to decide on a capture."""
        if not self.adaptive or self._repeat or not self.timed:
            self._eager(steps)
        else:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            self._eager(steps)
            stop.record()
            self.warm_host_ms = 1e3 * (time.perf_counter() - t0)
            self._warm_events = (start, stop)
        self.warm = True

    def _capture(self, i0: int, steps: int) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        if self.sampler is not None:
            graph.register_generator_state(self.sampler.gen)
        with ck.captured_launches() as record:
            with torch.cuda.graph(graph):
                self.block(self.state, self.data, self.sampler, steps)
        self.graph, self.launches = graph, record
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        if self.sampler is not None:
            self.sampler.seek(i0)

    def run(self, i0: int, steps: int) -> None:
        """Iterations ``i0 .. i0 + steps - 1`` (the state's counter is at
        ``i0``)."""
        if self.sampler is not None:
            self.sampler.seek(i0)
        full = steps == self.k
        if self.graph is None and full and self.capture:
            if not self.warm:
                if self._may_capture(i0):
                    self._warm_up(steps)
                    return
            elif self._capture_now(i0):
                self._capture(i0, steps)
        if self.graph is None or not full:
            self._eager(steps)
            return
        self.graph.replay()
        ck.add_replayed_launches(self.launches)
        self.replays += 1


def _run_blocks(runner: _BlockRunner, num_iterations: int,
                check_conv: bool) -> None:
    """Iterations ``1 .. num_iterations`` in blocks of ``runner.k``; with
    ``check_conv`` the host reads the device's convergence flag once a
    block, and the run stops at the block boundary (the rest of the block
    ran masked to no-ops)."""
    i0 = 1
    while i0 <= num_iterations:
        steps = min(runner.k, num_iterations - i0 + 1)
        runner.run(i0, steps)
        i0 += steps
        if check_conv and bool(runner.state.conv):  # the host sync
            break


def _run_runner(cache: dict, make, X, y, valid, Xt, w0) -> _BlockRunner:
    """The cached runner of ``cache`` when it ran on these tensors, else a
    new one from ``make()`` (the old one, its graph and its buffers are
    dropped first)."""
    runner = cache.get("runner")
    if runner is None or not runner.same_data(X, y, valid, Xt, w0):
        cache.clear()
        runner = cache["runner"] = make()
    return runner


def make_run(gradient: Gradient, updater: Updater, config: SGDConfig,
             mesh=None):
    """The whole optimization loop: ``run(initial_weights, X, y, valid,
    Xt) -> (weights, loss_history, n_recorded)``.  ``loss_history`` is a
    device tensor of length ``num_iterations``, NaN beyond ``n_recorded``
    (a device int64 tensor of shape ``(1,)``).  The run goes in blocks of
    ``RUN_BLOCK_ITERS`` iterations, captured as CUDA graphs on a CUDA
    device where the capture repays itself (module docstring); the graph
    and its buffers are kept for the next call on the same tensors.
    Sparse ``X`` is CSR; its transposed copy ``Xt`` is built once, unless
    the caller passes the one it holds (``ops.sparse.transpose_csr``).
    On a 1-D data ``mesh`` the run is :func:`make_step`'s over the rank's
    local rows (the JAX package's ``make_run`` under ``shard_map``): every
    rank records the same history and stops at the same block.  On a 2-D
    ``(data, model)`` mesh, ``initial_weights`` and X are the rank's
    feature block (``parallel.model_parallel``), and the run returns the
    rank's block of the weights."""
    cfg = config
    check_conv = cfg.convergence_tol > 0.0
    N = cfg.num_iterations
    K = min(RUN_BLOCK_ITERS, N)
    block = _make_block(gradient, updater, cfg, history=True, mesh=mesh)
    model = _model_combiner(mesh)
    cache: dict = {}

    def run(initial_weights, X, y, valid=None, Xt=None):
        w0 = initial_weights

        def make():
            own = transpose_csr(X) if Xt is None and is_sparse(X) else None
            return _BlockRunner(block, _RunState(w0, N), (X, y, valid, Xt),
                                _make_sampler(cfg, X, _shard_of(mesh)), K,
                                _captures(gradient, cfg, w0.device, mesh),
                                adaptive=True, owned=own,
                                timed=mesh is None)

        runner = _run_runner(cache, make, X, y, valid, Xt, w0)
        st = runner.state
        _, reg0 = updater.compute(w0, torch.zeros_like(w0), 0.0, 1,
                                  cfg.reg_param)
        if model is not None:
            # the reg value sums over features: a warm-started 2-D run
            # would otherwise record a block's share at iteration 1
            reg0 = model(reg0)
        st.reset(w0, reg0, 1)
        runner.begin(X, y, valid, Xt, N)
        try:
            _run_blocks(runner, N, check_conv)
        finally:
            runner.end()
        return st.w.clone(), st.losses.clone(), st.n_rec.clone()

    run.cache = cache
    return run


# -- the observed driver's host bookkeeping ------------------------------------

def step_norms(new_w: Tensor, w: Tensor) -> Tensor:
    """``(‖w_t − w_{t−1}‖, ‖w_t‖)`` of one observed step as one tensor,
    fetched once: the same two reductions the block writes into its ys
    rows, so the observed drivers agree bitwise."""
    return torch.stack((torch.linalg.vector_norm(new_w - w),
                        torch.linalg.vector_norm(new_w)))


def observe_step(
    i, prev_w, new_w, loss_i, new_reg, count, losses, reg_val, cfg, *,
    listener=None, wall_dt=0.0, check_numerics=False,
    save_cb=None, save_every=0,
):
    """One OBSERVED iteration's host bookkeeping: the per-step
    record/convergence/checkpoint recipe of the K = 1 driver (the fused
    twin is :func:`_replay_fused_steps`, which replays the same recipe
    from ys rows).

    Takes the step's DEVICE results plus the host-side running state;
    fetches each scalar exactly once, appends to ``losses`` in place, and
    fires ``save_cb(i, w_np, reg_val)`` on the cadence (``i % save_every
    == 0``, on convergence, and at the final iteration).  An empty
    sampled batch (``count == 0``) records nothing and returns ``prev_w``.

    Returns ``(w, reg_val, converged)`` — ``w`` is ``new_w`` when the
    step recorded, else ``prev_w``.  The live ``train.loss`` /
    ``train.weight_delta`` series (``obs/timeseries.py``) take the host
    floats fetched here, with no added sync.
    """
    from tpu_sgd_torch.utils.events import IterationEvent

    c_host = int(count)  # count gates the whole bookkeeping branch
    converged = False
    if c_host <= 0:
        return prev_w, reg_val, converged
    loss_f = float(loss_i)  # per-iteration loss history is the contract
    if check_numerics and not np.isfinite(loss_f):
        _raise_if_nonfinite([loss_f], first_iteration=i)
    losses.append(loss_f)
    reg_val = float(new_reg)
    # one fetch for both norms
    delta, w_norm = (float(v) for v in _host(step_norms(new_w, prev_w)))
    observe_scalar("train.loss", loss_f)
    observe_scalar("train.weight_delta", delta)
    if listener is not None:
        listener.on_iteration(IterationEvent(
            iteration=i,
            loss=loss_f,
            weight_delta_norm=delta,
            mini_batch_size=c_host,
            wall_time_s=wall_dt,
        ))
    if cfg.convergence_tol > 0 and i > 1:
        converged = delta < cfg.convergence_tol * max(w_norm, 1.0)
    if save_cb is not None and (
            (save_every and i % save_every == 0)
            or converged or i == cfg.num_iterations):
        save_cb(i, _host(new_w), reg_val)
    return new_w, reg_val, converged


def observed_loop_tail(
    i, w, new_w, loss_i, new_reg, count, losses, reg_val, cfg, *,
    listener=None, wall_dt=0.0, save_cb=None, save_every=0,
    stop_signal=None, check_numerics=False,
):
    """One observed iteration's ENTIRE host tail: :func:`observe_step`
    plus the cooperative-preemption check (persist the CURRENT iteration
    through ``save_cb``, then unwind
    :class:`~tpu_sgd_torch.reliability.supervisor.TrainingPreempted`).
    The caller owns the step's barrier and wall-clock timing.  (Here
    ``check_numerics`` passes through to :func:`observe_step`: the K = 1
    driver checks each loss at its true iteration.)"""
    w, reg_val, converged = observe_step(
        i, w, new_w, loss_i, new_reg, count, losses, reg_val, cfg,
        listener=listener, wall_dt=wall_dt, check_numerics=check_numerics,
        save_cb=save_cb, save_every=save_every,
    )
    if not converged and stop_signal is not None and stop_signal():
        # cooperative preemption (TrainingSupervisor): persist the
        # CURRENT iteration, then unwind cleanly; the save is atomic, so
        # a kill racing this leaves the previous checkpoint intact
        from tpu_sgd_torch.reliability.supervisor import TrainingPreempted

        if save_cb is not None:
            save_cb(i, _host(w), reg_val)
        raise TrainingPreempted(i)
    return w, reg_val, converged


def _replay_fused_steps(
    ys_host, i0, steps, losses, reg_val, cfg, *,
    listener=None, wall_dt=0.0, check_numerics=False,
    save_cb=None, save_every=0,
):
    """Replay one block's ys rows with EXACTLY the per-iteration loop's
    host bookkeeping: the one definition of the fused drivers'
    loss-history / convergence / checkpoint semantics.

    ``ys_host`` is the host ``(weights, loss, reg, count, delta_norm,
    weight_norm)`` stack; ``steps`` bounds the replay to the REAL
    iterations.  Convergence is detected per STEP from the rows — the
    true converged iteration, never the block boundary — with the host
    float comparison of the per-iteration loop (``delta < tol *
    max(||w||, 1)`` from the second update on), and empty sampled batches
    (``count == 0``) skip the record.  ``save_cb(i, w_np, reg_val)``
    fires on the same cadence with the EXACT iteration-``i`` state, so
    fused checkpoints are indistinguishable from per-iteration ones and
    resume stays bitwise.

    Returns ``(t_last, reg_val, converged)``; the caller takes ``ys
    weights[t_last]`` as the final state when the run ends inside a
    block.
    """
    from tpu_sgd_torch.utils.events import IterationEvent

    ws, ls, rs, cs, dns, wns = ys_host
    converged = False
    t_last = 0
    for t in range(steps):
        i = i0 + t
        t_last = t
        if int(cs[t]) > 0:
            loss_f = float(ls[t])
            if check_numerics and not np.isfinite(loss_f):
                _raise_if_nonfinite([loss_f], first_iteration=i)
            losses.append(loss_f)
            reg_val = float(rs[t])
            # the live series from the replayed ys: already host numpy
            # (one bulk fetch a block), so no added sync
            observe_scalar("train.loss", loss_f)
            observe_scalar("train.weight_delta", float(dns[t]))
            if listener is not None:
                listener.on_iteration(IterationEvent(
                    iteration=i,
                    loss=loss_f,
                    weight_delta_norm=float(dns[t]),
                    mini_batch_size=int(cs[t]),
                    wall_time_s=wall_dt,
                ))
            if cfg.convergence_tol > 0 and i > 1:
                converged = float(dns[t]) < cfg.convergence_tol * max(
                    float(wns[t]), 1.0)
            if save_cb is not None and (
                    (save_every and i % save_every == 0)
                    or converged or i == cfg.num_iterations):
                save_cb(i, ws[t], reg_val)
        if converged:
            break
    return t_last, reg_val, converged


def agreed_stop(mesh, signal, dev):
    """A stop poll every rank of ``mesh`` answers alike: ``signal`` itself
    on one device (``mesh`` None); on a mesh, every rank's answer
    gathered so that all stop together (:func:`parallel.mesh.any_rank`),
    polled by every rank when any rank has a signal (agreed once here,
    collectively, so the ranks' collectives pair).  ``None``: nothing to
    poll."""
    if mesh is None:
        return signal
    if not any_rank(mesh, signal is not None, dev):
        return None
    return lambda: any_rank(mesh, signal is not None and signal(), dev)


def _fetch_rows(src: Tensor, rows: int, host: Optional[Tensor]):
    """The first ``rows`` rows of a device ys buffer as a host numpy copy:
    one copy into pinned memory on the card (``host``), then a wait for
    it."""
    if host is None:
        return _host(src[:rows]).copy()
    out = host[:rows]
    out.copy_(src[:rows], non_blocking=True)
    torch.cuda.current_stream(src.device).synchronize()
    return out.numpy().copy()


def _pinned_like(t: Tensor) -> Optional[Tensor]:
    """A pinned host buffer shaped like ``t`` for its copies off the card
    (None on the CPU)."""
    if not t.is_cuda:
        return None
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _streamed_stats_guards(optimizer, X) -> None:
    """``set_streamed_stats``'s guards: dense least squares, and not with
    host streaming (one device and a mesh alike)."""
    if optimizer.host_streaming:
        raise ValueError(
            "set_streamed_stats and set_host_streaming are alternative "
            "schedules for data beyond the card; enable exactly one")
    if is_sparse(X):
        raise NotImplementedError(
            "streamed statistics need dense rows; sparse features are "
            "~1000x smaller and stay resident on the card instead")
    if type(optimizer.gradient) is not LeastSquaresGradient:
        raise NotImplementedError(
            "streamed statistics exist for least squares only (the "
            f"quadratic loss); got {type(optimizer.gradient).__name__}: "
            "use set_host_streaming")


def _streamed_gram(optimizer, X, y) -> GramLeastSquaresGradient:
    """``set_streamed_stats``'s guards (:func:`_streamed_stats_guards`)
    and its build from host rows with the optimizer's gram and ingest
    knobs, cached by ``(X, y)`` identity and knobs in
    ``optimizer._streamed_gram_entry``; shared by ``GradientDescent`` and
    ``LBFGS``."""
    _streamed_stats_guards(optimizer, X)
    opts = (optimizer.gram_block_rows, optimizer.gram_batch_rows,
            optimizer.ingest_wire_dtype, optimizer.ingest_prefetch_depth,
            optimizer.ingest_pipeline, resolve_device(optimizer.device))
    entry = optimizer._streamed_gram_entry
    if (entry is not None and entry[0] is X and entry[1] is y
            and entry[3] == opts):
        return entry[2]
    optimizer._streamed_gram_entry = None  # free the superseded stack
    g = GramLeastSquaresGradient.build_streamed(
        X, y, block_rows=optimizer.gram_block_rows,
        batch_rows=optimizer.gram_batch_rows,
        wire_dtype=optimizer.ingest_wire_dtype,
        prefetch_depth=optimizer.ingest_prefetch_depth,
        pipeline=optimizer.ingest_pipeline, device=opts[-1])
    optimizer._streamed_gram_entry = (X, y, g, opts)
    return g


class GradientDescent(Optimizer):
    """Drop-in mini-batch SGD optimizer with the reference's fluent
    setters.  ``device=None`` runs on the card (``"cuda"``) and raises
    without one; pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(
        self,
        gradient: Gradient = None,
        updater: Updater = None,
        config: SGDConfig = None,
        device=None,
    ):
        self.gradient = gradient if gradient is not None else LeastSquaresGradient()
        self.updater = updater if updater is not None else SimpleUpdater()
        self.config = config if config is not None else SGDConfig()
        self.device = device
        self.check_numerics = False
        self._loss_history = None
        self.sufficient_stats = False
        self.gram_block_rows = DEFAULT_BLOCK_ROWS
        self.gram_aligned = False
        self.gram_chunk_iters = None
        #: the last statistics build, ``(X, y, gradient, block_rows,
        #: aligned)``, kept by identity so repeated calls on the same
        #: tensors never rebuild
        self._gram_entry = None
        #: ``set_streamed_stats`` and its build's chunk rows; the last
        #: streamed build, ``(X, y, gradient, knobs)``
        self.streamed_stats = False
        self.gram_batch_rows = None
        self._streamed_gram_entry = None
        #: the last per-rank statistics build on a data mesh, ``(X, y,
        #: mesh, gradient, block_rows, aligned)``
        self._gram_dp_entry = None
        #: the last meshed streamed statistics build, ``(X, y, mesh,
        #: (data, block_rows, rows, y), knobs)``
        self._streamed_gram_dp_entry = None
        # the observed (listener / checkpoint) planes
        self.listener = None
        self.checkpoint_manager = None
        self.checkpoint_every = 10
        self.superstep = 1
        self.resident_cadence = 0
        self._stop_signal = None
        #: host streaming (``set_host_streaming``) and the ingest knobs
        #: (``set_ingest_options``); the retry policy also heals the
        #: resident window hop
        self.host_streaming = False
        self.streaming_resident_rows = 0
        self.ingest_wire_dtype = None
        self.ingest_prefetch_depth = 2
        self.ingest_pipeline = True
        self.ingest_wire_compress = None
        self.ingest_retry_policy = None
        #: the last run's loop, ``(key, run)`` (``make_run`` or the
        #: chunked gram driver), and the observed driver's block runner,
        #: ``(key, runner)``: their CUDA graphs and buffers are reused by
        #: the next run on the same tensors, which they hold only weakly
        self._run_cache = None
        self._observed_entry = None
        #: the device mesh of ``set_mesh`` (None: one device)
        self.mesh = None
        #: the planner's bookkeeping (``tpu_sgd_torch/plan.py``): the knobs
        #: the USER set (a plan keeps them), the plan of the last planned
        #: run and its repeat-run key
        self._user_gram_opts = frozenset()
        self.last_plan = None
        self._plan_key = None

    # -- fluent config (returns self, like the reference's setters) --------
    def set_gradient(self, g: Gradient):
        self.gradient = g
        return self

    def set_updater(self, u: Updater):
        self.updater = u
        return self

    def set_step_size(self, s: float):
        self.config = self.config.replace(step_size=float(s))
        return self

    def set_num_iterations(self, n: int):
        if n < 1:
            raise ValueError(f"num_iterations must be positive, got {n}")
        self.config = self.config.replace(num_iterations=int(n))
        return self

    def set_reg_param(self, r: float):
        self.config = self.config.replace(reg_param=float(r))
        return self

    def set_mini_batch_fraction(self, f: float):
        if not 0.0 < f <= 1.0:
            raise ValueError("mini_batch_fraction must be in (0, 1]")
        self.config = self.config.replace(mini_batch_fraction=float(f))
        return self

    def set_convergence_tol(self, t: float):
        if not 0.0 <= t <= 1.0:
            raise ValueError("convergence_tol must be in [0, 1]")
        self.config = self.config.replace(convergence_tol=float(t))
        return self

    def set_seed(self, s: int):
        self.config = self.config.replace(seed=int(s))
        return self

    def set_sampling(self, mode: str):
        """'bernoulli', 'indexed' or 'sliced' (see ``SGDConfig.sampling``)."""
        self.config = self.config.replace(sampling=mode)
        return self

    def set_check_numerics(self, flag: bool = True):
        """Raise ``FloatingPointError`` when the loss goes non-finite."""
        self.check_numerics = bool(flag)
        return self

    # -- schedules ----------------------------------------------------------
    def set_mesh(self, mesh):
        """Train data-parallel over a ``parallel.Mesh`` (``None``: one
        device): ``X`` and ``y`` are this rank's local rows
        (``parallel.shard_dataset`` pads uneven counts with a valid
        mask), each rank samples its own shard, and the ranks combine
        every step's sums in rank order (``parallel.mesh.combine_sums``),
        so every rank holds the same weights and history.  Dense and
        sparse data, the unobserved run and the observed driver
        (listener, checkpoint: rank 0 writes it, then all ranks pass a
        barrier; ``set_superstep``; ``set_residency`` warns and runs the
        superstep driver), and least squares from per-rank statistics
        (``set_sufficient_stats``, ``parallel/gram_parallel.py``).  On a
        2-D ``(data, model)`` mesh (``make_mesh(n_data, n_model)``) each
        rank still passes its rows and the whole ``initial_weights``; it
        trains its block of the features (``parallel/model_parallel.py``)
        and returns the whole vector.  Host streaming and streamed
        statistics on a 1-D mesh take another rule: every rank passes the
        SAME whole host dataset (a file every rank maps, never a private
        copy) and streams its share (``optimize/streamed.py``,
        ``parallel/gram_parallel.py``); on a 2-D mesh they raise.

        Teardown: on NCCL the cached CUDA graphs hold the captured
        gather, so call :meth:`release_graphs` (or drop the optimizer)
        before ``torch.distributed.destroy_process_group``."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "set_mesh takes a tpu_sgd_torch.parallel.Mesh (make_mesh, "
                f"data_mesh, MeshConfig.build), got {type(mesh).__name__}")
        self.mesh = mesh
        return self

    def set_host_streaming(self, flag: bool = True, resident_rows: int = 0):
        """Keep the dataset in host memory and stream each iteration's
        sampled batch to the card (``optimize/streamed.py``; sparse X:
        ``optimize/streamed_sparse.py``): for data that does not fit, or
        does not stay, on the card.  The batch is drawn on the host with
        the JAX package's numpy rule, assembled into a pinned slot and
        copied on a side stream while the card runs the previous step.

        ``resident_rows``: rows ``[0, resident_rows)`` are placed on the
        card once, and a sliced window inside them is copied on the card
        instead of over PCIe (sliced sampling only); the window sequence,
        and so the result, is unchanged.  Knobs: ``set_ingest_options``,
        ``set_superstep``, ``set_residency``."""
        self._clear_planned_schedule()
        self.host_streaming = bool(flag)
        self.streaming_resident_rows = int(resident_rows)
        self._mark_manual_schedule()
        return self

    def _clear_planned_schedule(self):
        """A manual schedule setter taking over after a planned run: the
        previous plan's schedule flags and sizing knobs are the planner's,
        not the user's, so they go back to their defaults (user-set flags
        always come with ``last_plan is None``; user-set knobs stay)."""
        if self.last_plan is not None:
            self.host_streaming = False
            self.streaming_resident_rows = 0
            self.sufficient_stats = False
            self.streamed_stats = False
            from tpu_sgd_torch.plan import reset_plan_owned_gram_knobs

            reset_plan_owned_gram_knobs(self)

    def _mark_manual_schedule(self):
        """A schedule setter the user called: the planner's "manual flags
        win" rule keys on ``last_plan is None`` (``models/glm.py``), so
        clear it and the repeat-run key."""
        self.last_plan = None
        self._plan_key = None

    def set_sufficient_stats(self, flag: bool = True):
        """Run least squares from precomputed block-prefix Gram statistics
        (``ops/gram.py``): each sliced window or full batch becomes a
        difference of ``(d, d)`` prefix rows, one matvec and masked edge
        blocks instead of two passes over the sampled rows, with the same
        result up to summation order.

        Applies when the gradient is exactly ``LeastSquaresGradient``, the
        data dense, and the sampling ``sliced`` or full batch; any other
        combination runs unchanged.  The build is cached per ``(X, y)``
        tensor identity and RETAINED after ``optimize`` returns, which
        keeps the dataset and the prefix stack on the device until another
        dataset is passed, the optimizer is dropped, or
        :meth:`release_sufficient_stats` is called."""
        self._clear_planned_schedule()
        self.sufficient_stats = bool(flag)
        self._mark_manual_schedule()
        return self

    def set_gram_options(self, block_rows: int = None, aligned: bool = None,
                         batch_rows: int = None, chunk_iters: int = None):
        """Knobs of the sufficient-statistics schedule.  ``block_rows``
        trades prefix-stack memory (``n/B · d²`` entries) against
        per-iteration edge traffic; ``aligned=True`` floors window starts
        to block boundaries and skips the edge corrections (the floored
        windows of the tiled kernel: fine on shuffled rows, not on sorted
        data); ``chunk_iters=K`` sends block-aligned sliced runs through
        the chunked-gather driver (``optimize/gram_driver.py``), K windows
        gathered per outer step, with the same per-iteration contract.
        ``batch_rows`` caps the host->device chunk of the streamed build
        (``set_streamed_stats``; default 64 blocks).  The planner sets
        ``block_rows`` and ``batch_rows`` itself; a knob set here is the
        user's and every plan keeps it."""
        from tpu_sgd_torch.plan import apply_user_gram_knobs

        apply_user_gram_knobs(self, block_rows=block_rows, aligned=aligned,
                              batch_rows=batch_rows,
                              chunk_iters=chunk_iters)
        return self

    def release_sufficient_stats(self):
        """Drop the cached statistics bundle, so the bound dataset and its
        prefix stack can be freed; the next run rebuilds.  The cached
        loops and their CUDA graphs, which hold the bundle, go too."""
        self._gram_entry = None
        self._gram_dp_entry = None
        self._streamed_gram_entry = None
        self._streamed_gram_dp_entry = None
        return self.release_graphs()

    def release_graphs(self):
        """Drop the cached loops and the observed driver's block runner,
        with their CUDA graphs and buffers; the next run builds them
        again.  On an NCCL mesh call it before the process group is
        destroyed (``set_mesh``)."""
        self._run_cache = None
        self._observed_entry = None
        return self

    def set_streamed_stats(self, flag: bool = True, block_rows: int = None):
        """Least squares on host data too large for the card from
        statistics streamed once: one pass through the ingest pipeline
        builds the block-prefix stack on the card
        (``GramLeastSquaresGradient.build_streamed``; knobs
        ``set_gram_options(batch_rows=)``, ``set_ingest_options``), then
        every iteration runs from the statistics with no host transfer.
        Windows are block-ALIGNED (there are no rows for an exact edge) and
        the trailing ``n % block_rows`` rows are dropped: harmless on
        shuffled rows, not on sorted data (``set_host_streaming`` streams
        exact windows).  Applies to exactly ``LeastSquaresGradient`` on
        dense data with sliced or full-batch sampling, and raises
        otherwise; the build is cached per ``(X, y)`` identity."""
        if block_rows is not None and int(block_rows) < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._clear_planned_schedule()
        self.streamed_stats = bool(flag)
        if block_rows is not None:
            self.gram_block_rows = int(block_rows)
            self._user_gram_opts = self._user_gram_opts | {"block_rows"}
        self._mark_manual_schedule()
        return self

    def set_ingest_options(self, wire_dtype=None, prefetch_depth=None,
                           pipeline=None, retry=None, wire_compress=None):
        """Knobs of the host->device ingest pipeline (``tpu_sgd_torch/io``)
        of ``set_host_streaming``; every argument is validated before any
        is applied, and ``None`` leaves a knob as it is.

        ``wire_dtype="bfloat16"`` casts each batch on the host and moves
        half the bytes (``io/wire.py`` says when that is safe).
        ``prefetch_depth`` caps the batches staged at once, the one being
        consumed included (2 = double buffer; 0 or 1 assemble inline,
        bitwise the same run).  ``pipeline=False`` is the plain feed: no
        lookahead, no wire cast, no compression.  ``retry`` is a
        ``tpu_sgd_torch.reliability.RetryPolicy`` that re-runs a failed
        batch assembly or transfer (and the resident window hop); a
        healed run is bitwise the clean one; ``False`` clears it.
        ``wire_compress="topk:<frac>"``: the top-k error-feedback update
        (its accumulator is optimizer state, checkpointed as
        ``extras={"ef": ...}``); ``False`` clears it.  ``wire_dtype``,
        ``prefetch_depth`` and ``pipeline`` also drive the streamed build
        of ``set_streamed_stats``.  A knob set here is the user's and
        every plan keeps it."""
        from tpu_sgd_torch.plan import apply_user_ingest_options

        apply_user_ingest_options(self, wire_dtype=wire_dtype,
                                  prefetch_depth=prefetch_depth,
                                  pipeline=pipeline, retry=retry,
                                  wire_compress=wire_compress)
        return self

    def set_superstep(self, k: int):
        """Run ``k`` consecutive iterations per host interaction on the
        observed (listener / checkpoint) driver: one K-iteration block
        from device state, captured once as a CUDA graph on the card and
        replayed, its per-step ``(w, loss, reg, count, ‖Δw‖, ‖w‖)`` rows
        fetched once a block and replayed through the per-iteration
        bookkeeping (``_replay_fused_steps``).  History, listener events,
        convergence at the true iteration and checkpoints are bitwise
        those of ``k=1``; listener events arrive in bursts of ``k`` with
        averaged wall times, and a stop signal is polled at block
        boundaries (worst-case preemption latency ``k`` iterations; keep
        ``k`` at or below the checkpoint cadence).  ``k=1`` restores the
        per-iteration driver.  The unobserved run already goes in
        captured blocks (``RUN_BLOCK_ITERS``) and ignores it.  On the
        host-streamed feed (``set_host_streaming``) the worker stacks K
        batches into one superchunk slot and the card runs them as one
        captured block."""
        if int(k) < 1:
            raise ValueError(f"superstep must be >= 1, got {k}")
        self.superstep = int(k)
        self._user_gram_opts = self._user_gram_opts | {"superstep"}
        self._plan_key = None
        return self

    def set_residency(self, cadence: int = 8):
        """Hand the host a window of ``cadence`` blocks at a time on the
        observed driver: the ``cadence`` K-iteration graph replays are
        queued back to back, their ys rows collected in a device ring,
        and one copy to pinned host memory goes out at the window's end;
        the host then replays the window's rows through the same
        bookkeeping (``optimize/resident_driver.py``), so history, events,
        convergence and checkpoints are bitwise the superstep driver's.
        Requires ``set_superstep(K >= 2)``.  Stop signals are polled once
        a window, so worst-case preemption latency grows to ``cadence *
        K`` iterations.  ``cadence=0`` restores the per-block driver; a
        window of ONE block is the superstep driver already, so
        ``cadence=1`` is rejected.  On the host-streamed feed it applies,
        as in the JAX package, to the full-batch and fully-resident
        feeds; a host-sampled feed warns and runs the superstep driver."""
        c = int(cadence)
        if c == 1:
            raise ValueError(
                "residency cadence 1 is the per-superstep driver "
                "(set_superstep); use cadence >= 2 or 0 to disable")
        if c < 0:
            raise ValueError(f"cadence must be >= 0, got {cadence}")
        self.resident_cadence = c
        self._user_gram_opts = self._user_gram_opts | {"residency"}
        self._plan_key = None
        return self

    def set_listener(self, listener):
        """Attach an ``SGDListener`` (``tpu_sgd_torch.utils.events``):
        ``optimize`` then takes the observed driver, with host-visible
        loss and timing events each iteration."""
        self.listener = listener
        return self

    def set_checkpoint(self, manager, every: int = 10):
        """Attach a ``CheckpointManager``; optimizer state is saved every
        ``every`` iterations and ``optimize`` resumes from the latest
        checkpoint when one exists (the JAX package's format: either
        package restores the other's)."""
        self.checkpoint_manager = manager
        self.checkpoint_every = int(every)
        return self

    def set_stop_signal(self, stop_signal):
        """Install a zero-arg callable polled on the observed driver: once
        an iteration (K = 1), at each block boundary (``set_superstep``)
        or at each window boundary (``set_residency``).  When it returns
        True the current state is checkpointed (if a manager is attached)
        and the run unwinds with ``TrainingPreempted``; on a mesh, when it
        returns True on any rank, every rank stops there.  Pass ``None`` to
        clear.  Installed by ``TrainingSupervisor``; the unobserved run
        (no listener or checkpoint) does not poll it and runs to
        completion."""
        self._stop_signal = stop_signal
        return self

    # -- optimization ------------------------------------------------------
    @property
    def loss_history(self):
        """Stochastic loss history of the last ``optimize`` call (np array)."""
        return self._loss_history

    def optimize(self, data: Dataset, initial_weights) -> Tensor:
        w, _ = self.optimize_with_history(data, initial_weights)
        return w

    def optimize_with_history(self, data: Dataset, initial_weights):
        """``(weights, loss_history)``: weights a float32 tensor on the
        run's device, the history a numpy array.  ``X`` may be a
        ``GramData`` bundle (with a ``GramLeastSquaresGradient``)."""
        X, y = data
        dev = resolve_device(self.device)
        mesh = self._data_mesh(X, dev)
        if isinstance(X, GramData):
            if self.host_streaming:
                raise NotImplementedError(
                    "GramData input supports the resident path (the "
                    "statistics are already on the device); drop "
                    "set_host_streaming")
            return self._optimize_gram_data(X, y, initial_weights, dev)
        if self.streamed_stats:
            # before any device conversion: the rows never live on the card
            cfg = self.config
            if cfg.mini_batch_fraction < 1.0 and cfg.sampling != "sliced":
                raise NotImplementedError(
                    "streamed statistics support sliced sampling or full "
                    f"batch (got sampling={cfg.sampling!r}); use "
                    "set_host_streaming for bernoulli or indexed sampling")
            if mesh is not None:
                _streamed_stats_guards(self, X)
                # this route returns before _run_meshed's warning would
                # fire: the dropped chunk_iters must not go silent
                self._warn_chunk_iters_with_mesh(stacklevel=3)
                return self._optimize_streamed_stats_mesh(
                    X, y, initial_weights, dev, mesh)
            gram = _streamed_gram(self, X, y)
            orig, self.gradient = self.gradient, gram
            try:
                return self.optimize_with_history(
                    (gram.data, y[:gram.data.shape[0]]), initial_weights)
            finally:
                self.gradient = orig
        if self.host_streaming:
            # before any device conversion: X never lives on the card whole
            return self._optimize_host_streamed(X, y, initial_weights, dev,
                                                mesh)
        X = as_tensor(X, dev)
        sparse_X = is_sparse(X)
        if sparse_X:
            if (self.config.sampling != "bernoulli"
                    and self.config.mini_batch_fraction < 1.0):
                raise NotImplementedError(
                    "sparse features support bernoulli sampling only "
                    f"(got sampling={self.config.sampling!r})"
                )
            X = to_csr(X)
        if not X.dtype.is_floating_point or X.dtype == torch.float64:
            # int/bool features (one-hot) and f64 arrays train in f32, as
            # the JAX package does with x64 off
            X = X.to(torch.float32)
        if not sparse_X:
            X = X.contiguous()
        y = as_tensor(y, dev, torch.float32)
        w0 = _coerce_w0(self.gradient, initial_weights, X.shape[1], dev)
        if mesh is not None:
            # every rank pads to the longest rank's rows, so the checks
            # below decide alike on every rank
            return self._run_meshed(mesh, X, y, w0, sparse_X)
        n = X.shape[0]
        if n == 0:
            self._loss_history = np.zeros((0,), np.float32)
            return w0, self._loss_history
        if n * self.config.mini_batch_fraction < 1:
            warnings.warn(
                "The miniBatchFraction is too small", RuntimeWarning,
                stacklevel=2,
            )
        gram = self._maybe_gram(X, y, sparse_X)
        if gram is not None:
            # the statistics ride where X goes (GramData)
            return self._run(gram, gram.data, y, w0)
        return self._run(self.gradient, X, y, w0)

    def _data_mesh(self, X, dev):
        """The mesh of this run (a data mesh, or a 2-D ``(data, model)``
        mesh), or None.  Raises where the JAX package refuses a mesh,
        with its message: the streamed routes on a 2-D mesh, and sparse
        host streaming on any mesh."""
        if self.mesh is None:
            return None
        two_d = has_model_axis(self.mesh)
        if isinstance(X, GramData):
            raise NotImplementedError(
                "GramData input supports the single-device resident path "
                "(stats are already on device); drop set_mesh/"
                "set_host_streaming")
        if self.streamed_stats and two_d:
            raise NotImplementedError(
                "streamed statistics compose with a 1-D 'data' mesh; "
                "feature-axis ('model') sharding needs resident column "
                "blocks")
        if self.host_streaming:
            if two_d:
                raise NotImplementedError(
                    "host streaming supports 1-D data meshes; feature-axis "
                    "('model') sharding needs the resident path")
            if is_sparse(X):
                raise NotImplementedError(
                    "host-streamed sparse training is single-device (shard "
                    "the resident sparse path with set_mesh instead)")
        mesh = self.mesh if two_d else as_data_mesh(self.mesh)
        if self.host_streaming or self.streamed_stats:
            require_single_host(mesh, "streamed SGD batches"
                                if self.host_streaming
                                else "streamed statistics")
        if mesh.backend == "nccl" and dev.type != "cuda":
            raise ValueError(
                f"an NCCL mesh combines on the card; this optimizer runs "
                f"on {dev} (use a gloo group for CPU ranks)")
        return mesh

    def _warn_chunk_iters_with_mesh(self, stacklevel: int = 3) -> None:
        """One warning for every route that drops an explicit
        ``chunk_iters`` because a mesh is set: the meshed runs keep the
        per-iteration driver."""
        if self.gram_chunk_iters and self.mesh is not None:
            warnings.warn(
                "chunk_iters applies to the single-device aligned-gram "
                "driver only; the meshed gram runners keep the "
                "per-iteration driver (drop set_mesh to use the chunked "
                "driver)",
                RuntimeWarning, stacklevel=stacklevel,
            )

    def _run_meshed(self, mesh, X, y, w0, sparse_X):
        """A data-parallel run on this rank's local rows: padded to the
        longest rank's (``parallel.shard_dataset`` / ``shard_csr``),
        then the run or the observed driver with the mesh's combine;
        least squares from per-rank statistics where
        ``set_sufficient_stats`` applies (``_maybe_gram_dp``).  A 2-D mesh
        goes to :meth:`_run_model_sharded`."""
        from tpu_sgd_torch.parallel.data_parallel import shard_dataset
        from tpu_sgd_torch.parallel.sparse_parallel import shard_csr

        self._warn_chunk_iters_with_mesh(stacklevel=4)
        if has_model_axis(mesh):
            return self._run_model_sharded(mesh, X, y, w0, sparse_X)
        Xt = None
        X_in, y_in = X, y
        if sparse_X:
            X, Xt, y, valid = shard_csr(mesh, X, y, device=w0.device)
        else:
            X, y, valid = shard_dataset(mesh, X, y, device=w0.device)
        if X.shape[0] == 0:
            self._loss_history = np.zeros((0,), np.float32)
            return w0, self._loss_history
        if X.shape[0] * mesh.size * self.config.mini_batch_fraction < 1:
            warnings.warn(
                "The miniBatchFraction is too small", RuntimeWarning,
                stacklevel=3,
            )
        observed = (self.listener is not None
                    or self.checkpoint_manager is not None)
        if observed and self.sufficient_stats and not sparse_X:
            warnings.warn(
                "sufficient_stats is not applied on the meshed "
                "listener/checkpoint path (the observed per-iteration "
                "stepper uses the stock DP step); detach the listener "
                "or run single-device to combine them",
                RuntimeWarning, stacklevel=3,
            )
        elif not sparse_X:
            gram = self._maybe_gram_dp(X_in, y_in, X, y, valid, mesh)
            if gram is not None:
                # each rank's statistics ride where its rows go
                return self._run(gram, gram.data, y, w0, None, None, mesh)
        return self._run(self.gradient, X, y, w0, valid, Xt, mesh)

    def _maybe_gram_dp(self, X, y, Xs, ys, valid, mesh):
        """The sufficient-statistics substitution on a data mesh
        (``parallel/gram_parallel.py``): this rank's block-prefix
        statistics of its own rows, cached by ``(X, y, mesh)`` identity
        and the gram knobs; None where it does not apply.  Padded ranks
        (a ``valid`` mask, agreed by every rank) run the stock meshed
        path, as in the JAX package: a statistics window is normalized by
        its full length, the stock path by its realized valid count."""
        from tpu_sgd_torch.parallel.gram_parallel import (
            build_sharded_gram_stats,
        )

        cfg = self.config
        if (not self.sufficient_stats or valid is not None
                or type(self.gradient) is not LeastSquaresGradient
                or (cfg.mini_batch_fraction < 1.0
                    and cfg.sampling != "sliced")):
            return None
        opts = (self.gram_block_rows, self.gram_aligned)
        entry = self._gram_dp_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[2] is self.mesh and entry[4:] == opts):
            return entry[3]
        self._gram_dp_entry = None  # free the superseded stack first
        gram = build_sharded_gram_stats(mesh, Xs, ys,
                                        block_rows=self.gram_block_rows,
                                        aligned=self.gram_aligned)
        self._gram_dp_entry = (X, y, self.mesh, gram) + opts
        return gram

    def _run_model_sharded(self, mesh, X, y, w0, sparse_X):
        """A run on a 2-D ``(data, model)`` mesh
        (``parallel/model_parallel.py``): X and y are this rank's rows, as
        on a data mesh, and ``w0`` the whole weight vector; the rank keeps
        its block of the (zero-padded) features, and every rank gets the
        whole trained vector back.  Refuses what the JAX package refuses
        on such a mesh, with its message."""
        from tpu_sgd_torch.parallel.model_parallel import dp_mp_optimize

        if sparse_X:
            raise NotImplementedError(
                "feature-axis ('model') sharding needs dense column "
                "blocks; sparse features support 1-D 'data' meshes")
        if self.gradient.weight_dim(X.shape[1]) != X.shape[1]:
            raise NotImplementedError(
                "feature-axis ('model') sharding supports vector-weight "
                "gradients only; matrix-weight gradients (multinomial) "
                "need a 1-D 'data' mesh")
        if self.listener is not None or self.checkpoint_manager is not None:
            raise NotImplementedError(
                "listener/checkpoint mode supports single-device and 1-D "
                "data meshes")
        w, losses, n_rec = dp_mp_optimize(
            self.gradient, self.updater, self.config, mesh, w0, X, y,
            device=w0.device,
            run_for=lambda Xb: self._cached_run(self.gradient, Xb, mesh))
        self._loss_history = losses[:int(n_rec)].cpu().numpy()
        if self.check_numerics:
            _raise_if_nonfinite(self._loss_history)
        return w, self._loss_history

    def _optimize_host_streamed(self, X, y, initial_weights, dev,
                                mesh=None):
        """``set_host_streaming``: the dense streamed driver
        (``optimize/streamed.py``, on ``mesh`` too: every rank passes the
        same whole host dataset and streams its share of each batch) or,
        for sparse X, the sparse one (``optimize/streamed_sparse.py``, one
        device), with this optimizer's knobs.  ``pipeline=False`` is the
        plain feed: no lookahead, no wire cast, no compression (the
        bitwise A/B reference)."""
        from tpu_sgd_torch.optimize.streamed import optimize_host_streamed

        knobs = dict(
            listener=self.listener,
            checkpoint_manager=self.checkpoint_manager,
            checkpoint_every=self.checkpoint_every,
            prefetch_depth=(self.ingest_prefetch_depth
                            if self.ingest_pipeline else 0),
            retry_policy=self.ingest_retry_policy,
            stop_signal=self._stop_signal,
            superstep_k=self.superstep,
            resident_cadence=self.resident_cadence,
            wire_compress=(self.ingest_wire_compress
                           if self.ingest_pipeline else None),
            check_numerics=self.check_numerics)
        if is_sparse(X):
            from tpu_sgd_torch.optimize.streamed_sparse import (
                optimize_host_streamed_sparse,
            )

            if self.ingest_wire_dtype is not None:
                warnings.warn(
                    "wire_dtype applies to dense row chunks; the sparse feed "
                    "ships CSR components at the data dtype (its "
                    "compression is the sparsity itself)",
                    RuntimeWarning, stacklevel=3)
            if self.streaming_resident_rows:
                raise NotImplementedError(
                    "resident_rows needs sliced windows, which need a dense "
                    "row layout; sparse features stream bernoulli batches")
            w, hist = optimize_host_streamed_sparse(
                self.gradient, self.updater, self.config, X, y,
                initial_weights, device=dev, **knobs)
        else:
            w, hist = optimize_host_streamed(
                self.gradient, self.updater, self.config, X, y,
                initial_weights, device=dev, mesh=mesh,
                resident_rows=self.streaming_resident_rows,
                wire_dtype=(self.ingest_wire_dtype
                            if self.ingest_pipeline else None), **knobs)
        self._loss_history = hist
        if self.check_numerics:
            _raise_if_nonfinite(hist)
        return w, hist

    def _optimize_streamed_stats_mesh(self, X, y, initial_weights, dev,
                                      mesh):
        """Meshed ``set_streamed_stats`` (``parallel/gram_parallel.py``):
        every rank passes the same whole host dataset, streams its slice
        of rows into its own virtual block-prefix statistics, and runs the
        meshed loop over them (``dp_virtual_gram_run_fn``), so no row
        lives on a card.  The build is cached by ``(X, y, mesh)`` identity
        and the gram and ingest knobs; a listener or a checkpoint manager
        is not applied here (warned), as in the JAX package."""
        from tpu_sgd_torch.parallel.gram_parallel import (
            build_streamed_sharded_gram_stats,
            dp_virtual_gram_run_fn,
        )

        if self.listener is not None or self.checkpoint_manager is not None:
            warnings.warn(
                "listener/checkpoint callbacks are not applied on the "
                "meshed streamed-statistics path (the virtual loop has no "
                "per-iteration host hop); detach them or run single-device "
                "to combine",
                RuntimeWarning, stacklevel=3,
            )
        opts = (self.gram_block_rows, self.gram_batch_rows,
                self.ingest_wire_dtype, self.ingest_prefetch_depth,
                self.ingest_pipeline, dev)
        entry = self._streamed_gram_dp_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[2] is self.mesh and entry[4] == opts):
            data, B, n_used, yd = entry[3]
        else:
            self._streamed_gram_dp_entry = None  # free the old stack first
            data, B, n_used = build_streamed_sharded_gram_stats(
                mesh, X, y, block_rows=self.gram_block_rows,
                batch_rows=self.gram_batch_rows,
                wire_dtype=self.ingest_wire_dtype,
                prefetch_depth=self.ingest_prefetch_depth,
                pipeline=self.ingest_pipeline, device=dev)
            # the labels ride for shape only: the virtual windows never
            # read them
            s = mesh.rank * (X.shape[0] // mesh.size)
            yd = as_tensor(y, torch.device("cpu"), torch.float32)[
                s:s + n_used].to(dev)
            self._streamed_gram_dp_entry = (X, y, self.mesh,
                                            (data, B, n_used, yd), opts)
        d = data.shape[1]
        w0 = _coerce_w0(self.gradient, initial_weights, d, dev)
        key = ("virtual_gram_dp_run", self.updater, self.config, self.mesh,
               B, n_used, d, str(data.dtype))
        cached = self._run_cache
        if cached is not None and cached[0] == key:
            run = cached[1]
        else:
            self._run_cache = None
            run = dp_virtual_gram_run_fn(self.updater, self.config, mesh, B,
                                         n_used, d, str(data.dtype))
            self._run_cache = (key, run)
        w, losses, n_rec = run(w0, yd, data)
        self._loss_history = losses[:int(n_rec)].cpu().numpy()
        if self.check_numerics:
            _raise_if_nonfinite(self._loss_history)
        return w, self._loss_history

    def _optimize_gram_data(self, X: GramData, y, initial_weights, dev):
        """Statistics-first input (``GramLeastSquaresGradient.build`` or
        ``GramData.load``): the rows may be virtual, so only y and the
        weights are coerced."""
        if not isinstance(self.gradient, GramLeastSquaresGradient):
            raise ValueError(
                "GramData input needs a GramLeastSquaresGradient (use "
                "GramLeastSquaresGradient.build and pass it as the "
                "gradient)")
        cfg = self.config
        if cfg.mini_batch_fraction < 1.0 and cfg.sampling != "sliced":
            raise NotImplementedError(
                "GramData input supports sliced sampling or full batch "
                f"(got sampling={cfg.sampling!r})")
        if (cfg.mini_batch_fraction < 1.0 and X.X is None
                and X.PG.shape[0] <= 2):
            # a single-block virtual stack (a totals-only bundle) cannot
            # express sub-batch windows: every window IS the full batch
            warnings.warn(
                "these virtual statistics hold a single block, so sliced "
                f"windows at frac={cfg.mini_batch_fraction} degenerate to "
                "FULL-BATCH iterations; rebuild with a smaller block_rows "
                "for true mini-batch sampling",
                RuntimeWarning, stacklevel=3,
            )
        if X.device.type != dev.type:
            raise ValueError(
                f"the GramData lies on {X.device}, and this optimizer runs "
                f"on {dev}")
        y = as_tensor(y, X.device, torch.float32)
        w0 = _coerce_w0(self.gradient, initial_weights, X.shape[1],
                        X.device)
        return self._run(self.gradient, X, y, w0)

    def _run(self, gradient, X, y, w0, valid=None, Xt=None, mesh=None):
        """One run: the observed driver when a listener or a checkpoint
        manager is attached, else the loop (the chunked gram driver where
        it applies), then the history read back once.  ``valid``, ``Xt``
        and ``mesh`` come from a meshed run (``_run_meshed``)."""
        if self.listener is not None or self.checkpoint_manager is not None:
            if self.gram_chunk_iters:
                warnings.warn(
                    "chunk_iters is ignored on the observed "
                    "(listener/checkpoint) path: chunking amortizes the "
                    "per-iteration host hop that listeners exist to "
                    "provide; detach the listener to use the chunked "
                    "driver",
                    RuntimeWarning, stacklevel=3,
                )
            return self._optimize_stepwise(gradient, X, y, w0, valid, Xt,
                                           mesh)
        run = self._cached_run(gradient, X, mesh)
        if mesh is None:  # the chunked gram driver takes (w0, X, y)
            w, losses, n_rec = run(w0, X, y)
        else:
            w, losses, n_rec = run(w0, X, y, valid, Xt)
        self._loss_history = losses[:int(n_rec)].cpu().numpy()
        if self.check_numerics:
            _raise_if_nonfinite(self._loss_history)
        return w, self._loss_history

    def _cached_run(self, gradient, X, mesh=None):
        """The loop of this run, the previous run's when its knobs are the
        same, so that its CUDA graph replays at once on the same tensors
        (it keeps its graph and state buffers until the next run with
        other tensors or knobs, or ``release_sufficient_stats``; the run's
        tensors it holds only weakly)."""
        chunked = mesh is None and self._chunked_gram_applies(gradient, X)
        key = (gradient, self.updater, self.config,
               self.gram_chunk_iters if chunked else None,
               X.block_rows if chunked else None,
               X.shape[0] if chunked else None, self.mesh)
        entry = self._run_cache
        if entry is not None and entry[0][0] is gradient \
                and entry[0][1] is self.updater and entry[0][2:] == key[2:]:
            return entry[1]
        self._run_cache = None  # free the superseded graph first
        if chunked:
            from tpu_sgd_torch.optimize import gram_driver

            run = gram_driver.make_chunked_gram_run(
                self.updater, self.config, n=X.shape[0],
                block_rows=X.block_rows, chunk_iters=self.gram_chunk_iters)
        else:
            run = make_run(gradient, self.updater, self.config, mesh)
        self._run_cache = (key, run)
        return run

    def _maybe_gram(self, X, y, sparse_X):
        """The sufficient-statistics gradient when it applies (see
        ``set_sufficient_stats``), cached by ``(X, y)`` identity; None
        otherwise."""
        cfg = self.config
        if sparse_X or (cfg.mini_batch_fraction < 1.0
                        and cfg.sampling != "sliced"):
            return None
        g = self.gradient
        if (isinstance(g, GramLeastSquaresGradient) and g.data is not None
                and g.data.X is X):
            # a user-built gram gradient on exactly this matrix
            return g
        if not self.sufficient_stats or type(g) is not LeastSquaresGradient:
            return None
        opts = (self.gram_block_rows, self.gram_aligned)
        entry = self._gram_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[3:] == opts):
            return entry[2]
        self._gram_entry = None  # free the superseded stack first
        g = GramLeastSquaresGradient.build(
            X, y, block_rows=self.gram_block_rows, aligned=self.gram_aligned,
            device=X.device)
        self._gram_entry = (X, y, g) + opts
        return g

    def _chunked_gram_applies(self, gradient, X) -> bool:
        """Whether the chunked-gather driver runs: ``chunk_iters`` is set
        and this run has block-ALIGNED statistics windows (virtual
        statistics, or a gradient in aligned mode: the gradient's own
        mode, not the optimizer's knob, so a prebuilt exact gradient keeps
        its exact windows)."""
        cfg = self.config
        return bool(self.gram_chunk_iters
                    and isinstance(X, GramData)
                    and isinstance(gradient, GramLeastSquaresGradient)
                    and (X.X is None or gradient.aligned)
                    and cfg.sampling == "sliced"
                    and cfg.mini_batch_fraction < 1.0)

    # -- the observed driver ---------------------------------------------------
    def _observed_runner(self, gradient, X, y, w0, k: int, valid=None,
                         Xt=None, mesh=None) -> _BlockRunner:
        """The observed driver's block runner (K-row ys), cached like the
        loop's by the identity of its tensors and knobs."""
        cfg = self.config
        key = (gradient, self.updater, cfg, k, self.mesh)
        entry = self._observed_entry
        if (entry is not None and entry[0][0] is gradient
                and entry[0][1] is self.updater and entry[0][2:] == key[2:]
                and entry[1].same_data(X, y, valid, Xt, w0)):
            return entry[1]
        self._observed_entry = None  # free the superseded graph first
        own = transpose_csr(X) if Xt is None and is_sparse(X) else None
        runner = _BlockRunner(
            _make_block(gradient, self.updater, cfg, history=False,
                        mesh=mesh),
            _RunState(w0, cfg.num_iterations, ys_rows=k),
            (X, y, valid, Xt), _make_sampler(cfg, X, _shard_of(mesh)), k,
            _captures(gradient, cfg, w0.device, mesh), adaptive=False,
            owned=own)
        self._observed_entry = (key, runner)
        return runner

    def _optimize_stepwise(self, gradient, X, y, w0, valid=None, Xt=None,
                           mesh=None):
        """The observed driver, used when a listener or a checkpoint
        manager is attached: the JAX package's ``_optimize_stepwise`` on
        one device, with the exact loss history and convergence semantics
        of the loop (the same iteration math).

        K = 1: one eager step an iteration, then ``observed_loop_tail``.
        K >= 2 (``set_superstep``): the K-iteration block, replayed from
        its CUDA graph on the card, its ys rows fetched once a block and
        replayed through ``_replay_fused_steps``; a stop signal is polled
        at the block boundary.  K >= 2 with C >= 2 (``set_residency``):
        windows of C blocks, ``optimize/resident_driver.py``.  The three
        give the same history, events (but their wall times) and
        checkpoints, bitwise.

        On a mesh every rank runs the driver and calls its own listener;
        rank 0 alone writes a checkpoint, then all ranks pass a host
        barrier, and all ranks read it on resume.  The ranks agree on
        each stop poll (any rank's signal stops every rank), so they
        stop at the same iteration; a rank with no stop signal polls as
        False."""
        from tpu_sgd_torch.utils.events import RunEvent

        cfg = self.config
        dev = w0.device
        _, reg0 = self.updater.compute(w0, torch.zeros_like(w0), 0.0, 1,
                                       cfg.reg_param)
        reg_val = float(reg0)
        losses = []
        start_iter = 1
        config_key = repr((type(gradient).__name__,
                           type(self.updater).__name__, cfg))
        mgr = self.checkpoint_manager
        if mgr is not None:
            state = mgr.restore()
            if state is not None:
                if state["config_key"] and state["config_key"] != config_key:
                    warnings.warn(
                        "checkpoint config differs from current config; "
                        "resuming anyway",
                        RuntimeWarning,
                        stacklevel=4,
                    )
                w0 = as_tensor(np.asarray(state["weights"]), dev,
                               torch.float32)
                reg_val = state["reg_val"]
                losses = list(np.asarray(state["loss_history"], np.float32))
                start_iter = state["iteration"] + 1
        if self.listener is not None:
            self.listener.on_run_start(cfg)

        fused_k = int(self.superstep or 1)
        resident_c = int(self.resident_cadence or 0)
        if resident_c >= 2 and fused_k > 1 and mesh is not None:
            warnings.warn(
                "set_residency is single-device (io_callback cadence "
                "hooks do not ride shard_map); the meshed observed "
                "path runs the fused superstep driver",
                RuntimeWarning, stacklevel=4,
            )
            resident_c = 0
        if resident_c >= 2 and fused_k <= 1:
            warnings.warn(
                "set_residency rides the fused superstep executor; "
                "call set_superstep(K >= 2) to engage the device-resident "
                "driver",
                RuntimeWarning, stacklevel=4,
            )
            resident_c = 0

        def _save(ii, w_np, rv):
            if mesh is None or mesh.rank == 0:
                mgr.save(ii, np.asarray(w_np), rv, np.asarray(losses),
                         config_key)
            if mesh is not None:
                barrier(mesh, dev)

        save_cb = _save if mgr is not None else None
        stop = self._agreed_stop(mesh, dev)
        runner = None
        if fused_k > 1 and start_iter <= cfg.num_iterations:
            runner = self._observed_runner(gradient, X, y, w0, fused_k,
                                           valid, Xt, mesh)
            runner.state.reset(w0, reg_val, start_iter)
            runner.begin(X, y, valid, Xt, cfg.num_iterations)
        w = w0
        t_run = time.perf_counter()
        converged_early = False
        try:
            w, reg_val, converged_early = self._observed_route(
                gradient, runner, (X, y, valid, Xt, mesh), w0, start_iter,
                losses, reg_val, save_cb, fused_k, resident_c, stop)
        finally:
            if runner is not None:
                runner.end()

        if self.listener is not None:
            self.listener.on_run_end(
                RunEvent(
                    event="run_completed",
                    num_iterations=len(losses),
                    final_loss=losses[-1] if losses else None,
                    converged_early=converged_early,
                    wall_time_s=time.perf_counter() - t_run,
                )
            )
        self._loss_history = np.asarray(losses, np.float32)
        return w, self._loss_history

    def _agreed_stop(self, mesh, dev):
        """The stop poll of the observed driver: the stop signal itself
        on one device; on a mesh, every rank's answer gathered so that
        all stop together (:func:`parallel.mesh.any_rank`), polled by
        every rank when any rank has a signal (agreed once here, so the
        ranks' collectives pair).  ``None``: nothing to poll."""
        return agreed_stop(mesh, self._stop_signal, dev)

    def _observed_route(self, gradient, runner, data, w0, start_iter, losses,
                        reg_val, save_cb, fused_k, resident_c, stop):
        """The observed run from ``start_iter`` on its route (K = 1, K >= 2,
        or windows of C blocks): ``(weights, reg_val, converged)``;
        ``data`` is ``(X, y, valid, Xt, mesh)``; ``stop`` is the stop
        poll (``_agreed_stop``)."""
        cfg = self.config
        w, converged_early = w0, False
        if start_iter > cfg.num_iterations:
            pass  # the checkpoint holds the finished run
        elif fused_k > 1 and resident_c >= 2:
            # windows of C captured blocks (optimize/resident_driver.py);
            # the ring rows replay through the same _replay_fused_steps,
            # so history, events, convergence and checkpoints are the
            # superstep driver's, bitwise
            from tpu_sgd_torch.optimize.resident_driver import (
                ResidentBookkeeper,
                ResidentLoop,
            )

            hooks = ResidentBookkeeper(
                cfg, fused_k, resident_c, losses=losses,
                reg_val=reg_val, start_iter=start_iter,
                listener=self.listener, save_cb=save_cb,
                save_every=self.checkpoint_every,
                stop_signal=stop,
                retry_policy=self.ingest_retry_policy,
                check_numerics=self.check_numerics)
            loop = ResidentLoop(runner, cfg, fused_k, resident_c)
            w_np, converged_early = loop.run(start_iter, hooks)
            w = as_tensor(w_np, w0.device, torch.float32)
            reg_val = hooks.reg_val
        elif fused_k > 1:
            w, reg_val, converged_early = self._observed_blocks(
                runner, start_iter, losses, reg_val, save_cb, stop)
        else:
            w, reg_val, converged_early = self._observed_steps(
                gradient, data, w0, start_iter, losses, reg_val, save_cb,
                stop)
        return w, reg_val, converged_early

    def _observed_blocks(self, runner, i0, losses, reg_val, save_cb, stop):
        """K iterations per block, replayed from the captured graph on
        the card; the block's ys rows are fetched once and replayed with
        the per-iteration bookkeeping."""
        cfg, K, st = self.config, runner.k, runner.state
        host = _pinned_like(st.ys)
        w, converged = st.w, False
        while i0 <= cfg.num_iterations and not converged:
            steps = min(K, cfg.num_iterations - i0 + 1)
            t0 = time.perf_counter()
            # the span times replay -> rows on the host; the fetch is this
            # driver's own boundary
            with span("train.superstep", i0=i0, steps=steps):
                runner.run(i0, steps)
                rows = _fetch_rows(st.ys, steps, host)
            ys_host = st.ys_leaves(rows)
            dt = time.perf_counter() - t0
            t_last, reg_val, converged = _replay_fused_steps(
                ys_host, i0, steps, losses, reg_val, cfg,
                listener=self.listener, wall_dt=dt / steps,
                check_numerics=self.check_numerics,
                save_cb=save_cb, save_every=self.checkpoint_every,
            )
            if converged or steps < K:
                # the run ends inside the block: the true last
                # iteration's state rides the rows
                w = as_tensor(ys_host[0][t_last], st.w.device,
                              torch.float32)
            else:
                w = st.w.clone()
            if not converged and stop is not None and stop():
                # cooperative preemption at the block BOUNDARY (a replay
                # cannot stop mid-block): checkpoint the exact boundary
                # iteration, then unwind; a resume replays from here
                from tpu_sgd_torch.reliability.supervisor import (
                    TrainingPreempted,
                )

                boundary = i0 + steps - 1
                if save_cb is not None:
                    save_cb(boundary, _host(w), reg_val)
                raise TrainingPreempted(boundary)
            i0 += steps
        return w, reg_val, converged

    def _observed_steps(self, gradient, data, w0, i, losses, reg_val,
                        save_cb, stop):
        """One eager step an iteration, then its host tail
        (``observed_loop_tail``): the per-iteration observed driver."""
        cfg = self.config
        X, y, valid, Xt, mesh = data
        update = _make_update(gradient, self.updater, cfg, mesh)
        if Xt is None and is_sparse(X):
            Xt = transpose_csr(X)
        sampler = _make_sampler(cfg, X, _shard_of(mesh))
        w = w0.clone()
        reg = torch.full((), float(reg_val), dtype=torch.float32,
                         device=w0.device)
        converged = False
        while i <= cfg.num_iterations:
            t0 = time.perf_counter()
            with span("train.step", i=i):
                it = torch.full((1,), i, dtype=torch.int64, device=w.device)
                sample = None
                if sampler is not None:
                    sampler.seek(i)
                    sample = sampler.draw()
                new_w, loss_i, new_reg, c = update(w, X, y, it, reg, sample,
                                                   valid, Xt)
                # the observed driver's host hop IS its contract: one
                # barrier a step, then each scalar fetched once
                if new_w.is_cuda:
                    # graftlint: disable=host-sync -- observed driver: a per-step barrier is its contract
                    torch.cuda.synchronize(new_w.device)
            dt = time.perf_counter() - t0
            # graftlint: disable=host-sync -- observed driver: a per-step barrier is its contract
            w, reg_val, converged = observed_loop_tail(
                i, w, new_w, loss_i.to(torch.float32), new_reg, c, losses,
                reg_val, cfg, listener=self.listener, wall_dt=dt,
                save_cb=save_cb, save_every=self.checkpoint_every,
                stop_signal=stop, check_numerics=self.check_numerics)
            reg = new_reg  # the empty-batch rule already kept the old one
            if converged:
                break
            i += 1
        return w, reg_val, converged




def run_mini_batch_sgd(
    data: Dataset,
    gradient: Gradient,
    updater: Updater,
    step_size: float,
    num_iterations: int,
    reg_param: float,
    mini_batch_fraction: float,
    initial_weights,
    convergence_tol: float = 0.001,
    seed: int = 42,
    mesh=None,
    sampling: str = None,
    sufficient_stats: bool = False,
    device=None,
) -> Tuple[Tensor, np.ndarray]:
    """Functional entry point, signature parity with the reference's
    ``GradientDescent.runMiniBatchSGD``.  Returns ``(weights,
    loss_history)``."""
    opt = GradientDescent(
        gradient,
        updater,
        SGDConfig(
            step_size=step_size,
            num_iterations=num_iterations,
            reg_param=reg_param,
            mini_batch_fraction=mini_batch_fraction,
            convergence_tol=convergence_tol,
            seed=seed,
        ),
        device=device,
    )
    if mesh is not None:
        opt.set_mesh(mesh)
    if sampling is not None:
        opt.set_sampling(sampling)
    if sufficient_stats:
        opt.set_sufficient_stats(True)
    return opt.optimize_with_history(data, initial_weights)
