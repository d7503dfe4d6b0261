"""L-BFGS: the port of ``tpu_sgd/optimize/lbfgs.py`` (device-resident data,
one device).

The reference's ``LBFGS(gradient, updater)``: the full-batch cost
``loss_sum / n + regVal(w)`` with the regularization term and its gradient
taken from the updater family, the ``num_corrections`` two-loop
recursion, a backtracking Armijo line search, and a stop on relative loss
improvement; the loss history comes back with the weights.

The cost is one ``Gradient.batch_sums`` call: for the built-in binary
families on dense X, one launch of the fused CUDA kernel
(``ops/cuda_kernels.py``) per evaluation.  The whole backtracking ladder
is one ``Gradient.loss_sweep`` pass (X read once for all trial points).
The evaluators are plain closures over tensors: nothing is compiled, so
the JAX package's evaluator cache has no counterpart.  Sparse X is CSR,
and its transposed copy is built once per ``optimize`` and handed to every
cost evaluation.

Host syncs per iteration, as in the JAX loop: ``g . d``, the sweep's trial
objectives, ``s . y`` and the accepted ``f``; the cost and the sweep read
nothing back.

Least squares on dense data can run from sufficient statistics
(``set_sufficient_stats``, ``ops/gram.py``): the cost then reads the
``(d, d)`` total Gram instead of X, and the sweep is its quadratic form.
Data beyond the card (host rows: a numpy array or a CPU tensor) takes
one of two schedules.  ``set_host_streaming`` evaluates every cost and
sweep by streaming the rows through the card in fixed chunks
(``optimize/streamed_costfun.py``, B1 on each chunk), for any loss;
``set_streamed_stats`` (least squares) builds the statistics in one
streamed pass (``GramLeastSquaresGradient.build_streamed``) and runs from
them.

On a data mesh (``set_mesh``) each rank passes its own rows: every cost
evaluation is the rank's sums (B1 on dense rows, the CSR kernel on sparse
ones) combined over the ranks in rank order
(``parallel.mesh.combine_sums``), and the sweep's ``(T,)`` loss sums and
count the same way, so every rank holds the same objective and gradient,
bitwise, and takes the same host decisions; the loop checks that they
agree (``_agree``) before each decision to stop.  Least squares with
``set_sufficient_stats`` builds the total statistics of every rank's rows
once (``parallel.gram_parallel.build_sharded_total_stats``) and then runs
unmeshed from them.  The streamed schedules take the mesh too: on one
host every rank passes the same whole host dataset (a file every rank
maps), ``set_host_streaming`` streams the rank's share of each chunk
(``optimize/streamed_costfun.py``; on several hosts, its local rows) and
combines the ranks' sums once an evaluation, and ``set_streamed_stats``
streams its slice into total statistics merged over the ranks
(``parallel.gram_parallel.build_streamed_total_stats``, the merge
compressed with ``set_ingest_options(wire_compress=)``), then runs
unmeshed from them.
"""

from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gradients import Gradient, LeastSquaresGradient
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    GramData,
    GramLeastSquaresGradient,
)
from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr
from tpu_sgd_torch.ops.updaters import (
    L1Updater,
    SimpleUpdater,
    SquaredL2Updater,
    Updater,
)
from tpu_sgd_torch.optimize.gradient_descent import _streamed_gram
from tpu_sgd_torch.optimize.optimizer import Dataset, Optimizer
from tpu_sgd_torch.parallel.mesh import (
    Mesh,
    all_gather,
    combine,
    combine_sums,
    has_model_axis,
)

Tensor = torch.Tensor


def _reg_terms(updater: Updater, reg_param: float):
    """``(reg_value(w), reg_grad(w))`` as the reference's CostFun takes them
    from each updater family; ``reg_value`` of a ``(T, d)`` stack gives the
    ``(T,)`` values of its rows."""
    if isinstance(updater, SquaredL2Updater):
        return (
            lambda w: 0.5 * reg_param * torch.sum(w * w, dim=-1),
            lambda w: reg_param * w,
        )
    if isinstance(updater, L1Updater):
        # Subgradient; the reference steers L1 users to OWL-QN, but accepts
        # this for parity testing at small reg.
        return (
            lambda w: reg_param * torch.sum(torch.abs(w), dim=-1),
            lambda w: reg_param * torch.sign(w),
        )
    return (
        lambda w: torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device),
        torch.zeros_like,
    )


def _warn_sequential_line_search(gradient, n_trials):
    """Tell the user their gradient lacks the ``loss_sweep`` protocol, so
    the Armijo backtracking runs one evaluation and one host sync PER
    TRIAL (up to ``n_trials`` per iteration) instead of one pass with a
    single sync."""
    warnings.warn(
        f"{type(gradient).__name__} has no loss_sweep(X, y, W, mask) "
        "method, so the line search falls back to SEQUENTIAL trials — up "
        f"to {n_trials} device calls + host syncs per iteration instead "
        "of one batched sweep.  Implement loss_sweep (losses of a (T, d) "
        "stack of trial weights in one pass — see "
        "tpu_sgd_torch.ops.gradients.Gradient.loss_sweep) to fuse "
        "the ladder.",
        RuntimeWarning,
        stacklevel=3,
    )


def _coerce_inputs(X, y, w, device):
    """``(X, y, w)`` on ``device`` for the quasi-Newton optimizers: sparse
    X as CSR, int and f64 features as f32 (as the JAX package computes
    with x64 off), f32 labels and weights.  A ``GramData`` bundle passes
    through untouched (the cost reads its statistics)."""
    if isinstance(X, GramData):
        return (X, as_tensor(y, X.device, torch.float32),
                as_tensor(w, X.device, torch.float32))
    X = as_tensor(X, device)
    if is_sparse(X):
        X = to_csr(X)
    if not X.dtype.is_floating_point or X.dtype == torch.float64:
        X = X.to(torch.float32)
    if not is_sparse(X):
        X = X.contiguous()
    return (X, as_tensor(y, device, torch.float32),
            as_tensor(w, device, torch.float32))


def _sums_kw(Xt, valid=None):
    """The keywords of ``batch_sums``: the transposed CSR and the padded
    rank's ``valid`` mask, where there are (a user's gradient for dense,
    unpadded data need not take them)."""
    kw = {} if Xt is None else {"Xt": Xt}
    if valid is not None:
        kw["mask"] = valid
    return kw


def _build_cost(gradient, reg_value, reg_grad, X, y, Xt=None, valid=None,
                mesh=None):
    """``cost(w) -> (f, g)``: full objective and gradient, one
    ``batch_sums`` pass; on a data ``mesh``, the rank's sums over its
    rows (``valid`` masks a padded rank's pad) combined in rank order
    before the reg terms are added."""
    kw = _sums_kw(Xt, valid)

    def cost(w):
        g_sum, l_sum, c = gradient.batch_sums(X, y, w, **kw)
        if mesh is not None:
            g_sum, l_sum, c = combine_sums(mesh, g_sum, l_sum, c)
        return l_sum / c + reg_value(w), g_sum / c + reg_grad(w)

    return cost


def _build_loss_only(gradient, reg_value, X, y, Xt=None, valid=None,
                     mesh=None):
    """``loss(w) -> f``: the objective alone, for the sequential line
    search of a gradient without ``loss_sweep``."""
    kw = _sums_kw(Xt, valid)

    def loss(w):
        _, l_sum, c = gradient.batch_sums(X, y, w, **kw)
        if mesh is not None:
            l_sum, c = combine(mesh, l_sum, c)
        return l_sum / c + reg_value(w)

    return loss


def _build_loss_sweep(gradient, reg_value, X, y, valid=None, mesh=None):
    """``sweep(W) -> (T,)`` objectives of ``T`` trial weight vectors in
    one ``loss_sweep`` pass (vector weights and the multinomial matrix
    weights alike); on a mesh the ``(T,)`` loss sums and the count are
    combined in rank order."""
    kw = {} if valid is None else {"mask": valid}

    def sweep(W):
        l_sum, c = gradient.loss_sweep(X, y, W, **kw)
        if mesh is not None:
            l_sum, c = combine(mesh, l_sum, c)
        return l_sum / c + reg_value(W)

    return sweep


def check_data_mesh(mesh, who: str):
    """``set_mesh``'s argument checks for the solvers that shard rows only
    (L-BFGS, OWL-QN, the normal equations): a ``Mesh`` (or None) without
    a sharded model axis, refused with the JAX package's message."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            f"{who}.set_mesh takes a tpu_sgd_torch.parallel.Mesh (make_mesh, "
            f"data_mesh, MeshConfig.build), got {type(mesh).__name__}")
    if has_model_axis(mesh):
        raise ValueError(
            f"{who} shards rows over a 1-D 'data' mesh; a 2-D (data, "
            "model) mesh would silently replicate X across the model "
            "axis — use a data-only mesh")
    return mesh


def _streams_local_rows(mesh) -> bool:
    """Whether the streamed CostFun on ``mesh`` takes each rank's LOCAL
    rows (a mesh over several hosts), where a rank with no rows still
    joins every combine."""
    from tpu_sgd_torch.parallel.mesh import mesh_spans_processes

    return mesh is not None and mesh_spans_processes(mesh)


def agree_on_host(mesh, values, device) -> None:
    """Raise on every rank unless every rank of the data ``mesh`` holds
    the same host ``values`` (the scalars a quasi-Newton loop decides
    on): one gather of them.  After a rank-order combine the ranks hold
    the same bits, so they branch alike; this checks it rather than
    assuming it, and a disagreement raises on all ranks together, so
    none is left waiting in a collective."""
    if mesh is None:
        return
    got = all_gather(mesh, torch.tensor([float(v) for v in values],
                                        dtype=torch.float64, device=device))
    got = got.cpu().numpy()
    same = (got == got[0]) | (np.isnan(got) & np.isnan(got[0]))
    if not same.all():
        raise RuntimeError(
            "the ranks of the mesh disagree on the quasi-Newton loop's "
            f"host decisions: {got.tolist()}")


def _push_correction(s_stack, y_stack, rho, k, m, s, yv, sy):
    """Append a curvature pair to the fixed-size history, shifting the
    ring once it is full (the JAX order, so the two-loop's γ and
    directions match); shared by LBFGS and OWLQN.  Returns the updated
    ``(s_stack, y_stack, rho, k)``."""
    if k < m:
        s_stack[k] = s
        y_stack[k] = yv
        rho[k] = 1.0 / sy
        return s_stack, y_stack, rho, k + 1
    s_stack = torch.roll(s_stack, -1, dims=0)
    y_stack = torch.roll(y_stack, -1, dims=0)
    rho = torch.roll(rho, -1)
    s_stack[m - 1] = s
    y_stack[m - 1] = yv
    rho[m - 1] = 1.0 / sy
    return s_stack, y_stack, rho, k


def _two_loop(g, s_stack, y_stack, rho, k: int):
    """The L-BFGS two-loop recursion over the ``k`` valid corrections
    (rows ``[0, k)``).  ``k`` is a host int, so only valid rows are
    visited: the JAX scan adds exact zeros for the others.  No sync."""
    q = g
    alphas = {}
    for idx in range(k - 1, -1, -1):
        alpha = rho[idx] * torch.dot(s_stack[idx], q)
        q = q - alpha * y_stack[idx]
        alphas[idx] = alpha
    if k > 0:
        # initial Hessian scaling gamma = s.y / y.y of the newest pair
        newest = k - 1
        gamma = torch.dot(s_stack[newest], y_stack[newest]) / torch.clamp(
            torch.dot(y_stack[newest], y_stack[newest]), min=1e-10)
        r = gamma * q
    else:
        r = q
    for idx in range(k):
        beta = rho[idx] * torch.dot(y_stack[idx], r)
        r = r + (alphas[idx] - beta) * s_stack[idx]
    return r


class LBFGS(Optimizer):
    """Limited-memory BFGS with backtracking Armijo line search.
    ``device=None`` runs on the card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch path."""

    #: backtracking ladder length (t = 1, 1/2, ..., 2^-(N-1))
    _LS_TRIALS = 25

    def __init__(
        self,
        gradient: Gradient = None,
        updater: Updater = None,
        num_corrections: int = 10,
        convergence_tol: float = 1e-6,
        max_num_iterations: int = 100,
        reg_param: float = 0.0,
        device=None,
    ):
        self.gradient = (gradient if gradient is not None
                         else LeastSquaresGradient())
        self.updater = updater if updater is not None else SimpleUpdater()
        self.num_corrections = num_corrections
        self.convergence_tol = convergence_tol
        self.max_num_iterations = max_num_iterations
        self.reg_param = reg_param
        self.device = device
        self._loss_history = None
        self.sufficient_stats = False
        self.gram_block_rows = DEFAULT_BLOCK_ROWS
        #: the last statistics build, ``(X, y, gradient, block_rows)``
        self._gram_entry = None
        #: the schedules for host rows, their chunk rows and ingest knobs
        self.host_streaming = False
        self.stream_batch_rows = None
        self.streamed_stats = False
        self.gram_batch_rows = None
        self.ingest_wire_dtype = None
        self.ingest_prefetch_depth = 2
        self.ingest_pipeline = True
        self.ingest_retry_policy = None
        self.ingest_wire_compress = None
        #: the last streamed CostFun, ``(X, y, StreamedCostFun, knobs)``,
        #: and the last streamed statistics build, ``(X, y, gradient,
        #: knobs)``, kept by identity
        self._stream_costfun_entry = None
        self._streamed_gram_entry = None
        #: the data mesh of ``set_mesh`` (None: one device)
        self.mesh = None
        #: the planner's bookkeeping (see ``GradientDescent``)
        self._user_gram_opts = frozenset()
        self.last_plan = None
        self._plan_key = None

    # fluent setters, reference parity
    def set_gradient(self, g):
        self.gradient = g
        return self

    def set_updater(self, u):
        self.updater = u
        return self

    def set_num_corrections(self, m: int):
        self.num_corrections = int(m)
        return self

    def set_convergence_tol(self, t: float):
        self.convergence_tol = float(t)
        return self

    def set_max_num_iterations(self, n: int):
        self.max_num_iterations = int(n)
        return self

    def set_reg_param(self, r: float):
        self.reg_param = float(r)
        return self

    # -- schedules -----------------------------------------------------------
    def set_mesh(self, mesh):
        """Shard the cost (and the line-search sweep) by rows over a 1-D
        data mesh (``parallel.Mesh``; ``None``: one device): each rank
        passes its own rows, padded to the longest rank's with a valid
        mask (``parallel.shard_dataset`` / ``shard_csr``), and the ranks
        combine every evaluation's sums in rank order, so every rank runs
        the same iterations to the same weights.  A 2-D mesh raises
        ``ValueError``."""
        self.mesh = check_data_mesh(mesh, type(self).__name__)
        return self

    def set_sufficient_stats(self, flag: bool = True):
        """Run the least-squares cost and line-search sweep from
        precomputed block-prefix Gram statistics (``ops/gram.py``): each
        full-batch objective and gradient becomes an O(d²) matvec instead
        of a pass over X.  Applies when the gradient is exactly
        ``LeastSquaresGradient`` on dense data; otherwise a no-op.  The
        last build is retained by ``(X, y)`` identity; call
        :meth:`release_sufficient_stats` to free it."""
        self._clear_planned_schedule()
        self.sufficient_stats = bool(flag)
        self._mark_manual_schedule()
        return self

    def _clear_planned_schedule(self):
        """A manual schedule setter taking over after a planned run: the
        plan's schedule flags and sizing knobs go back to their defaults
        (user-set ones stay; see ``GradientDescent``)."""
        if self.last_plan is not None:
            self.host_streaming = False
            self.sufficient_stats = False
            self.streamed_stats = False
            from tpu_sgd_torch.plan import reset_plan_owned_gram_knobs

            reset_plan_owned_gram_knobs(self)

    def _mark_manual_schedule(self):
        """A schedule setter the user called invalidates any plan
        (``models/glm.py``'s "manual flags win" rule)."""
        self.last_plan = None
        self._plan_key = None

    def release_sufficient_stats(self):
        """Drop the cached statistics bundles (resident and streamed) and
        the streamed CostFun, so the bound dataset, its prefix stack and
        the CostFun's pinned staging can be freed."""
        self._gram_entry = None
        self._streamed_gram_entry = None
        self._stream_costfun_entry = None
        return self

    def set_gram_options(self, block_rows: int = None,
                         batch_rows: int = None):
        """``block_rows`` sizes the statistics' prefix stack;
        ``batch_rows`` caps the host->device chunk of the streamed build
        (``set_streamed_stats``; default 64 blocks).  The planner sets
        them itself; a knob set here is the user's and every plan keeps
        it."""
        from tpu_sgd_torch.plan import apply_user_gram_knobs

        apply_user_gram_knobs(self, block_rows=block_rows,
                              batch_rows=batch_rows)
        return self

    def set_streamed_stats(self, flag: bool = True, block_rows: int = None):
        """Least squares on host rows too large for the card: one streamed
        pass builds the block-prefix statistics on the card
        (``GramLeastSquaresGradient.build_streamed``, knobs
        ``set_gram_options(batch_rows=)`` and ``set_ingest_options``),
        after which every cost and sweep is an O(d²) read of the totals.
        Full-batch sums are exact but for the dropped ``n % block_rows``
        tail rows.  Applies to exactly ``LeastSquaresGradient`` on dense
        data and raises otherwise; the build is cached per ``(X, y)``
        identity."""
        if block_rows is not None and int(block_rows) < 1:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        self._clear_planned_schedule()
        self.streamed_stats = bool(flag)
        if block_rows is not None:
            self.gram_block_rows = int(block_rows)
            self._user_gram_opts = self._user_gram_opts | {"block_rows"}
        self._mark_manual_schedule()
        return self

    def set_host_streaming(self, flag: bool = True, batch_rows: int = None):
        """Quasi-Newton for ANY loss on host rows too large for the card:
        every full-batch cost and line-search sweep streams the rows
        through the card in fixed chunks into accumulators there (the
        chunked treeAggregate CostFun, ``optimize/streamed_costfun.py``),
        re-reading the data on each evaluation.  ``batch_rows`` caps the
        chunk (default ~256 MB of rows).  The CostFun keeps its own feed:
        ``set_ingest_options`` applies to ``set_streamed_stats``'s
        build.  The planner sizes ``batch_rows`` itself
        (``plan.plan_quasi_newton``); a cap set here is the user's."""
        self._clear_planned_schedule()
        self.host_streaming = bool(flag)
        if batch_rows is not None:
            if int(batch_rows) < 1:
                raise ValueError(
                    f"batch_rows must be positive, got {batch_rows}")
            self.stream_batch_rows = int(batch_rows)
            self._user_gram_opts = (
                self._user_gram_opts | {"stream_batch_rows"})
        self._mark_manual_schedule()
        return self

    def set_ingest_options(self, wire_dtype=None, prefetch_depth=None,
                           pipeline=None, retry=None, wire_compress=None):
        """Ingest knobs of the streamed statistics build
        (``set_streamed_stats``), as ``GradientDescent.set_ingest_options``
        validates them: ``wire_dtype``, ``prefetch_depth``, ``pipeline``;
        ``retry`` is kept for the same contract, and the quasi-Newton feeds
        do not retry.  ``wire_compress="topk:<frac>"`` merges the meshed
        streamed totals through the JAX package's compressed merge
        (``parallel.gram_parallel.build_streamed_total_stats``); ``False``
        clears it."""
        from tpu_sgd_torch.plan import apply_user_ingest_options

        apply_user_ingest_options(self, wire_dtype=wire_dtype,
                                  prefetch_depth=prefetch_depth,
                                  pipeline=pipeline, retry=retry,
                                  wire_compress=wire_compress)
        return self

    @property
    def loss_history(self):
        return self._loss_history

    def optimize(self, data: Dataset, initial_weights) -> Tensor:
        w, _ = self.optimize_with_history(data, initial_weights)
        return w

    def _resident(self, data, initial_weights):
        """The run's evaluation inputs on its device, ``((gradient, X, y,
        Xt, valid, mesh), w)``, or ``(None, w)`` for empty input (the
        history is then empty).  ``set_sufficient_stats`` swaps in the
        statistics gradient, X becoming its ``GramData``; on a mesh its
        totals combine every rank's rows and the run goes unmeshed
        (``mesh`` None).  Otherwise a mesh shards the rows: ``valid``
        masks a padded rank's pad, ``Xt`` is sparse X's transposed CSR."""
        from tpu_sgd_torch.parallel.data_parallel import agree, shard_dataset
        from tpu_sgd_torch.parallel.sparse_parallel import shard_csr

        X, y = data
        mesh = self.mesh
        if mesh is not None and isinstance(X, GramData):
            raise NotImplementedError(
                "GramData input supports unmeshed quasi-Newton runs (the "
                "statistics already live on one device); drop set_mesh")
        dev = resolve_device(self.device)
        X, y, w = _coerce_inputs(X, y, initial_weights, dev)
        if mesh is not None and mesh.backend == "nccl" and dev.type != "cuda":
            raise ValueError(
                f"an NCCL mesh combines on the card; this optimizer runs "
                f"on {dev} (use a gloo group for CPU ranks)")
        n = (X.shape[0] if mesh is None
             else int(agree(mesh, [X.shape[0]], dev).sum()))
        if n == 0:
            self._loss_history = np.zeros((0,), np.float32)
            return None, w
        gradient, Xg = self._substitute_gram(self.gradient, X, y)
        if Xg is not X or mesh is None:
            # statistics (every rank's totals on a mesh) or one device
            Xt = transpose_csr(X) if is_sparse(X) else None
            return (gradient, Xg, y, Xt, None, None), w
        if is_sparse(X):
            X, Xt, y, valid = shard_csr(mesh, X, y, device=dev)
        else:
            (X, y, valid), Xt = shard_dataset(mesh, X, y, device=dev), None
        return (gradient, X, y, Xt, valid, mesh), w

    def _substitute_gram(self, gradient, X, y):
        """``set_sufficient_stats`` where it fits (exactly
        ``LeastSquaresGradient`` on dense X), cached by ``(X, y)``
        identity; shared with OWL-QN (Lasso least squares).  Returns
        ``(gradient, X)``: on substitution X becomes the ``GramData``
        bundle.  On a mesh the bundle holds the totals of every rank's
        rows (``build_sharded_total_stats``)."""
        if isinstance(X, GramData) and not isinstance(
                gradient, GramLeastSquaresGradient):
            raise ValueError(
                "GramData input needs a GramLeastSquaresGradient (use "
                "GramLeastSquaresGradient.build and pass it as the "
                "gradient)")
        if (self.mesh is None
                and isinstance(gradient, GramLeastSquaresGradient)
                and gradient.data is not None and gradient.data.X is X):
            # a user-built gram gradient on exactly this matrix
            return gradient, gradient.data
        if not (self.sufficient_stats and type(gradient) is
                LeastSquaresGradient and not is_sparse(X)
                and not isinstance(X, GramData)):
            return gradient, X
        entry = self._gram_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[3:] == (self.gram_block_rows, self.mesh)):
            return entry[2], entry[2].data
        self._gram_entry = None  # free the superseded stack first
        if self.mesh is not None:
            from tpu_sgd_torch.parallel.gram_parallel import (
                build_sharded_total_stats,
            )

            g = GramLeastSquaresGradient(build_sharded_total_stats(
                self.mesh, X, y, block_rows=self.gram_block_rows))
        else:
            g = GramLeastSquaresGradient.build(
                X, y, block_rows=self.gram_block_rows, device=X.device)
        self._gram_entry = (X, y, g, self.gram_block_rows, self.mesh)
        return g, g.data

    def _maybe_streamed_reentry(self, X, y, initial_weights):
        """``set_streamed_stats``: build the virtual statistics from the
        host rows before anything moves to the card, swap the gradient,
        and run ``optimize_with_history`` on the ``GramData`` (shared with
        OWL-QN).  None when the flag is off or X is already statistics."""
        if not self.streamed_stats or isinstance(X, GramData):
            return None
        g = (_streamed_gram(self, X, y) if self.mesh is None
             else self._streamed_total_gram(X, y))
        orig, self.gradient = self.gradient, g
        # the statistics are the same on every rank: the run goes
        # unmeshed from them (the mesh's work, dividing the rows, is done)
        orig_mesh, self.mesh = self.mesh, None
        try:
            return self.optimize_with_history(
                (g.data, y[:g.data.shape[0]]), initial_weights)
        finally:
            self.gradient = orig
            self.mesh = orig_mesh

    def _streamed_total_gram(self, X, y):
        """Meshed ``set_streamed_stats``: every rank passes the same whole
        host dataset and streams its slice into the total statistics,
        merged over the ranks (densely, or through the compressed merge of
        ``set_ingest_options(wire_compress=)``), the same bits on every
        rank (``parallel.gram_parallel.build_streamed_total_stats``); no
        row is dropped.  Cached by ``(X, y)`` identity, the mesh and the
        knobs."""
        from tpu_sgd_torch.optimize.gradient_descent import (
            _streamed_stats_guards,
        )
        from tpu_sgd_torch.parallel.gram_parallel import (
            build_streamed_total_stats,
        )

        _streamed_stats_guards(self, X)
        dev = resolve_device(self.device)
        opts = (self.gram_block_rows, self.gram_batch_rows, self.mesh,
                self.ingest_wire_dtype, self.ingest_prefetch_depth,
                self.ingest_pipeline, self.ingest_wire_compress, dev)
        entry = self._streamed_gram_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[3] == opts):
            return entry[2]
        self._streamed_gram_entry = None  # free the superseded build
        data = build_streamed_total_stats(
            self.mesh, X, y, block_rows=self.gram_block_rows,
            batch_rows=self.gram_batch_rows,
            wire_dtype=self.ingest_wire_dtype,
            prefetch_depth=self.ingest_prefetch_depth,
            pipeline=self.ingest_pipeline,
            wire_compress=(self.ingest_wire_compress
                           if self.ingest_pipeline else None),
            device=dev)
        g = GramLeastSquaresGradient(data)
        self._streamed_gram_entry = (X, y, g, opts)
        return g

    def _host_streamed_costfun(self, X, y):
        """The guards of ``set_host_streaming`` and its
        :class:`StreamedCostFun`, cached by ``(X, y)`` identity, chunk
        rows, device and gradient (shared with OWL-QN)."""
        from tpu_sgd_torch.optimize.streamed_costfun import StreamedCostFun

        if isinstance(X, GramData):
            raise ValueError(
                "GramData input already runs from its statistics beyond "
                "the card; drop set_host_streaming")
        if is_sparse(X):
            raise NotImplementedError(
                "host streaming needs dense rows; sparse features are "
                "~1000x smaller and stay resident on the card instead")
        if self.streamed_stats:
            raise ValueError(
                "set_streamed_stats and set_host_streaming are alternative "
                "schedules for data beyond the card; enable exactly one")
        if self.sufficient_stats:
            raise ValueError(
                "set_sufficient_stats needs device-resident data; it "
                "cannot combine with set_host_streaming")
        opts = (self.stream_batch_rows, resolve_device(self.device),
                self.mesh)
        entry = self._stream_costfun_entry
        if (entry is not None and entry[0] is X and entry[1] is y
                and entry[3] == opts and entry[2].gradient is self.gradient):
            return entry[2]
        self._stream_costfun_entry = None  # free the old staging first
        scf = StreamedCostFun(self.gradient, X, y,
                              batch_rows=self.stream_batch_rows,
                              mesh=self.mesh, device=opts[1])
        self._stream_costfun_entry = (X, y, scf, opts)
        return scf

    def _host_streamed_evaluators(self, X, y, initial_weights):
        """``(w0, cost1, sweep1, loss1)`` over the streamed CostFun, as
        :meth:`_qn_loop` takes them; None for empty input (the resident
        path's early return covers it)."""
        if X.shape[0] == 0 and not _streams_local_rows(self.mesh):
            return None
        scf = self._host_streamed_costfun(X, y)
        w = as_tensor(initial_weights, scf.device, torch.float32)
        reg_value, reg_grad = _reg_terms(self.updater, self.reg_param)

        def cost1(wv):
            g_sum, l_sum, c = scf.cost_sums(wv)
            return l_sum / c + reg_value(wv), g_sum / c + reg_grad(wv)

        if hasattr(self.gradient, "loss_sweep"):
            def sweep1(W):
                l_sum, c = scf.sweep_sums(W)
                return l_sum / c + reg_value(W)

            return w, cost1, sweep1, None
        _warn_sequential_line_search(self.gradient, self._LS_TRIALS)

        def loss1(wv):
            l_sum, c = scf.loss_sums(wv)
            return l_sum / c + reg_value(wv)

        return w, cost1, None, loss1

    def optimize_with_history(self, data: Dataset, initial_weights):
        """``(weights, loss_history)``: weights a float32 tensor on the
        run's device, the history a numpy array (one entry per cost
        evaluation)."""
        X, y = data
        streamed = self._maybe_streamed_reentry(X, y, initial_weights)
        if streamed is not None:
            return streamed
        if self.host_streaming:
            # before _coerce_inputs, which would move X to the card whole
            ev = self._host_streamed_evaluators(X, y, initial_weights)
            if ev is not None:
                return self._qn_loop(*ev, self.mesh)
        arrays, w = self._resident(data, initial_weights)
        if arrays is None:
            return w, self._loss_history
        gradient, X, y, Xt, valid, mesh = arrays
        reg_value, reg_grad = _reg_terms(self.updater, self.reg_param)
        cost1 = _build_cost(gradient, reg_value, reg_grad, X, y, Xt, valid,
                            mesh)
        if hasattr(gradient, "loss_sweep"):
            sweep1 = _build_loss_sweep(gradient, reg_value, X, y, valid,
                                       mesh)
            return self._qn_loop(w, cost1, sweep1, None, mesh)
        # exotic gradients without a sweep rule: sequential trials
        _warn_sequential_line_search(gradient, self._LS_TRIALS)
        loss1 = _build_loss_only(gradient, reg_value, X, y, Xt, valid, mesh)
        return self._qn_loop(w, cost1, None, loss1, mesh)

    def _qn_loop(self, w, cost1, sweep1, loss1, mesh=None):
        """The L-BFGS iteration loop over full-batch evaluators:
        ``cost1(w) -> (f, g)``, ``sweep1(W_trials) -> (T,)`` trial
        objectives (None for gradients without a sweep rule), ``loss1(w)
        -> f`` (the sequential fallback).  On a ``mesh`` the ranks check
        that they agree on the host scalars before each decision to stop
        (:func:`agree_on_host`)."""
        n_ls = self._LS_TRIALS
        # trial step sizes, largest first
        ladder_h = (0.5 ** np.arange(n_ls)).astype(np.float32)
        ladder = torch.as_tensor(ladder_h, device=w.device)
        swept = sweep1 is not None

        m = self.num_corrections
        d = w.shape[0]
        s_stack = torch.zeros((m, d), dtype=w.dtype, device=w.device)
        y_stack = torch.zeros((m, d), dtype=w.dtype, device=w.device)
        rho = torch.zeros((m,), dtype=w.dtype, device=w.device)
        k = 0  # valid corrections

        f, g = cost1(w)
        losses: List[float] = [float(f)]
        for _ in range(self.max_num_iterations):
            direction = -_two_loop(g, s_stack, y_stack, rho, k)
            # Armijo backtracking; only the accept decision is host-side
            # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
            g_dot_d = float(torch.dot(g, direction))
            if g_dot_d >= 0:  # not a descent direction: reset to -g
                direction = -g
                # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
                g_dot_d = float(torch.dot(g, direction))
            f0 = losses[-1]  # float(f), read when it was recorded
            if swept:
                # whole ladder in one device pass + ONE host sync
                trials = w[None, :] + ladder[:, None] * direction[None, :]
                # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
                f_trials = sweep1(trials).cpu().numpy()
                ok = f_trials <= f0 + 1e-4 * ladder_h * g_dot_d
                j = int(np.argmax(ok)) if ok.any() else -1
                accepted = j >= 0
                if accepted:
                    w_new = w + float(ladder_h[j]) * direction
            else:
                t = 1.0
                accepted = False
                for _ls in range(n_ls):
                    w_new = w + t * direction
                    # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
                    if float(loss1(w_new)) <= f0 + 1e-4 * t * g_dot_d:
                        accepted = True
                        break
                    t *= 0.5
            agree_on_host(mesh, (g_dot_d, accepted), w.device)
            if not accepted:
                break  # cannot make progress
            f_new, g_new = cost1(w_new)  # gradient at the accepted point
            s = w_new - w
            yv = g_new - g
            # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
            sy = float(torch.dot(s, yv))
            if sy > 1e-10:  # curvature condition: keep the correction
                s_stack, y_stack, rho, k = _push_correction(
                    s_stack, y_stack, rho, k, m, s, yv, sy)
            w, f, g = w_new, f_new, g_new
            # graftlint: disable=host-sync -- A8 follow-up: host line search until the loop is captured
            losses.append(float(f))
            agree_on_host(mesh, (sy, losses[-1]), w.device)
            rel = abs(losses[-2] - losses[-1]) / max(
                abs(losses[-2]), abs(losses[-1]), 1.0
            )
            if rel < self.convergence_tol:
                break

        self._loss_history = np.asarray(losses, np.float32)
        return w, self._loss_history


def run_lbfgs(
    data: Dataset,
    gradient: Gradient,
    updater: Updater,
    num_corrections: int,
    convergence_tol: float,
    max_num_iterations: int,
    reg_param: float,
    initial_weights,
    mesh=None,
    device=None,
):
    """Functional entry point, signature parity with the reference's
    ``object LBFGS.runLBFGS``: same argument order, returns ``(weights,
    loss_history)``.  ``mesh``: a data mesh (``LBFGS.set_mesh``)."""
    opt = LBFGS(
        gradient,
        updater,
        num_corrections=num_corrections,
        convergence_tol=convergence_tol,
        max_num_iterations=max_num_iterations,
        reg_param=reg_param,
        device=device,
    )
    if mesh is not None:
        opt.set_mesh(mesh)
    return opt.optimize_with_history(data, initial_weights)
