"""Mini-batch gradient descent: the port of ``tpu_sgd/optimize/gradient_descent.py``
(dense, single-device, data resident on the device).

Per iteration, as in the reference's ``runMiniBatchSGD``:

    sample (Bernoulli mask / indexed gather / sliced window)
    -> fused (grad_sum, loss_sum, count)        one CUDA kernel launch
    -> grad /= count -> updater.compute -> convergence check

The JAX package runs the loop as one ``lax.while_loop``; here it is a
Python loop over device tensors.  The loss history is preallocated on the
device and written there; the record count and the convergence flag are
device tensors too.  What syncs the host: reading the convergence flag once
per iteration when ``convergence_tol > 0`` (none when it is 0), and one
read of the record count and the history when the run ends.  The sliced
window's start is drawn on the device and read by the kernel through a
pointer; it never reaches the host.  Capturing the loop as a CUDA graph is
later work (ROADMAP A3).

Least squares on dense data can run from block-prefix Gram statistics
(``set_sufficient_stats``, ``ops/gram.py``): the gradient is rebound to a
``GramLeastSquaresGradient`` and its ``GramData`` bundle rides where X
goes, so each sliced window or full batch costs a ``(d, d)`` matvec
instead of a pass over the rows.  ``set_gram_options(chunk_iters=K)``
sends block-aligned windows through the chunked-gather driver
(``optimize/gram_driver.py``).

Sparse features (any non-strided layout) train undensified, as the JAX
package's BCOO branch does on one device: X becomes CSR with int32
indices where they fit, ``make_run`` builds its transposed CSR once, and
each iteration's two products are CSR x vector (``ops/sparse.py``).  Only
Bernoulli sampling (or full batch) applies to them.

Sampling draws from a ``torch.Generator`` on the data's device, seeded
from ``(seed, iteration)``, so a sample depends on nothing else — the same
contract as the JAX package's ``fold_in(key, i)``, with other bits: the two
packages draw different samples from the same seed.  Contract kept:
``loss[t] = loss_sum/count + reg_val(previous weights)``, an empty sample
skips the update, convergence is tested from the second iteration on, and
the initial ``reg_val`` comes from a zero-gradient probe update.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_sgd_torch.config import SGDConfig
from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.gradients import Gradient, LeastSquaresGradient
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    GramData,
    GramLeastSquaresGradient,
)
from tpu_sgd_torch.ops.sparse import is_sparse, to_csr, transpose_csr
from tpu_sgd_torch.ops.updaters import SimpleUpdater, Updater
from tpu_sgd_torch.optimize.optimizer import Dataset, Optimizer

Tensor = torch.Tensor


def _raise_if_nonfinite(losses, first_iteration: int = 1) -> None:
    """The numerics check of ``set_check_numerics``."""
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


def _seed_for(seed: int, i: int) -> int:
    """The generator seed of iteration ``i``: a function of ``(seed, i)``
    alone, so iteration ``i`` draws the same sample in any run.  Mixed by
    splitmix64, since the CPU generator keeps only the low 32 bits."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(i) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _window_start(gen, n: int, m: int, device) -> Tensor:
    """The sliced window's start, a ``(1,)`` device tensor drawn from
    ``gen`` (seeded by the caller with ``_seed_for(seed, i)``): the one
    window stream of ``make_run`` and the chunked gram driver."""
    return torch.randint(0, max(1, n - m + 1), (1,), generator=gen,
                         device=device)


def _make_mask(cfg: SGDConfig, gen, n_local, valid, device):
    """Per-iteration Bernoulli mini-batch mask (``valid`` at full batch:
    no mask is drawn, so the kernel takes its unmasked variant)."""
    if cfg.mini_batch_fraction < 1.0:
        mask = torch.rand(n_local, generator=gen, device=device) \
            < cfg.mini_batch_fraction
        return mask if valid is None else mask & valid
    return valid


def _make_local_sums(gradient, cfg):
    """The per-iteration ``(grad_sum, loss_sum, count)`` recipe: sampling
    (bernoulli / indexed / sliced) plus the fused batch sums."""
    indexed = cfg.sampling == "indexed" and cfg.mini_batch_fraction < 1.0
    sliced = cfg.sampling == "sliced" and cfg.mini_batch_fraction < 1.0
    generators = {}

    def local_sums(weights, X, y, i, valid, Xt=None):
        dev = X.device
        gen = generators.get(dev)
        if gen is None:
            gen = generators[dev] = torch.Generator(device=dev)
        gen.manual_seed(_seed_for(cfg.seed, i))
        n = X.shape[0]
        if sliced or indexed:
            m = max(1, round(cfg.mini_batch_fraction * n))
        if sliced:
            # a contiguous window at a random start, drawn on the device;
            # the window kernel reads it in place (assumes exchangeable
            # row order, see SGDConfig.sampling)
            start = _window_start(gen, n, m, dev)
            return gradient.window_sums(X, y, weights, start, m, valid=valid)
        if indexed:
            idx = torch.randint(0, n, (m,), generator=gen, device=dev)
            Xb, yb = X[idx], y[idx]
            mask = None if valid is None else valid[idx]
        else:
            Xb, yb = X, y
            mask = _make_mask(cfg, gen, n, valid, dev)
            if Xt is not None:
                return gradient.batch_sums(Xb, yb, weights, mask, Xt=Xt)
        return gradient.batch_sums(Xb, yb, weights, mask)

    return local_sums


def make_step(gradient: Gradient, updater: Updater, config: SGDConfig):
    """One SGD iteration: ``step(weights, X, y, i, reg_val, valid, Xt) ->
    (new_weights, loss_i, new_reg_val, count)``; ``loss_i`` already
    includes the previous iteration's ``reg_val``.  ``Xt`` is sparse X's
    transposed CSR (None for dense X)."""
    cfg = config
    local_sums = _make_local_sums(gradient, cfg)

    def step(weights, X, y, i, reg_val, valid=None, Xt=None):
        g, l, c = local_sums(weights, X, y, i, valid, Xt)
        has_batch = c > 0
        safe_c = torch.clamp(c, min=1.0)
        loss_i = l / safe_c + reg_val
        new_w, new_reg = updater.compute(
            weights, g / safe_c, cfg.step_size, i, cfg.reg_param
        )
        # Reference behavior on an empty sampled batch: skip the update.
        new_w = torch.where(has_batch, new_w, weights)
        new_reg = torch.where(has_batch, new_reg, reg_val)
        return new_w, loss_i, new_reg, c

    return step


def make_run(gradient: Gradient, updater: Updater, config: SGDConfig):
    """The whole optimization loop: ``run(initial_weights, X, y, valid,
    Xt) -> (weights, loss_history, n_recorded)``.  ``loss_history`` is a
    device tensor of length ``num_iterations``, NaN beyond ``n_recorded``
    (a device int64 tensor of shape ``(1,)``).  Sparse ``X`` is CSR; its
    transposed copy ``Xt`` is built here, once per run, unless the caller
    passes the one it holds (``ops.sparse.transpose_csr``)."""
    cfg = config
    check_conv = cfg.convergence_tol > 0.0
    step = make_step(gradient, updater, cfg)

    def run(initial_weights, X, y, valid=None, Xt=None):
        if Xt is None and is_sparse(X):
            Xt = transpose_csr(X)
        w = initial_weights
        _, reg_val = updater.compute(
            w, torch.zeros_like(w), 0.0, 1, cfg.reg_param)
        dev = w.device
        losses = torch.full((cfg.num_iterations,), float("nan"),
                            dtype=torch.float32, device=dev)
        n_rec = torch.zeros((1,), dtype=torch.int64, device=dev)
        for i in range(1, cfg.num_iterations + 1):
            new_w, loss_i, new_reg, c = step(w, X, y, i, reg_val, valid, Xt)
            has_batch = c > 0
            kept = losses.index_select(0, n_rec)
            losses.index_copy_(0, n_rec, torch.where(
                has_batch, loss_i.to(torch.float32).reshape(1), kept))
            n_rec += has_batch.to(torch.int64)
            converged = None
            if check_conv and i > 1:
                diff = torch.linalg.vector_norm(new_w - w)
                w_norm = torch.linalg.vector_norm(new_w)
                converged = has_batch & (
                    diff < cfg.convergence_tol * torch.clamp(w_norm, min=1.0))
            w, reg_val = new_w, new_reg
            if converged is not None and bool(converged):  # the host sync
                break
        return w, losses, n_rec

    return run


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to tpu_sgd_torch yet (ROADMAP {item}); use "
        "the JAX package tpu_sgd for it"
    )


#: the gram knobs of ``set_gram_options``: name -> (optimizer attribute,
#: requires a positive int)
_GRAM_KNOBS = {
    "block_rows": ("gram_block_rows", True),
    "aligned": ("gram_aligned", False),
    "chunk_iters": ("gram_chunk_iters", True),
}


def _apply_gram_knobs(optimizer, batch_rows=None, **knobs) -> None:
    """Validate every knob, then apply them all, so a bad later argument
    leaves the earlier ones untouched (the JAX package's
    ``apply_user_gram_knobs``, without the planner's bookkeeping).
    ``batch_rows`` sizes the streamed build's chunk, which is not ported."""
    if batch_rows is not None:
        _not_ported("set_gram_options(batch_rows=...), the streamed "
                    "build's chunk cap,", "A9")
    provided = {}
    for name, val in knobs.items():
        if val is None:
            continue
        attr, positive = _GRAM_KNOBS[name]
        if positive:
            if int(val) < 1:
                raise ValueError(f"{name} must be positive, got {val}")
            val = int(val)
        else:
            val = bool(val)
        provided[name] = (attr, val)
    for attr, val in provided.values():
        setattr(optimizer, attr, val)


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

    # -- schedules and planes of later slices -------------------------------
    def set_mesh(self, mesh):
        _not_ported("set_mesh (data parallelism)", "A5")

    def set_host_streaming(self, flag: bool = True, resident_rows: int = 0):
        _not_ported("set_host_streaming", "A9")

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
        self.sufficient_stats = bool(flag)
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
        ``batch_rows`` (the streamed build's chunk) raises (ROADMAP A9)."""
        _apply_gram_knobs(self, batch_rows=batch_rows, block_rows=block_rows,
                          aligned=aligned, chunk_iters=chunk_iters)
        return self

    def release_sufficient_stats(self):
        """Drop the cached statistics bundle, so the bound dataset and its
        prefix stack can be freed; the next run rebuilds."""
        self._gram_entry = None
        return self

    def set_streamed_stats(self, flag: bool = True, block_rows: int = None):
        _not_ported("set_streamed_stats (statistics streamed from the "
                    "host)", "A9")

    def set_superstep(self, k: int):
        _not_ported("set_superstep", "A9")

    def set_residency(self, cadence: int = 8):
        _not_ported("set_residency", "A9")

    def set_listener(self, listener):
        _not_ported("set_listener", "A11")

    def set_checkpoint(self, manager, every: int = 10):
        _not_ported("set_checkpoint", "A11")

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
        if isinstance(X, GramData):
            return self._optimize_gram_data(X, y, initial_weights, dev)
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

    def _run(self, gradient, X, y, w0):
        """One run of the loop (the chunked gram driver where it applies),
        then the history read back once."""
        run = (self._maybe_chunked_gram_run(gradient, X)
               or make_run(gradient, self.updater, self.config))
        w, losses, n_rec = run(w0, X, y)
        self._loss_history = losses[:int(n_rec)].cpu().numpy()
        if self.check_numerics:
            _raise_if_nonfinite(self._loss_history)
        return w, self._loss_history

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

    def _maybe_chunked_gram_run(self, gradient, X):
        """The chunked-gather driver when ``chunk_iters`` is set and this
        run has block-ALIGNED statistics windows: virtual statistics, or a
        gradient in aligned mode (the gradient's own mode, not the
        optimizer's knob, so a prebuilt exact gradient keeps its exact
        windows).  None otherwise."""
        from tpu_sgd_torch.optimize import gram_driver

        cfg = self.config
        if (not self.gram_chunk_iters
                or not isinstance(X, GramData)
                or not isinstance(gradient, GramLeastSquaresGradient)
                or not (X.X is None or gradient.aligned)
                or cfg.sampling != "sliced"
                or cfg.mini_batch_fraction >= 1.0):
            return None
        return gram_driver.make_chunked_gram_run(
            self.updater, cfg, n=X.shape[0], block_rows=X.block_rows,
            chunk_iters=self.gram_chunk_iters)


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
