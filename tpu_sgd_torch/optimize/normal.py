"""Exact least squares via the normal equations: the port of
``tpu_sgd/optimize/normal.py`` (device-resident data, one device).

One pass over X accumulates ``(XᵀX, Xᵀy, yᵀy, n)``, then the small
``(d, d)`` system

    (XᵀX / n + reg·I) w = Xᵀy / n

is solved by Cholesky.  It sits behind the same ``Optimizer`` boundary as
``GradientDescent``, so the GLM harness, intercept handling and
persistence compose with it unchanged.

Precision.  The loss is a difference of ``‖y‖²``-sized terms, so the
statistics are kept in true f32 or better: no TF32
(:func:`~tpu_sgd_torch.device.true_f32_matmul`), bf16 products with an f32
output (never a bf16 one), and the long sum over rows split into
``GRAM_BLOCK_ROWS``-row blocks whose f32 products are added in f64.  Over
300,000 rows one bf16 product with an f32 output was off by 3.6e-4 of the
Gram's largest entry, an f32 product of the upcast rows by 2.3e-5, and
4,096-row blocks added in f64 by 1.0e-5 (``scripts/probe_f32_products.py``
on an H100 80GB HBM3 at 700 W).

Host rows too large for the card (a numpy array or a CPU tensor) take
``set_host_streaming``: the totals accumulate from streamed chunks with an
f64 carry (``GramLeastSquaresGradient._streamed_totals``, resumable with
``resume_dir``), every row counted, then the same solve.  Those totals are
at least as precise as the resident Gram's.  The default
(``host_streaming=None``) is AUTO placement, the JAX package's: host data
whose bytes exceed the planner's device budget (``plan.device_budget``;
on a mesh ``plan.mesh_budget`` times the data ranks) stream their totals
and log one ``plan: normal host_streamed`` line; everything else, and
every CUDA tensor, runs resident.  Nothing moves to the CPU.

On a data mesh (``set_mesh``) each rank passes its own rows and runs the
same one pass over them; the ranks' f64 ``(XᵀX, Xᵀy, yᵀy, n)`` are
combined in rank order (``parallel.mesh.combine``) and every rank then
solves the same system, so all hold the same weights, bitwise.  With
``set_host_streaming`` on a mesh every rank passes the same whole host
dataset (a file every rank maps) and streams its slice into an f64
carry; the carries merge in rank order
(``parallel.gram_parallel.build_streamed_total_stats``) and every rank
solves the same system.  A mesh whose ranks lie on more than one host
raises the JAX package's message.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sgd_torch.device import as_tensor, resolve_device, true_f32_matmul
from tpu_sgd_torch.io.wire import host_tensor
from tpu_sgd_torch.ops.gram import (
    DEFAULT_BLOCK_ROWS,
    GramLeastSquaresGradient,
    streamed_totals_chunking,
)
from tpu_sgd_torch.ops.gradients import acc_dtype, matmul_dtype, mm_acc
from tpu_sgd_torch.ops.sparse import is_sparse
from tpu_sgd_torch.optimize.optimizer import Dataset, Optimizer

Tensor = torch.Tensor

#: rows of one block of the Gram's sum (see the module docstring)
GRAM_BLOCK_ROWS = 4096
#: blocks per batched product, which bounds its ``(blocks, d, d)`` f32
#: output
_BLOCKS_PER_CALL = 32


def _gram_sums(X: Tensor, y: Tensor):
    """One pass: ``(XᵀX, Xᵀy, yᵀy, n)`` at the accumulation dtype (f32 for
    bf16 X, whose products run in bf16 with f32 outputs), each block's
    products added in f64."""
    acc = acc_dtype(matmul_dtype(X))
    A, b, yty = _gram_sums_wide(X, y)
    return (A.to(acc), b.to(acc), yty.to(acc),
            torch.tensor(float(X.shape[0]), dtype=torch.float32,
                         device=X.device))


def _gram_sums_wide(X: Tensor, y: Tensor):
    """``(XᵀX, Xᵀy, yᵀy)`` in f64, the sums :func:`_gram_sums` rounds: a
    rank's share on a mesh, combined before the rounding."""
    mm = matmul_dtype(X)
    n, d = X.shape
    wide = torch.float64
    A = torch.zeros((d, d), dtype=wide, device=X.device)
    b = torch.zeros((d,), dtype=wide, device=X.device)
    Xc = X.to(mm)
    yc = y.to(mm)
    B = GRAM_BLOCK_ROWS
    step = B * _BLOCKS_PER_CALL
    with true_f32_matmul():
        for s in range(0, n, step):
            e = min(n, s + step)
            nb = (e - s) // B
            if nb:
                Xb = Xc[s:s + nb * B].reshape(nb, B, d)
                yb = yc[s:s + nb * B].reshape(nb, B, 1)
                Xbt = Xb.transpose(1, 2)
                A += mm_acc(Xbt, Xb).sum(0, dtype=wide)
                b += mm_acc(Xbt, yb).sum(0, dtype=wide)[:, 0]
            if s + nb * B < e:  # the ragged last block
                Xr = Xc[s + nb * B:e]
                A += mm_acc(Xr.T, Xr).to(wide)
                b += mm_acc(Xr.T, yc[s + nb * B:e, None])[:, 0].to(wide)
    yy = y.to(wide)
    return A, b, torch.dot(yy, yy)


def _dot_hi(a: Tensor, b: Tensor, dtype) -> Tensor:
    """Cancellation-safe product: both operands at the statistics dtype,
    true f32 (the counterpart of ``tpu_sgd/ops/gram.py``'s ``_dot_hi``,
    which runs at ``Precision.HIGHEST``)."""
    with true_f32_matmul():
        return a.to(dtype) @ b.to(dtype)


def _solve(A, b, yty, n, reg_param: float):
    """Solve the regularized normal equations and return ``(w, loss)``.

    Objective matched to the SGD path's SquaredL2Updater semantics:
    ``(1/n)·Σ ½(x.w − y)² + (reg/2)·‖w‖²``.  A Gram that is not positive
    definite gives NaN weights, as the JAX package's Cholesky does, and
    ``optimize`` raises."""
    d = A.shape[0]
    An = A / n + reg_param * torch.eye(d, dtype=A.dtype, device=A.device)
    bn = b / n
    L, info = torch.linalg.cholesky_ex(An)
    z = torch.linalg.solve_triangular(L, bn[:, None], upper=False)
    w = torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]
    w = torch.where(info == 0, w, float("nan"))
    sd = A.dtype
    loss = (
        0.5 * (_dot_hi(w, _dot_hi(A, w, sd), sd) - 2.0 * _dot_hi(w, b, sd)
               + yty) / n
        + 0.5 * reg_param * _dot_hi(w, w, sd)
    )
    return w, loss


class NormalEquations(Optimizer):
    """Exact least-squares solver behind the Optimizer boundary: the
    least-squares family's drop-in alternative to ``GradientDescent``.
    ``reg_param`` is the L2 coefficient (0 = plain OLS).  ``device=None``
    runs on the card and raises without one."""

    def __init__(self, reg_param: float = 0.0, device=None):
        self.reg_param = float(reg_param)
        self.device = device
        #: None = AUTO: stream when host data exceed the device budget;
        #: True / False force the streamed totals / the resident pass
        self.host_streaming = None
        self.stream_batch_rows = None
        self.stream_resume_dir = None
        self._loss = None
        #: the data mesh of ``set_mesh`` (None: one device)
        self.mesh = None

    def set_reg_param(self, r: float):
        self.reg_param = float(r)
        return self

    def set_host_streaming(self, flag: bool = True, batch_rows: int = None,
                           resume_dir: str = None):
        """Exact least squares on host rows too large for the card: the
        Gram totals accumulate from host chunks streamed through the card
        with an f64 carry, every row counted, then the ``(d, d)`` solve.
        ``batch_rows`` caps the chunk exactly (default 64 blocks of 8,192
        rows; the block shrinks to a smaller cap).  ``resume_dir`` makes
        the pass resumable: the carry is saved every few chunks, and a
        pass stopped part way resumes to the same bits; like
        ``batch_rows`` it stays set.  ``flag=None`` restores AUTO
        placement; ``False`` forces the resident pass."""
        if batch_rows is not None:
            if int(batch_rows) < 1:
                raise ValueError(
                    f"batch_rows must be positive, got {batch_rows}")
            self.stream_batch_rows = int(batch_rows)
        if resume_dir is not None:
            self.stream_resume_dir = resume_dir
        self.host_streaming = None if flag is None else bool(flag)
        return self

    def set_mesh(self, mesh):
        """Accumulate the Gram by rows over a 1-D data mesh: each rank
        passes its own rows, the ranks combine their f64 sums in rank
        order, and every rank solves the same system.  A 2-D mesh raises
        ``ValueError``."""
        from tpu_sgd_torch.optimize.lbfgs import check_data_mesh

        self.mesh = check_data_mesh(mesh, "NormalEquations")
        return self

    @property
    def loss_history(self):
        """Length-1 loss history (the final objective)."""
        return self._loss

    def optimize(self, data: Dataset, initial_weights) -> Tensor:
        X, y = data
        if is_sparse(X):
            raise NotImplementedError(
                "NormalEquations needs dense features: the d x d Gram "
                "matrix is dense regardless of input sparsity (47k "
                "features -> 8.8 GB), so wide sparse problems should use "
                "GradientDescent/LBFGS/OWLQN instead"
            )
        dev = resolve_device(self.device)
        stream = self.host_streaming
        if stream is None and not (isinstance(X, torch.Tensor)
                                   and X.is_cuda):
            stream = self._auto_streams(X)
        if stream:
            # before any device conversion: X never lives on the card whole
            if np.shape(initial_weights)[-1] != X.shape[1]:
                raise ValueError(
                    f"initial_weights has length "
                    f"{np.shape(initial_weights)[-1]} but the data has "
                    f"{X.shape[1]} features")
            return self._optimize_host_streamed(X, y, dev)
        X = as_tensor(X, dev)
        if not X.dtype.is_floating_point or X.dtype == torch.float64:
            X = X.to(torch.float32)
        y = as_tensor(y, dev, torch.float32)
        width = (initial_weights.shape[-1]
                 if isinstance(initial_weights, torch.Tensor)
                 else np.shape(initial_weights)[-1])
        if width != X.shape[1]:
            raise ValueError(
                f"initial_weights has length {width} but the data has "
                f"{X.shape[1]} features"
            )
        if self.mesh is None:
            sums = _gram_sums(X.contiguous(), y)
        else:
            sums = self._meshed_gram_sums(X.contiguous(), y, dev)
        w, loss = _solve(*sums, self.reg_param)
        return self._finish(w, loss)

    def _auto_streams(self, X) -> bool:
        """AUTO placement (the JAX package's rule): stream the totals when
        the host data's bytes exceed the device budget.  On a mesh of one
        host every rank passes the whole dataset, so the budget is the
        ranks'; on several hosts each process holds its own rows on its
        one card, and the streamed totals are single-host, so AUTO warns
        and runs resident."""
        from tpu_sgd_torch.plan import device_budget, logger, mesh_budget

        n, d = X.shape
        dt = getattr(X, "dtype", np.float32)
        itemsize = (dt.itemsize if isinstance(dt, torch.dtype)
                    else np.dtype(dt).itemsize)
        data_bytes = n * d * itemsize + n * 4.0
        multihost = False
        if self.mesh is None:
            budget, _src = device_budget(self.device)
        else:
            from tpu_sgd_torch.parallel.mesh import (
                as_data_mesh,
                mesh_spans_processes,
            )

            mesh = as_data_mesh(self.mesh)
            budget, _src = mesh_budget()
            multihost = mesh_spans_processes(mesh)
            if not multihost:
                budget *= mesh.size
        stream = data_bytes > budget
        if stream and multihost:
            import warnings

            warnings.warn(
                f"data ({data_bytes / 1e9:.2f} GB/process) exceeds "
                f"the local-device budget ({budget / 1e9:.2f} GB) "
                "but the streamed totals build is single-host; "
                "committing resident and it may exhaust device "
                "memory — shrink the per-process rows or stream on "
                "a local mesh",
                RuntimeWarning, stacklevel=4,
            )
            stream = False
        if stream:
            logger.info(
                "plan: normal host_streamed — data "
                f"({data_bytes / 1e9:.2f} GB) exceeds the device "
                f"budget ({budget / 1e9:.2f} GB); Gram totals "
                "accumulate from host-streamed chunks (exact)"
            )
        return stream

    def _meshed_gram_sums(self, X, y, dev):
        """``(XᵀX, Xᵀy, yᵀy, n)`` of every rank's rows: this rank's f64
        sums and its row count combined in rank order, then rounded as
        :func:`_gram_sums` rounds one device's."""
        from tpu_sgd_torch.parallel.mesh import as_data_mesh, combine

        mesh = as_data_mesh(self.mesh)
        if mesh.backend == "nccl" and dev.type != "cuda":
            raise ValueError(
                f"an NCCL mesh combines on the card; this optimizer runs "
                f"on {dev} (use a gloo group for CPU ranks)")
        acc = acc_dtype(matmul_dtype(X))
        n = torch.full((), float(X.shape[0]), dtype=torch.float64,
                       device=dev)
        A, b, yty, n = combine(mesh, *_gram_sums_wide(X, y), n)
        return A.to(acc), b.to(acc), yty.to(acc), n.to(torch.float32)

    def _optimize_host_streamed(self, X, y, dev):
        """The exact solve from host-streamed Gram totals (see
        ``set_host_streaming``)."""
        Xh = host_tensor(X)
        n = Xh.shape[0]
        # the resident path's f32 (f64 rows train in f32, as the JAX
        # package computes with x64 off); the carry is f64 either way
        sd = torch.float32
        if self.mesh is not None:
            from tpu_sgd_torch.parallel.gram_parallel import (
                build_streamed_total_stats,
            )
            from tpu_sgd_torch.parallel.mesh import (
                as_data_mesh,
                require_single_host,
            )

            require_single_host(as_data_mesh(self.mesh),
                                "streamed normal totals")
            data = build_streamed_total_stats(
                self.mesh, Xh, y, batch_rows=self.stream_batch_rows,
                resume_dir=self.stream_resume_dir, device=dev)
            G, b, yy = data.G_tot.to(sd), data.b_tot, data.yy_tot
        else:
            B, chunk = streamed_totals_chunking(n, DEFAULT_BLOCK_ROWS,
                                                self.stream_batch_rows)
            G, b, yy = GramLeastSquaresGradient._streamed_totals(
                Xh, y, B, sd, chunk, device=dev,
                resume_dir=self.stream_resume_dir)
        w, loss = _solve(G, b.to(sd), yy.to(sd),
                         torch.full((), float(n), dtype=sd, device=dev),
                         self.reg_param)
        return self._finish(w, loss)

    def _finish(self, w, loss):
        """Rank deficiency surfaces here, and the loss history."""
        if not bool(torch.all(torch.isfinite(w))):
            raise FloatingPointError(
                "normal-equations solve produced non-finite weights: the "
                "Gram matrix is rank-deficient (collinear or constant "
                "features) and reg_param="
                f"{self.reg_param} does not regularize it; set a positive "
                "reg_param or drop redundant features"
            )
        self._loss = np.asarray([float(loss)], np.float32)
        return w
