"""Configuration of mini-batch SGD: the port of ``tpu_sgd/config.py``.

``SGDConfig`` and ``MeshConfig``; ``ServingConfig`` waits for the serving
slice (ROADMAP A10).  ``SGDConfig``'s defaults and validation match the
JAX package exactly: step=1.0, iters=100, reg=0.0, frac=1.0,
convTol=0.001 (the reference's ``GradientDescent`` defaults).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    """Hyper-parameters of mini-batch SGD, with the reference's defaults.

    Attributes:
      step_size: initial step size; decays as ``step_size / sqrt(iter)``
        inside the updaters.
      num_iterations: number of outer SGD iterations.
      reg_param: regularization strength handed to the updater.
      mini_batch_fraction: sampling fraction per iteration.
      convergence_tol: early-exit tolerance on the relative weight delta,
        ``||w_new - w_old|| < tol * max(||w_new||, 1)``.
      seed: base seed; iteration ``i`` draws from a ``torch.Generator``
        seeded from ``(seed, i)``, so a sample depends on nothing else.
      sampling: ``"bernoulli"`` (a per-row Bernoulli mask, normalized by
        the realized count), ``"indexed"`` (``round(frac * n)`` rows
        gathered with replacement) or ``"sliced"`` (a contiguous window of
        ``round(frac * n)`` rows at a random start, read in place by the
        window kernel; assumes row order carries no signal).
    """

    step_size: float = 1.0
    num_iterations: int = 100
    reg_param: float = 0.0
    mini_batch_fraction: float = 1.0
    convergence_tol: float = 0.001
    seed: int = 42
    sampling: str = "bernoulli"

    def __post_init__(self):
        if self.sampling not in ("bernoulli", "indexed", "sliced"):
            raise ValueError(
                "sampling must be 'bernoulli', 'indexed' or 'sliced', "
                f"got {self.sampling!r}"
            )
        if not (0.0 < self.mini_batch_fraction <= 1.0):
            raise ValueError(
                "mini_batch_fraction must be in (0, 1], got "
                f"{self.mini_batch_fraction}"
            )
        if self.num_iterations < 1:
            raise ValueError(
                f"num_iterations must be >= 1, got {self.num_iterations}"
            )
        if self.step_size <= 0.0:
            raise ValueError(
                f"step_size must be positive, got {self.step_size}"
            )
        if self.reg_param < 0.0:
            raise ValueError(
                f"reg_param must be >= 0, got {self.reg_param}"
            )
        if not (0.0 <= self.convergence_tol <= 1.0):
            raise ValueError(
                "convergence_tol must be in [0, 1], got "
                f"{self.convergence_tol}"
            )

    def replace(self, **kwargs) -> "SGDConfig":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Shape of the mesh of ranks the optimizer runs over: ``data`` ranks
    on the example axis (data parallelism, the reference's only axis) by
    ``model`` ranks on the feature axis (described here; runs on it are
    ROADMAP A5's second part).  Each rank is one process driving one
    device (``parallel/mesh.py``)."""

    data: int = 1
    model: int = 1

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={self.data}, "
                f"model={self.model}")

    def build(self, group=None):
        """The ``parallel.Mesh`` this config describes over the ranks of
        ``group`` (default: all ranks; needs a process group)."""
        from tpu_sgd_torch.parallel.mesh import make_mesh

        return make_mesh(n_data=self.data, n_model=self.model, group=group)

    @property
    def n_devices(self) -> int:
        return self.data * self.model
