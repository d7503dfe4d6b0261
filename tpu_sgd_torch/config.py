"""Configuration: the port of ``tpu_sgd/config.py``.

``SGDConfig``, ``MeshConfig`` and the process-wide ``ServingConfig``
(the serving plane's admission knobs, read by
``serve.batcher.MicroBatcher``).  ``SGDConfig``'s defaults and validation
match the JAX package exactly: step=1.0, iters=100, reg=0.0, frac=1.0,
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


def _default_shed_utilization():
    # interactive deliberately absent: the premium lane sheds only at
    # queue-full-with-no-victim (serve/batcher.py documents the order)
    return {"batch": 0.75, "shadow": 0.50}


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving-plane admission knobs.

    ``shed_utilization`` maps lane -> queue-utilization fraction at which
    NEW arrivals to that lane are shed.  A batcher built with
    ``shed_utilization=None`` reads the PROCESS config here at
    construction; a RUNNING batcher is actuated through
    ``MicroBatcher.set_shed_utilization``.
    """

    shed_utilization: dict = dataclasses.field(
        default_factory=_default_shed_utilization)

    def __post_init__(self):
        for lane, thr in self.shed_utilization.items():
            if not (0.0 < float(thr) <= 1.0):
                raise ValueError(
                    f"shed_utilization[{lane!r}] must be in (0, 1], "
                    f"got {thr}")

    def replace(self, **kwargs) -> "ServingConfig":
        return dataclasses.replace(self, **kwargs)


_SERVING_CONFIG = ServingConfig()


def serving_config() -> ServingConfig:
    """The process-wide serving config new batchers default to."""
    return _SERVING_CONFIG


def set_serving_config(cfg: ServingConfig) -> ServingConfig:
    """Install a new process-wide serving config (returns the previous
    one, for scoped restore in tests).  Affects batchers constructed
    AFTER the call; running ones are actuated via their own
    ``set_shed_utilization``."""
    global _SERVING_CONFIG
    if not isinstance(cfg, ServingConfig):
        raise TypeError(f"expected ServingConfig, got {type(cfg).__name__}")
    prev = _SERVING_CONFIG
    _SERVING_CONFIG = cfg
    return prev
