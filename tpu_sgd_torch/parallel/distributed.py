"""Process-group bring-up: the port of ``tpu_sgd/parallel/distributed.py``.

The JAX package brings up ``jax.distributed`` and then runs the same
``psum`` over a bigger mesh.  Here the substrate is a
``torch.distributed`` process group, one process per device:

    initialize_distributed("tcp://host:port", world_size, rank)
    mesh = global_data_mesh()
    LinearRegressionWithSGD.train((X_local, y_local), mesh=mesh)

or, under ``torchrun --nproc-per-node N``, ``initialize_distributed()``
with no arguments: it reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` from the environment, as JAX detects a pod.

The backend is NCCL when CUDA is available, else gloo.  NCCL refuses two
ranks on one card, so several ranks sharing one card ask for gloo
explicitly (``backend="gloo"``); gloo is never chosen silently after an
NCCL failure.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from tpu_sgd_torch.parallel.mesh import Mesh, data_mesh, make_mesh


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Bring up the default process group (idempotent: a second call is a
    no-op).  ``init_method`` defaults to ``env://`` (torchrun's
    variables); ``world_size`` and ``rank`` to ``WORLD_SIZE`` and ``RANK``.
    With NCCL the process drives card ``LOCAL_RANK`` (else ``rank``)
    modulo the cards it sees."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=int(world_size), rank=int(rank))


def global_data_mesh() -> Mesh:
    """1-D data mesh over every rank of the job."""
    return data_mesh()


def global_mesh_2d(n_model: int = 1) -> Mesh:
    """``(data, model)`` mesh over every rank of the job; raises when
    ``n_model`` does not divide the rank count, since idling the remainder
    would hide lost parallelism."""
    world = process_count()
    if world % n_model:
        raise ValueError(
            f"n_model={n_model} does not divide the {world}-rank job; "
            "choose a divisor")
    return make_mesh(n_data=world // n_model, n_model=n_model)


def process_count() -> int:
    """Ranks in the job (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0
