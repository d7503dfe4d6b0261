"""The data mesh and its combine: the port of ``tpu_sgd/parallel/mesh.py``.

The JAX package's mesh is a ``jax.sharding.Mesh`` of devices in one
program, and ``lax.psum`` inside ``shard_map`` combines the shards.  Here
one process drives one device, PyTorch's idiom, so the JAX package's
multi-host rule is the only rule: a mesh is a ``torch.distributed``
process group, each rank holds its own rows, and the ranks combine their
sums with a collective.

:class:`Mesh` is a thin description: its axes' sizes, the data group
(``None``: the default group) and, on a 2-D mesh, the model group.
``torch.distributed``'s ``DeviceMesh`` would need a live process group
even to describe a shape; a mesh here is built collectively only where
it runs (:func:`make_mesh`).  Ranks lie row-major over ``(data,
model)``: rank ``= data_index * n_model + model_index``.  The data group
of a rank is its model column (the ranks of one model index), the model
group its data row (the ranks of one data index): every rank calls
``dist.new_group`` for every column and every row in the same order.

The combine (:func:`combine_sums`, the counterpart of the ``psum`` of
``(grad_sum, loss_sum, count)``) all-gathers every rank's sums and adds
the shards one rank at a time, in rank order, with explicit elementwise
adds (:func:`rank_order_sum`), never a reduction over the rank axis, whose
order differs between the CPU and the card.  So the result is bitwise
independent of the backend, of NCCL's algorithm and of the ring layout,
and equals a one-process rank-order sum of the same shards.  NCCL gathers
on the card (and may be captured in a CUDA graph); gloo gathers host
tensors only, so a card's vector goes through the host, and the adds run
there in the same order, with the same bits.  :func:`combine_model`
is the same gather and the same adds over the model group: the
counterpart of the JAX package's ``psum`` over its ``model`` axis (the
partial margins, the reg value, the convergence norms).

The compressed combine (:func:`combine_topk`, the JAX package's
all-gather of top-k ``(values, indices)`` segments and scatter-add) is
one gather of ``2·k`` 32-bit entries a rank, then each rank's segment
added into a dense zero vector in rank order.  Indices are unique
within a segment, so each add is a gather, an add and a store
(``index_put_`` without accumulation), never a float atomic.

Hosts: ranks on one host stand for the JAX package's one process, whose
streamed routes read one host dataset; :func:`mesh_spans_processes`
tells a mesh whose ranks lie on more than one host (the JAX package's
multi-process regime).  A mesh learns its ranks' hosts from one gather
of each rank's host name, or takes them declared (``hosts=``).
"""

from __future__ import annotations

import socket
import zlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``(data[, model])`` mesh of ranks: ``shape`` maps each axis name
    to its size, ``group`` is the process group of the data axis (``None``:
    the default group) and ``model_group`` that of the model axis (a 2-D
    mesh with ``n_model > 1``; :func:`make_mesh` builds both).  Ranks lie
    row-major over ``(data, model)``, as the JAX package's ``make_mesh``
    lays out its devices.  ``hosts``: each data rank's host, in rank
    order (any hashable labels), when the caller declares them; else the
    first :func:`mesh_spans_processes` gathers them."""

    def __init__(self, shape: dict, group=None, model_group=None,
                 hosts: Optional[Sequence] = None):
        if DATA_AXIS not in shape:
            raise ValueError(f"a mesh needs a '{DATA_AXIS}' axis, got "
                             f"{tuple(shape)}")
        for name, size in shape.items():
            if name not in (DATA_AXIS, MODEL_AXIS) or int(size) < 1:
                raise ValueError(f"bad mesh axis {name}={size}")
        self.shape = {k: int(v) for k, v in shape.items()}
        self.group = group
        self.model_group = model_group
        self._backend = None
        if hosts is not None and len(hosts) != self.shape[DATA_AXIS]:
            raise ValueError(
                f"hosts names {len(hosts)} ranks, the data axis has "
                f"{self.shape[DATA_AXIS]}")
        self.hosts = None if hosts is None else tuple(hosts)

    @property
    def size(self) -> int:
        """Ranks on the data axis."""
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        """Ranks on the model axis (1 on a data mesh)."""
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def rank(self) -> int:
        """This process's index on the data axis: its shard of rows (the
        model ranks of one data row share it, and so their sample)."""
        return dist.get_rank(self.group)

    @property
    def model_index(self) -> int:
        """This process's index on the model axis: its block of
        features."""
        if self.model_group is None:
            return 0
        return dist.get_rank(self.model_group)

    @property
    def backend(self) -> str:
        if self._backend is None:
            self._backend = str(dist.get_backend(self.group))
        return self._backend

    def __repr__(self):
        return f"Mesh({self.shape})"


def _world(group) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: call "
            "tpu_sgd_torch.parallel.initialize_distributed(...) first, or "
            "run under torchrun")
    return dist.get_world_size(group)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              group=None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of ``group`` (default: all
    ranks), ``n_data`` defaulting to ``world // n_model``.  One process
    drives one device, so the mesh covers the group exactly: a rank
    outside it would idle.  With ``n_model > 1`` this is collective: every
    rank of ``group`` builds the ``n_model`` column groups (the data
    groups) and then the ``n_data`` row groups (the model groups), in that
    order, and keeps its own two."""
    world = _world(group)
    if n_data is None:
        n_data = world // n_model
    n = n_data * n_model
    if n != world:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n} ranks, the group has "
            f"{world}")
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    if n_model == 1:
        return Mesh(shape, group)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    me = ranks.index(dist.get_rank())
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group([ranks[d * n_model + m] for d in range(n_data)])
        if me % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([ranks[d * n_model + m] for m in range(n_model)])
        if me // n_model == d:
            model_group = g
    return Mesh(shape, data_group, model_group)


def data_mesh(group=None, hosts: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every rank of ``group`` (default: all ranks) on the
    'data' axis; ``hosts`` declares each rank's host (see :class:`Mesh`)."""
    return Mesh({DATA_AXIS: _world(group)}, group, hosts=hosts)


def has_model_axis(mesh) -> bool:
    """True when the mesh shards the FEATURE axis (a 2-D mesh with a
    non-trivial 'model' dimension)."""
    return mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1


def as_data_mesh(mesh):
    """The 1-D data view of a mesh: a data-only mesh passes through, a
    trivial (size-1) 'model' axis is flattened away, and a sharded one
    raises ``NotImplementedError`` (the data-only builders)."""
    if mesh is None or set(mesh.shape) == {DATA_AXIS}:
        return mesh
    if has_model_axis(mesh):
        raise NotImplementedError(
            f"this operation composes with a 1-D '{DATA_AXIS}' mesh; "
            f"got axes {tuple(mesh.shape)}")
    return Mesh({DATA_AXIS: mesh.size}, mesh.group, hosts=mesh.hosts)


#: the one-buffer gather: ``all_gather_single`` where torch has it (the
#: new name of ``all_gather_into_tensor``, which warns there)
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


def _gather(group, size: int, backend: str, t: torch.Tensor
            ) -> torch.Tensor:
    if backend != "nccl" and t.is_cuda:
        t = t.cpu()
    t = t.contiguous()
    out = torch.empty((size * t.numel(),), dtype=t.dtype, device=t.device)
    _gather_into(out, t, group=group)
    return out.view(size, t.numel())


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every data rank's 1-D ``t`` stacked in rank order, ``(ranks,
    len(t))``, by one collective into one buffer.  NCCL gathers on the
    card; gloo gathers host tensors, so a card's tensor goes through the
    host and the result stays there."""
    return _gather(mesh.group, mesh.size, mesh.backend, t)


def rank_order_sum(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, one elementwise add at a time in
    list order: the one summation order of the combine, wherever it runs."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def flatten_parts(*parts) -> torch.Tensor:
    """``parts`` flattened into one vector at their common (promoted)
    dtype: what one rank contributes to :func:`combine`."""
    dt = parts[0].dtype
    for p in parts[1:]:
        dt = torch.promote_types(dt, p.dtype)
    return torch.cat([p.reshape(-1).to(dt) for p in parts])


def split_parts(total: torch.Tensor, parts) -> tuple:
    """The inverse of :func:`flatten_parts`: ``total`` cut back into
    ``parts``' shapes and dtypes, on ``parts[0]``'s device."""
    total = total.to(parts[0].device)
    out, k = [], 0
    for p in parts:
        out.append(total[k:k + p.numel()].reshape(p.shape).to(p.dtype))
        k += p.numel()
    return tuple(out)


def combine(mesh: Mesh, *parts, axis: str = DATA_AXIS):
    """The rank-order sum of each of ``parts`` over the ranks of ``axis``:
    one gather of the flattened parts at their common dtype, then
    :func:`rank_order_sum`; the same sums, bitwise, on every rank of the
    axis, back at each part's shape, dtype and device.  (The replica
    store's τ=0 round adds its workers' flattened parts the same way.)"""
    flat = flatten_parts(*parts)
    if axis == DATA_AXIS:
        got = all_gather(mesh, flat)
    else:
        got = _gather(mesh.model_group, mesh.n_model, mesh.backend, flat)
    return split_parts(rank_order_sum(got.unbind(0)), parts)


def combine_sums(mesh: Mesh, g, l, c):
    """The data-axis combine of one rank's ``(grad_sum, loss_sum, count)``
    (the JAX package's ``lax.psum``): :func:`combine` of the three, one
    gather of the ``(numel(g) + 2)`` vector.  Shape-generic (matrix
    weights too)."""
    return combine(mesh, g, l, c)


def gather_model(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every model rank's 1-D ``t`` stacked in model-rank order,
    ``(n_model, len(t))``, on ``t``'s device (a 2-D mesh's weight blocks
    put back together)."""
    return _gather(mesh.model_group, mesh.n_model, mesh.backend,
                   t).to(t.device)


def combine_model(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The model-axis combine of ``t`` (partial margins, a reg value, a
    squared norm): the JAX package's ``psum`` over ``model``, in
    model-rank order."""
    return combine(mesh, t, axis=MODEL_AXIS)[0]


def any_rank(mesh: Mesh, flag: bool, device) -> bool:
    """True on every rank when ``flag`` is True on any rank: one gather of
    one int on the collective's own device, read back on the host, so it
    is also a host barrier (NCCL's gather alone only queues on the
    card's stream)."""
    got = all_gather(mesh, torch.full((1,), int(bool(flag)),
                                      dtype=torch.int32, device=device))
    return bool(got.cpu().any())


def barrier(mesh: Mesh, device) -> None:
    """Return once every rank of the mesh has reached it, on the host."""
    any_rank(mesh, False, device)


def collective_device(mesh: Mesh) -> torch.device:
    """Where this mesh's collectives take their tensors: the card under
    NCCL, the host under gloo."""
    if mesh.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host_label() -> int:
    return zlib.crc32(socket.gethostname().encode())


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the data ranks of ``mesh`` lie on more than one host:
    the JAX package's multi-process regime, where each rank streams its
    own local rows.  Ranks on one host act as the JAX package's one
    process (they read one host dataset).  The hosts are the mesh's
    declared ones, else gathered once (collective: every rank of the
    mesh calls it at the same point) and kept on the mesh."""
    if mesh.hosts is None:
        got = all_gather(mesh, torch.tensor(
            [_host_label()], dtype=torch.int64,
            device=collective_device(mesh)))
        mesh.hosts = tuple(int(v) for v in got[:, 0].cpu())
    return len(set(mesh.hosts)) > 1


def require_single_host(mesh: Mesh, what: str) -> None:
    """Raise the JAX package's message when ``mesh`` spans hosts: the
    streamed routes that read one host dataset (``what``: their name,
    plural) run on the ranks of one host."""
    if mesh_spans_processes(mesh):
        raise NotImplementedError(
            f"{what} build single-host; on a multi-host job run the "
            "resident meshed path, or stream on a mesh of this process's "
            "devices")


def combine_topk(mesh: Mesh, vals: torch.Tensor, idx: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """The compressed combine: every data rank's top-k segment (``vals``
    f32 and ``idx``, both ``(k,)``, the indices unique) gathered in one
    collective of ``2·k`` 32-bit entries a rank, then added into a dense
    f32 ``(dim,)`` zero vector one rank at a time, in rank order, each
    add a gather, an add and a store at the segment's indices.  The same
    bits on every rank, on ``vals``' device."""
    k = vals.numel()
    seg = torch.cat([vals.to(torch.float32).reshape(-1).view(torch.int32),
                     idx.to(torch.int32).reshape(-1)])
    got = all_gather(mesh, seg).to(vals.device)
    total = torch.zeros((int(dim),), dtype=torch.float32, device=vals.device)
    for r in range(got.shape[0]):
        v = got[r, :k].view(torch.float32)
        i = got[r, k:].to(torch.int64)
        total.index_put_((i,), total.index_select(0, i) + v)
    return total
