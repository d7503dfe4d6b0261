"""Data-parallel training on sparse (CSR) features: the port of
``tpu_sgd/parallel/sparse_parallel.py``.

Each rank holds its contiguous row block as CSR, plus the transposed copy
that the CSR kernel's gradient product reads (``ops/sparse.py``).  The
JAX package pads every shard's BCOO block to one entry count, because
``shard_map`` needs one static local shape; ranks here are separate
programs, so their entry counts may differ and nothing is padded but the
rows: the ranks agree on the longest rank's row count (and on the
feature count) by a gather, shorter blocks gain empty rows, and a
``valid`` mask drops them, as on the dense path.  From there the step and
the run are the dense path's (``parallel/data_parallel.py``): the CSR
products per rank, one rank-order combine a step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpu_sgd_torch.device import as_tensor, resolve_device
from tpu_sgd_torch.ops.sparse import _csr, to_csr, transpose_csr
from tpu_sgd_torch.parallel.data_parallel import agree, dp_run_fn, dp_step_fn
from tpu_sgd_torch.parallel.mesh import Mesh, as_data_mesh

Tensor = torch.Tensor


def shard_csr(mesh: Mesh, X, y, device=None
              ) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """This rank's local sparse rows on ``device`` (``None``: the card)
    as CSR padded with empty rows to the longest rank's count: ``(X, Xt,
    y, valid)`` with ``Xt`` the transposed CSR and ``valid`` None when
    every rank has the same count.  Raises when the ranks disagree on the
    feature count (pin ``num_features`` when loading)."""
    mesh = as_data_mesh(mesh)
    dev = resolve_device(device)
    X = to_csr(as_tensor(X, dev))
    y = as_tensor(y, dev)
    n, d = X.shape
    counts = agree(mesh, [n, d], dev)
    if counts[:, 1].min() != counts[:, 1].max():
        raise ValueError(
            "ranks disagree on the feature count "
            f"({sorted(set(counts[:, 1].tolist()))}); pass an explicit "
            "num_features to the loader so every rank builds the same "
            "dimensionality")
    target = int(counts[:, 0].max())
    valid = None
    if int(counts[:, 0].min()) != target:
        crow = X.crow_indices()
        X = _csr(torch.cat([crow, crow[-1:].expand(target - n)]),
                 X.col_indices(), X.values(), (target, d))
        y = torch.cat([y, y.new_zeros((target - n,))])
        valid = torch.arange(target, device=dev) < n
    return X, transpose_csr(X), y, valid


#: the dense builders serve CSR rows unchanged (the products dispatch on
#: the layout); the JAX package needed twins to rebuild each shard's BCOO
sparse_dp_step_fn = dp_step_fn
sparse_dp_run_fn = dp_run_fn
