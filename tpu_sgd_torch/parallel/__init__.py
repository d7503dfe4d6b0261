"""Data parallelism over ``torch.distributed``: the port of
``tpu_sgd/parallel/`` (first part: the data mesh, dense and sparse meshed
SGD and the meshed observed driver; ROADMAP A5)."""

from tpu_sgd_torch.parallel.data_parallel import (
    dp_optimize,
    local_rows,
    pad_to_multiple,
    shard_dataset,
)
from tpu_sgd_torch.parallel.distributed import (
    global_data_mesh,
    global_mesh_2d,
    initialize_distributed,
    process_count,
    process_index,
)
from tpu_sgd_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    as_data_mesh,
    combine_sums,
    data_mesh,
    has_model_axis,
    make_mesh,
    rank_order_sum,
)
from tpu_sgd_torch.parallel.sparse_parallel import shard_csr, sparse_dp_run_fn

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "as_data_mesh",
    "combine_sums",
    "data_mesh",
    "has_model_axis",
    "make_mesh",
    "rank_order_sum",
    "dp_optimize",
    "local_rows",
    "pad_to_multiple",
    "shard_dataset",
    "shard_csr",
    "sparse_dp_run_fn",
    "initialize_distributed",
    "global_data_mesh",
    "global_mesh_2d",
    "process_count",
    "process_index",
]
