"""Data and feature parallelism over ``torch.distributed``: the port of
``tpu_sgd/parallel/`` (the data mesh, dense and sparse meshed SGD, the
meshed observed driver, the 2-D ``(data, model)`` mesh and the resident
sufficient statistics on a data mesh; the streamed half is ROADMAP
A5)."""

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
from tpu_sgd_torch.parallel.gram_parallel import (
    build_sharded_gram_stats,
    build_sharded_total_stats,
    dp_gram_run_fn,
)
from tpu_sgd_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    as_data_mesh,
    combine,
    combine_model,
    combine_sums,
    data_mesh,
    gather_model,
    has_model_axis,
    make_mesh,
    rank_order_sum,
)
from tpu_sgd_torch.parallel.model_parallel import (
    dp_mp_optimize,
    dp_mp_run_fn,
    feature_block,
    pad_features_to_multiple,
)
from tpu_sgd_torch.parallel.sparse_parallel import shard_csr, sparse_dp_run_fn

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "as_data_mesh",
    "combine",
    "combine_model",
    "combine_sums",
    "data_mesh",
    "gather_model",
    "has_model_axis",
    "make_mesh",
    "rank_order_sum",
    "dp_optimize",
    "local_rows",
    "pad_to_multiple",
    "shard_dataset",
    "shard_csr",
    "sparse_dp_run_fn",
    "build_sharded_gram_stats",
    "build_sharded_total_stats",
    "dp_gram_run_fn",
    "dp_mp_optimize",
    "dp_mp_run_fn",
    "feature_block",
    "pad_features_to_multiple",
    "initialize_distributed",
    "global_data_mesh",
    "global_mesh_2d",
    "process_count",
    "process_index",
]
