"""Data and feature parallelism over ``torch.distributed``: the port of
``tpu_sgd/parallel/`` (the data mesh, dense and sparse meshed SGD, the
meshed observed driver, the compressed top-k combine, the 2-D ``(data,
model)`` mesh, and the sufficient statistics on a data mesh, resident
and streamed from host rows)."""

from tpu_sgd_torch.parallel.data_parallel import (
    dp_compressed_shared_superstep_fn,
    dp_compressed_step_fn,
    dp_compressed_superstep_fn,
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
    build_streamed_sharded_gram_stats,
    build_streamed_total_stats,
    dp_gram_run_fn,
    dp_virtual_gram_run_fn,
)
from tpu_sgd_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    as_data_mesh,
    combine,
    combine_model,
    combine_sums,
    combine_topk,
    data_mesh,
    gather_model,
    has_model_axis,
    make_mesh,
    mesh_spans_processes,
    rank_order_sum,
    require_single_host,
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
    "combine_topk",
    "data_mesh",
    "gather_model",
    "has_model_axis",
    "make_mesh",
    "mesh_spans_processes",
    "rank_order_sum",
    "require_single_host",
    "dp_compressed_shared_superstep_fn",
    "dp_compressed_step_fn",
    "dp_compressed_superstep_fn",
    "dp_optimize",
    "local_rows",
    "pad_to_multiple",
    "shard_dataset",
    "shard_csr",
    "sparse_dp_run_fn",
    "build_sharded_gram_stats",
    "build_sharded_total_stats",
    "build_streamed_sharded_gram_stats",
    "build_streamed_total_stats",
    "dp_gram_run_fn",
    "dp_virtual_gram_run_fn",
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
