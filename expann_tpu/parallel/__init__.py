from expann_tpu.parallel.sharded import (
    ShardedFlat,
    ShardedIndex,
    build_sharded,
    build_sharded_flat,
    make_mesh,
    replicated_query_dp,
    sharded_build_step,
    sharded_flat_query,
    sharded_query_batch,
)

__all__ = [
    "ShardedFlat",
    "ShardedIndex",
    "build_sharded",
    "build_sharded_flat",
    "make_mesh",
    "replicated_query_dp",
    "sharded_build_step",
    "sharded_flat_query",
    "sharded_query_batch",
]
