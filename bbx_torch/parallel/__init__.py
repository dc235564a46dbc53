"""Data parallelism over `torch.distributed`: counterpart of `bbx/parallel`.

One process a device; each rank owns a contiguous shard of the env fleet,
every rank draws from the same generators at the global batch's shape and
keeps its rows, and the update's gradients, batch statistics and metrics
are reduced across ranks (`collectives`).
"""
from .collectives import (
    agree,
    all_reduce_max,
    all_reduce_sum,
    broadcast_from_primary,
    gather_to_primary,
    reduce_gradients,
)
from .distributed import (
    global_env_count,
    host_env_slice,
    initialize_multihost,
    is_primary,
    rank,
    world_size,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    BatchShard,
    Mesh,
    make_mesh,
    mesh_from_config,
    replicate_tree,
    shard_batched_tree,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "BatchShard",
    "Mesh",
    "agree",
    "all_reduce_max",
    "all_reduce_sum",
    "broadcast_from_primary",
    "gather_to_primary",
    "global_env_count",
    "host_env_slice",
    "initialize_multihost",
    "is_primary",
    "make_mesh",
    "mesh_from_config",
    "rank",
    "reduce_gradients",
    "replicate_tree",
    "shard_batched_tree",
    "world_size",
]
