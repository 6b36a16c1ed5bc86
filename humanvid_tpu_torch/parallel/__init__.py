"""Data parallelism on ``torch.distributed``: process groups, meshes, batch
rows, ZeRO-1 sharding and the bucketed collectives (``mesh``), and a
launcher of N ranks from one process (``launch``)."""

from .mesh import (
    BATCH_AXES,
    DATA,
    REPLICA,
    ZERO1_MIN_SIZE,
    CommStats,
    data_parallel_world,
    init_distributed,
    make_hierarchical_mesh,
    make_mesh,
    rank,
    rank_rows,
    replicate,
    world_size,
    zero1_opt_sharding,
)

__all__ = [
    "BATCH_AXES", "CommStats", "DATA", "REPLICA", "ZERO1_MIN_SIZE", "data_parallel_world",
    "init_distributed", "make_hierarchical_mesh", "make_mesh", "rank", "rank_rows", "replicate",
    "world_size", "zero1_opt_sharding",
]
