"""Sharding rules and collectives (counterpart of ``repro.distribution``)."""

from repro_torch.distribution.sharding import (  # noqa: F401
    PartitionSpec,
    ShardingRules,
    batch_pspecs,
    cache_pspecs,
    mesh_shard_count,
    param_pspecs,
    row_block_axes,
    shardings_for,
)

__all__ = ["PartitionSpec", "ShardingRules", "batch_pspecs", "cache_pspecs",
           "mesh_shard_count", "param_pspecs", "row_block_axes", "shardings_for"]
