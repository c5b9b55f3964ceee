"""Sharding rules and collectives (counterpart of ``repro.distribution``)."""

from repro_torch.distribution.sharding import (  # noqa: F401
    PartitionSpec,
    Placed,
    Sharding,
    ShardingRules,
    batch_pspecs,
    cache_pspecs,
    mesh_shard_count,
    param_pspecs,
    place,
    row_block_axes,
    shardings_for,
    split_batch,
)

__all__ = ["PartitionSpec", "Placed", "Sharding", "ShardingRules", "batch_pspecs",
           "cache_pspecs", "mesh_shard_count", "param_pspecs", "place", "row_block_axes",
           "shardings_for", "split_batch"]
