"""Sharding rules of the sparse stack (counterpart of ``repro.distribution``)."""

from repro_torch.distribution.sharding import (  # noqa: F401
    ShardingRules,
    mesh_shard_count,
    row_block_axes,
)

__all__ = ["ShardingRules", "mesh_shard_count", "row_block_axes"]
