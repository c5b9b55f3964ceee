"""Where the sparse stack's shard axis lands on a mesh — the row-block
part of ``repro/distribution/sharding.py``.

:class:`ShardingRules` holds the reference's two weight-axis fields
and defaults; :func:`row_block_axes` and
:func:`mesh_shard_count` resolve the ``row_blocks`` logical axis, the
shard count the partitioner and the sharded plans agree on. They read
only ``mesh.shape``, so any object with a name → size dict works.

The reference's ``sharded_csr_pspecs`` builds ``shard_map`` in_specs; the
port runs every shard from one process and has no in_specs to build.
The model rules (``param_pspecs``, ``embed_lookup``, ``constrain``, …)
and ``distribution/collectives.py`` serve the LLM trainer and models,
and wait with them (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ShardingRules:
    """Logical → mesh axis assignment: the reference's two weight-axis
    fields, all ``row_blocks`` resolves over. Its activation, cache and
    vocabulary fields, and the model axes ``resolve`` maps, serve the
    LLM models (ROADMAP Queue 1 item 7)."""

    fsdp_axis: str | None = "data"  # weight "replicated-ish" dims
    tp_axis: str | None = "model"  # heads / mlp / experts / vocab

    def resolve(self, logical: str | None) -> tuple[str, ...] | None:
        """Mesh axes of a logical axis: ``row_blocks`` is a dedicated
        "row_blocks" axis when the mesh has one
        (``launch.mesh.make_row_blocks_mesh``), else every compute axis."""
        if logical is None:
            return None
        if logical != "row_blocks":
            raise ValueError(f"unknown logical axis {logical!r} (the port resolves the "
                             "sparse stack's row_blocks only)")
        return ("row_blocks",) + tuple(a for a in (self.fsdp_axis, self.tp_axis) if a)


def row_block_axes(mesh, rules: ShardingRules | None = None) -> tuple[str, ...]:
    """Mesh axes the ``row_blocks`` logical axis lands on, in order:
    ``("row_blocks",)`` for a dedicated shard mesh, ``("data", "model")``
    style for compute meshes, ``()`` when nothing matches (unsharded)."""
    names = (rules or ShardingRules()).resolve("row_blocks")
    return tuple(a for a in names if a in mesh.shape)


def mesh_shard_count(mesh, rules: ShardingRules | None = None) -> int:
    """How many row-block shards this mesh carries (Π of the resolved
    ``row_blocks`` axes' sizes)."""
    n = 1
    for a in row_block_axes(mesh, rules):
        n *= mesh.shape[a]
    return n
