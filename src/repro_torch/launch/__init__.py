"""Meshes of the sparse stack's shards (counterpart of ``repro.launch``)."""

from repro_torch.launch.mesh import Mesh, make_row_blocks_mesh  # noqa: F401

__all__ = ["Mesh", "make_row_blocks_mesh"]
