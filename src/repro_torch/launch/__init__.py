"""Meshes and launchers (counterpart of ``repro.launch``)."""

from repro_torch.launch.mesh import (  # noqa: F401
    Mesh,
    make_local_mesh,
    make_production_mesh,
    make_row_blocks_mesh,
)

__all__ = ["Mesh", "make_local_mesh", "make_production_mesh", "make_row_blocks_mesh"]
