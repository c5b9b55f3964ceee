"""The model stack (counterpart of ``repro.models``): configs' layer
patterns built into attention, MoE, SSM and FFN layers, with the paper's
sparse FFN weights running on the SpMM kernels."""

from repro_torch.models.model import Model, build, cast_floating  # noqa: F401

__all__ = ["Model", "build", "cast_floating"]
