"""Config registry: ``get_config(name)`` / ``--arch <id>`` — counterpart of
``repro/configs``, the same eleven configurations."""

from __future__ import annotations

from repro_torch.configs import graphblas_mlp
from repro_torch.configs.base import (
    SHAPE_CELLS,
    AttentionConfig,
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeCell,
    SparsityConfig,
)

from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen15
from repro_torch.configs.gemma3_4b import CONFIG as _gemma3
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.llama3_2_1b import CONFIG as _llama32
from repro_torch.configs.internvl2_76b import CONFIG as _internvl2
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.jamba_v0_1_52b import CONFIG as _jamba

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _deepseek,
        _moonshot,
        _qwen15,
        _gemma3,
        _qwen2,
        _llama32,
        _internvl2,
        _rwkv6,
        _musicgen,
        _jamba,
    )
}

ASSIGNED_ARCHS = tuple(ARCHS)  # the 10 assigned architectures


def get_config(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name.startswith("graphblas-mlp"):
        return graphblas_mlp.CONFIG
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


__all__ = [
    "ARCHS",
    "ASSIGNED_ARCHS",
    "SHAPE_CELLS",
    "ShapeCell",
    "get_config",
    "ModelConfig",
    "AttentionConfig",
    "MoEConfig",
    "MambaConfig",
    "RWKVConfig",
    "SparsityConfig",
    "LayerSpec",
    "graphblas_mlp",
]
