"""Moonlight-16B-A3B (Kimi/Moonshot, DeepSeek-V3-style MoE).
[hf:moonshotai/Moonlight-16B-A3B]: 48L(+embed norm), d_model 2048,
16 heads (MHA kv=16, head_dim 128), 64 routed experts top-6
(moe_intermediate 1408) + 2 shared, first layer dense (intermediate
11264), vocab 163840."""

from repro_torch.configs.base import (
    AttentionConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
)

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    d_ff=11264,
    vocab_size=163_840,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        rope_theta=50_000.0,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        capacity_factor=1.25,
    ),
    head=(LayerSpec(mixer="attn", ffn="dense"),),
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    max_seq_len=8192,
    citation="hf:moonshotai/Moonlight-16B-A3B",
)
