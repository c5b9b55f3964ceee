"""Jamba-v0.1 52B [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]: 32L hybrid,
d_model 4096, Mamba:attention 7:1 (attn at period offset 4), MoE every
other layer (16 experts top-2, d_expert 14336), attn 32 heads GQA kv=8
(head_dim 128), Mamba d_state 16 / d_conv 4 / expand 2, vocab 65536.
Period of 8: [M, M(moe), M, M(moe), A, M(moe), M, M(moe)] × 4."""

from repro_torch.configs.base import (
    AttentionConfig,
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
)

_M = LayerSpec(mixer="mamba", ffn="dense")
_Mmoe = LayerSpec(mixer="mamba", ffn="moe")
_A = LayerSpec(mixer="attn", ffn="dense")
_Amoe = LayerSpec(mixer="attn", ffn="moe")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65_536,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_expert=14336,
        num_shared_experts=0,
        capacity_factor=1.25,
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    period=(_M, _Mmoe, _M, _Mmoe, _A, _Mmoe, _M, _Mmoe),
    max_seq_len=262_144,
    citation="arXiv:2403.19887",
)
