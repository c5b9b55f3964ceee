"""Gemma-3-4B [hf:google/gemma-3-4b-pt; Gemma-3 report]: 34L, d_model
2560, 8 heads GQA (kv=4, head_dim 256), d_ff 10240 (GeGLU), vocab
262144, 5:1 local:global interleave (window 1024), qk-norm, sandwich
(post) norms, rope theta 1M global / 10k local. 34 = 5·(5L+1G) + 4L."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

_LOCAL = LayerSpec(mixer="attn", ffn="dense", window=1024, rope_theta=10_000.0)
_GLOBAL = LayerSpec(mixer="attn", ffn="dense", window=0, rope_theta=1_000_000.0)

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    d_ff=10240,
    vocab_size=262_144,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        qk_norm=True,
        rope_theta=1_000_000.0,
    ),
    period=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, _GLOBAL),
    tail=(_LOCAL, _LOCAL, _LOCAL, _LOCAL),
    act="gelu",
    post_norms=True,
    tie_embeddings=True,
    max_seq_len=131_072,
    citation="hf:google/gemma-3-4b-pt",
)
