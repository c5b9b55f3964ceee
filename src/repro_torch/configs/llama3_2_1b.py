"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B]: 16L, d_model 2048,
32 heads GQA (kv=8, head_dim 64), d_ff 8192, vocab 128256, tied
embeddings."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab_size=128_256,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        rope_theta=500_000.0,
    ),
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    tie_embeddings=True,
    max_seq_len=131_072,
    citation="hf:meta-llama/Llama-3.2-1B",
)
