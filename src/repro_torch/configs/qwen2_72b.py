"""Qwen2-72B [arXiv:2407.10671; hf:Qwen/Qwen2-72B]: 80L, d_model 8192,
64 heads GQA (kv=8, head_dim 128), d_ff 29568, vocab 152064, QKV bias."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152_064,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    ),
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    max_seq_len=131_072,
    citation="arXiv:2407.10671",
)
