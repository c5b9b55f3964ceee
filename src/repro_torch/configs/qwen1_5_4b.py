"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B; arXiv:2309.16609 family]: 40L,
d_model 2560, 20 heads MHA (kv=20, head_dim 128), d_ff 6912, vocab
151936, QKV bias (Qwen signature)."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    d_ff=6912,
    vocab_size=151_936,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        qkv_bias=True,
        rope_theta=5_000_000.0,
    ),
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    max_seq_len=32_768,
    citation="hf:Qwen/Qwen1.5-4B",
)
