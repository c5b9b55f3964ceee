"""InternVL2-Llama3-76B LM backbone [arXiv:2404.16821]: the language
tower is Hermes-2-Theta-Llama-3-70B — 80L, d_model 8192, 64 heads GQA
(kv=8, head_dim 128), d_ff 28672, vocab 128256. The InternViT-6B vision
frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch/text embeddings (B, S, d_model)."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    d_ff=28672,
    vocab_size=128_256,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500_000.0,
    ),
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    input_mode="embeddings",
    max_seq_len=32_768,
    citation="arXiv:2404.16821",
)
