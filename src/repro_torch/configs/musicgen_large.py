"""MusicGen-large decoder [arXiv:2306.05284; hf:facebook/musicgen-large]:
48L, d_model 2048, 32 heads MHA (kv=32, head_dim 64), d_ff 8192 (GELU,
non-gated), vocab 2048 (EnCodec codebook). The EnCodec tokenizer +
codebook-interleaving frontend is a STUB per the assignment:
``input_specs`` supplies precomputed frame embeddings (sum of the 4
codebook embeddings)."""

from repro_torch.configs.base import AttentionConfig, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    d_ff=8192,
    vocab_size=2048,
    attention=AttentionConfig(
        kind="gqa",
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        rope_theta=10_000.0,
    ),
    period=(LayerSpec(mixer="attn", ffn="dense"),),
    act="gelu",
    glu=False,
    input_mode="embeddings",
    max_seq_len=32_768,
    citation="arXiv:2306.05284",
)
