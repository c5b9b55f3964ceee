"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b]: 32L,
d_model 2560, attention-free time-mix with data-dependent decay (40
heads of 64), channel-mix d_ff 8960 (3.5×), vocab 65536."""

from repro_torch.configs.base import LayerSpec, ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    d_ff=8960,
    vocab_size=65_536,
    attention=None,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    period=(LayerSpec(mixer="rwkv", ffn="rwkv_channel_mix"),),
    act="relu",  # channel-mix uses squared ReLU
    glu=False,
    max_seq_len=1_048_576,  # state-based: unbounded context
    citation="arXiv:2404.05892",
)
