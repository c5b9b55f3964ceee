"""DeepSeek-V2 236B (MLA + fine-grained MoE). [arXiv:2405.04434; hf
deepseek-ai/DeepSeek-V2]: 60L, d_model 5120, 128 heads MLA
(q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128),
160 routed experts top-6 (d_expert 1536) + 2 shared, layer 0 dense FFN
(intermediate 12288), vocab 102400."""

from repro_torch.configs.base import (
    AttentionConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    d_ff=12288,  # dense-FFN intermediate (layer 0)
    vocab_size=102_400,
    attention=AttentionConfig(
        kind="mla",
        num_heads=128,
        num_kv_heads=128,
        head_dim=192,  # qk_nope + qk_rope
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_expert=1536,
        num_shared_experts=2,
        capacity_factor=1.25,
    ),
    head=(LayerSpec(mixer="attn", ffn="dense"),),
    period=(LayerSpec(mixer="attn", ffn="moe"),),
    max_seq_len=131_072,
    citation="arXiv:2405.04434",
)
