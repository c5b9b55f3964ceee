"""Model configuration dataclasses + the assigned input-shape cells —
counterpart of ``repro/configs/base.py``, field for field (plain
dataclasses: the port keeps its own copy rather than import the
reference).

Every assigned architecture is described by a :class:`ModelConfig` built
from published dimensions (citations in each config file). Layer stacking
is expressed as ``head`` (unique leading layers, e.g. DeepSeek's dense
layer 0), a repeating ``period`` pattern (scanned), and a ``tail``
(remainder layers, e.g. Gemma-3's 34 = 5·6 + 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    kind: str  # "gqa" | "mla"
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # sliding window (0 = full/causal); per-layer override via LayerSpec
    window: int = 0
    # MLA (DeepSeek-V2) dims
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """The paper's technique applied to model weights: block-sparse FFNs."""

    block_shape: Tuple[int, int] = (128, 128)
    blocks_per_row: int = 0  # 0 = dense; else ELL budget per block-row
    targets: Tuple[str, ...] = ("ffn",)  # which weight families go BSR


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer's composition within the stack pattern."""

    mixer: str = "attn"  # "attn" | "mamba" | "rwkv"
    ffn: str = "dense"  # "dense" | "moe" | "rwkv_channel_mix"
    window: int = 0  # per-layer attention window (gemma3 locals)
    rope_theta: float = 0.0  # per-layer theta override (0 = global)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | mlp
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    sparsity: Optional[SparsityConfig] = None
    head: Tuple[LayerSpec, ...] = ()
    period: Tuple[LayerSpec, ...] = (LayerSpec(),)
    tail: Tuple[LayerSpec, ...] = ()
    act: str = "silu"  # silu | gelu | relu
    glu: bool = True
    norm_eps: float = 1e-6
    post_norms: bool = False  # gemma3 sandwich norms
    tie_embeddings: bool = False
    input_mode: str = "tokens"  # tokens | embeddings (vlm/audio stubs)
    max_seq_len: int = 131_072
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    citation: str = ""

    def __post_init__(self):
        n_pattern = self.num_layers - len(self.head) - len(self.tail)
        if n_pattern < 0 or (
            len(self.period) and n_pattern % len(self.period) != 0
        ):
            raise ValueError(
                f"{self.name}: head({len(self.head)}) + k·period"
                f"({len(self.period)}) + tail({len(self.tail)}) cannot reach"
                f" {self.num_layers} layers"
            )

    @property
    def n_periods(self) -> int:
        return (self.num_layers - len(self.head) - len(self.tail)) // len(
            self.period
        )

    def layer_specs(self) -> list[LayerSpec]:
        return (
            list(self.head)
            + list(self.period) * self.n_periods
            + list(self.tail)
        )

    @property
    def sub_quadratic(self) -> bool:
        """True if every layer's mixer is O(seq) at decode with bounded
        state/KV (SSM, linear-attn, or bounded-window attention)."""
        full_attn_layers = [
            s
            for s in self.layer_specs()
            if s.mixer == "attn" and s.window == 0
        ]
        # hybrid archs with a small fraction of full-attn layers still
        # qualify per the assignment (jamba, gemma3's 1-in-6 globals).
        return len(full_attn_layers) <= self.num_layers // 4

    def scaled_down(
        self,
        *,
        num_layers: int | None = None,
        d_model: int = 64,
        vocab_size: int = 512,
        max_seq_len: int = 256,
    ) -> "ModelConfig":
        """Structure-preserving reduced config for CPU smoke tests."""
        period = self.period
        head, tail = self.head, self.tail
        if num_layers is None:
            num_layers = len(head) + len(period) + len(tail)
        scale = d_model / self.d_model
        attn = None
        if self.attention is not None:
            a = self.attention
            heads = max(2, int(a.num_heads * scale)) if a.num_heads else 0
            kv = max(1, min(heads, int(a.num_kv_heads * scale)) or 1)
            heads = (heads // kv) * kv or kv
            attn = dataclasses.replace(
                a,
                num_heads=heads,
                num_kv_heads=kv,
                head_dim=16,
                q_lora_rank=32 if a.q_lora_rank else 0,
                kv_lora_rank=16 if a.kv_lora_rank else 0,
                qk_nope_head_dim=16 if a.qk_nope_head_dim else 0,
                qk_rope_head_dim=8 if a.qk_rope_head_dim else 0,
                v_head_dim=16 if a.v_head_dim else 0,
                window=min(a.window, 64) if a.window else 0,
            )
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                # capacity ≥ group size at test scale: GShard token dropping
                # depends on grouping, which would make prefill/forward
                # outputs diverge spuriously in consistency tests
                capacity_factor=float(4 // min(self.moe.top_k, 2)),
            )
        period = tuple(
            dataclasses.replace(s, window=min(s.window, 64) if s.window else 0)
            for s in period
        )
        head = tuple(head)
        tail = tuple(tail)
        n_pattern = num_layers - len(head) - len(tail)
        if n_pattern < len(period) or n_pattern % len(period):
            # keep exactly head + 1 period + tail
            num_layers = len(head) + len(period) + len(tail)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            d_ff=d_model * 2,
            vocab_size=vocab_size,
            attention=attn,
            moe=moe,
            mamba=dataclasses.replace(self.mamba, d_state=4, d_conv=2)
            if self.mamba
            else None,
            rwkv=dataclasses.replace(
                self.rwkv, head_dim=16, decay_lora=8, mix_lora=8
            )
            if self.rwkv
            else None,
            head=head,
            period=period,
            tail=tail,
            max_seq_len=max_seq_len,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch × input-shape) evaluation cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
