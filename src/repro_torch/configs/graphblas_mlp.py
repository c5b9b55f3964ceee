"""The paper's own architecture (Kepner et al. 2017, §IV-§V): an L-layer
square ReLU MLP, weights m×m (dense or sparse), bias per layer, batch
n=64. ``make_config(m, inverse_sparsity)`` reproduces the experimental
grid of Fig. 5 (m ∈ {512, 2048, 8192, 32768}; inverse sparsity 1 →
262144). The DNN is evaluated through ``repro.core.dnn`` over the
(S1, S2) semiring pair."""

from repro_torch.configs.base import LayerSpec, ModelConfig, SparsityConfig


def make_config(
    m: int = 8192,
    num_layers: int = 8,
    inverse_sparsity: int = 1,
    block: int = 128,
) -> ModelConfig:
    if inverse_sparsity <= 1:
        sparsity = None
    else:
        ncb = m // block
        bpr = max(1, round(ncb / inverse_sparsity))
        sparsity = SparsityConfig(
            block_shape=(block, block), blocks_per_row=bpr, targets=("ffn",)
        )
    return ModelConfig(
        name=f"graphblas-mlp-m{m}-is{inverse_sparsity}",
        family="mlp",
        num_layers=num_layers,
        d_model=m,
        d_ff=m,
        vocab_size=m,  # features in = features out = m
        attention=None,
        sparsity=sparsity,
        period=(LayerSpec(mixer="none", ffn="relu_mlp"),),
        act="relu",
        glu=False,
        input_mode="features",
        max_seq_len=1,
        compute_dtype="float32",  # the paper's experiments are FP32 (§V-B)
        citation="Kepner et al. 2017 (this paper)",
    )


CONFIG = make_config()
