"""The paper's sparse ReLU DNN in PyTorch — counterpart of ``repro/core/dnn.py``.

``Y[l+1] = max(W[l]·Y[l] + b[l], 0)`` per layer, in the fused form (one
sparse product with the bias+ReLU epilogue). Weights are dense tensors,
ELL-padded :class:`BlockSparseMatrix` or :class:`BlockCSRMatrix`.

These are plain PyTorch on any device, like the reference's XLA path;
the kernels are reached through plans (``repro_torch.plan``). The
paper-faithful three-call GraphBLAS form arrives with the GraphBLAS
slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

Weight = Union[torch.Tensor, BlockSparseMatrix, BlockCSRMatrix]


def dnn_layer(w: Weight, y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One forward layer: max(W·Y + b⊗1ᵀ, 0).  y: (m, n); b: (m,)."""
    if isinstance(w, BlockCSRMatrix):
        return sparse_ops.bcsr_matmul_fused_relu(w, y, b)
    if isinstance(w, BlockSparseMatrix):
        return sparse_ops.bsr_matmul_fused_relu(w, y, b)
    return sparse_ops.dense_matmul_fused_relu(w, y, b)


def dnn_forward(
    weights: Sequence[Weight], biases: Sequence[torch.Tensor], y0: torch.Tensor
) -> torch.Tensor:
    """Full L-layer forward pass (the paper's ``dnn()`` function)."""
    y = y0
    for w, b in zip(weights, biases):
        y = dnn_layer(w, y, b)
    return y


def stack_bsr(mats: Sequence[BlockSparseMatrix]) -> BlockSparseMatrix:
    """Stack same-structure BSR matrices along a new leading layer axis
    (the weight stack of the fused kernels)."""
    first = mats[0]
    for m in mats[1:]:
        if (
            m.shape != first.shape
            or m.block_shape != first.block_shape
            or m.max_blocks_per_row != first.max_blocks_per_row
        ):
            raise ValueError("stack_bsr requires homogeneous BSR structure")
    return BlockSparseMatrix(
        torch.stack([m.blocks for m in mats]),
        torch.stack([m.col_idx for m in mats]),
        torch.stack([m.block_mask for m in mats]),
        first.shape,
        first.block_shape,
    )
