"""The paper's sparse ReLU DNN in PyTorch — counterpart of ``repro/core/dnn.py``.

``Y[l+1] = max(W[l]·Y[l] + b[l], 0)`` per layer, in two forms:

* ``fused=True`` — one product with the bias+ReLU epilogue, in plain
  PyTorch on any device, like the reference's XLA path (the kernels are
  reached through plans, ``repro_torch.plan``);
* ``fused=False`` — paper-faithful: the three GraphBLAS calls of Fig. 4,

    Y[k+1] = GrB_mxm(FP32AddMul, W[k], Y[k])           # arithmetic semiring
    Y[k+1] = GrB_eWiseMult(FP32MaxPlus, Y[k+1], B[k])  # ⊗ = +  → bias add
    Y[k+1] = GrB_eWiseAdd(FP32MaxPlus, Y[k+1], Zero)   # ⊕ = max → ReLU

  where ``mxm`` on a sparse weight launches the CUDA kernels through an
  ``MxmPlan`` (``repro_torch.core.graphblas``).

Weights are dense tensors, ELL-padded :class:`BlockSparseMatrix` or
:class:`BlockCSRMatrix`.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.core import graphblas as gb
from repro_torch.core.semiring import MAX_PLUS, PLUS_TIMES
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

Weight = Union[torch.Tensor, BlockSparseMatrix, BlockCSRMatrix]


def dnn_layer(
    w: Weight, y: torch.Tensor, b: torch.Tensor, *, fused: bool = True
) -> torch.Tensor:
    """One forward layer: max(W·Y + b⊗1ᵀ, 0).  y: (m, n); b: (m,)."""
    if fused:
        if isinstance(w, BlockCSRMatrix):
            return sparse_ops.bcsr_matmul_fused_relu(w, y, b)
        if isinstance(w, BlockSparseMatrix):
            return sparse_ops.bsr_matmul_fused_relu(w, y, b)
        return sparse_ops.dense_matmul_fused_relu(w, y, b)
    bias = b[:, None].expand(y.shape)  # B[k]: b replicated over the columns
    zero = torch.zeros_like(y)  # the Zero matrix (Fig. 4 lines 24-26)
    z = gb.mxm(w, y, PLUS_TIMES)  # line 30
    z = gb.ewise_mult(z, bias, MAX_PLUS)  # line 31: ⊗ = +
    return gb.ewise_add(z, zero, MAX_PLUS)  # line 32: ⊕ = max


def dnn_forward(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    fused: bool = True,
) -> torch.Tensor:
    """Full L-layer forward pass (the paper's ``dnn()`` function)."""
    y = y0
    for w, b in zip(weights, biases):
        y = dnn_layer(w, y, b, fused=fused)
    return y


def dnn_forward_all(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    fused: bool = True,
) -> list[torch.Tensor]:
    """Forward pass returning every Y[k] (the paper's Y[0..L] array)."""
    ys = [y0]
    for w, b in zip(weights, biases):
        ys.append(dnn_layer(w, ys[-1], b, fused=fused))
    return ys


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
