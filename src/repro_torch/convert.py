"""Carry weights from the JAX package's layouts into the port's.

The reference draws random weights from ``jax.random``, which PyTorch
cannot reproduce from a seed, so weights are always converted, never
regenerated. Every function takes the reference's arrays as numpy
arrays (``np.asarray`` of a JAX array works without importing JAX) and
returns the port's tensors on ``device``:

* :func:`bsr` — ``BlockSparseMatrix`` (blocks, col_idx, block_mask,
  shape, block_shape); a stacked matrix (leading L axis) converts the
  same way;
* :func:`bcsr` — ``BlockCSRMatrix``;
* :func:`bias` — bias vectors (or a stacked (L, m) bias);
* :func:`layout` — either matrix class, read off an object with the
  reference's attribute names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)  # a writable copy


def bsr(blocks, col_idx, block_mask, shape, block_shape, *, device="cpu") -> BlockSparseMatrix:
    """An ELL ``BlockSparseMatrix`` (stacked or not) from numpy arrays;
    the mask may be bool or int (the reference uses both)."""
    return BlockSparseMatrix(
        _t(blocks, np.float32, device),
        _t(col_idx, np.int32, device),
        _t(np.asarray(block_mask) != 0, bool, device),
        (int(shape[0]), int(shape[1])),
        (int(block_shape[0]), int(block_shape[1])),
    )


def bcsr(
    values, row_ptr, row_id, col_idx, valid, shape, block_shape, *, device="cpu"
) -> BlockCSRMatrix:
    """A ``BlockCSRMatrix`` from numpy arrays."""
    return BlockCSRMatrix(
        _t(values, np.float32, device),
        _t(row_ptr, np.int32, device),
        _t(row_id, np.int32, device),
        _t(col_idx, np.int32, device),
        _t(np.asarray(valid) != 0, bool, device),
        (int(shape[0]), int(shape[1])),
        (int(block_shape[0]), int(block_shape[1])),
    )


def bias(b, *, device="cpu") -> torch.Tensor:
    """A bias vector (m,) or stacked bias (L, m), float32."""
    return _t(b, np.float32, device)


def layout(obj, *, device="cpu"):
    """Convert an object with the reference's BSR or block-CSR attribute
    names (a ``repro.sparse`` matrix) to the port's class."""
    if hasattr(obj, "row_ptr"):
        return bcsr(obj.values, obj.row_ptr, obj.row_id, obj.col_idx, obj.valid,
                    obj.shape, obj.block_shape, device=device)
    return bsr(obj.blocks, obj.col_idx, obj.block_mask, obj.shape, obj.block_shape,
               device=device)
