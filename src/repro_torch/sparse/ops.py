"""Plain-PyTorch sparse products — the oracles of the CUDA kernels.

Counterpart of ``repro/sparse/ops.py``, over every semiring of the
registry (``repro_torch.core.semiring``):

* ``bsr_matmul`` — ``C = A ⊕.⊗ B`` for an ELL-padded BSR ``A``;
* ``bcsr_matmul`` — the same for the occupancy-exact block-CSR layout:
  one product per stored block, then a segment-⊕ over the row map;
* the backward helpers of the training path (``plus_times``):
  ``bsr_transpose_matmul``/``bcsr_transpose_matmul`` (Aᵀ·Y) and
  ``bsr_weight_cotangent``/``bcsr_weight_cotangent`` (dW at the stored
  blocks only), batched products and ``index_add_`` over the stored
  blocks — no weight is ever densified.

The ``semiring`` argument is a registry :class:`Semiring` (boolean
algebras then give bool outputs, as in the reference) or its f32 kernel
lowering (``repro_torch.kernels.semirings``), which the kernels' plain
versions pass. These run on any device, in another order than the
kernels (a gather of the needed B panels, then batched products), so
``plus_times`` and ``log_plus`` are compared under f32 tolerances.
"""

from __future__ import annotations

import torch

from repro_torch.core.semiring import PLUS_TIMES, Semiring
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) that keeps NaN, like ``jnp.maximum`` (the engine's
    per-column NaN quarantine depends on NaN reaching the output). Its
    gradient is the kernels' backward mask ``out > 0``: 0 at x = 0."""
    return torch.relu(x)


def _panels(a, b: torch.Tensor) -> torch.Tensor:
    """B's row-panels, one (bs_c, k) panel per block-column."""
    m, n = a.shape
    if b.shape[0] != n:
        raise ValueError(f"shape mismatch: A {a.shape} @ B {tuple(b.shape)}")
    return b.reshape(n // a.block_shape[1], a.block_shape[1], b.shape[1])


def _fill(semiring, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(semiring.zero, dtype=like.dtype, device=like.device)


def bsr_matmul(
    a: BlockSparseMatrix, b: torch.Tensor, semiring: Semiring = PLUS_TIMES
) -> torch.Tensor:
    """C (m, k) = A (m, n) ⊕.⊗ B (n, k) for an ELL-padded BSR ``A``.

    Gathers the B row-panel of every slot and contracts per block;
    padded slots are set to the semiring zero before the ⊕ across slots,
    so no semiring sees the pad's zero block.
    """
    m = a.shape[0]
    gathered = _panels(a, b)[a.col_idx.long()]  # (nrb, mbpr, bs_c, k)
    if semiring.name == "plus_times":
        dtype = torch.promote_types(a.dtype, b.dtype)
        safe = torch.where(a.block_mask[:, :, None, None], a.blocks.to(dtype),
                           torch.zeros((), dtype=dtype, device=b.device))
        out = torch.einsum("rmbc,rmck->rbk", safe, gathered.to(dtype))
        return out.reshape(m, -1)
    prod = semiring.matmul(a.blocks, gathered)  # (nrb, mbpr, bs_r, k)
    prod = torch.where(a.block_mask[:, :, None, None], prod, _fill(semiring, prod))
    return semiring.add_reduce(prod, 1).reshape(m, -1)


def _segment_add_reduce(semiring, x: torch.Tensor, a: BlockCSRMatrix) -> torch.Tensor:
    """⊕-reduce the stored blocks' partials ``x`` (T, …) into their
    block-rows; rows with no stored block hold the semiring zero."""
    rows = a.row_id.long()
    if semiring.add is torch.add:
        out = torch.zeros((a.n_row_blocks, *x.shape[1:]), dtype=x.dtype, device=x.device)
        return out.index_add_(0, rows, x)
    out = torch.full((a.n_row_blocks, *x.shape[1:]), semiring.zero, dtype=x.dtype,
                     device=x.device)
    # Blocks are stored row-major, so a block's rank within its row is its
    # offset from row_ptr; merging rank s of every row at once touches each
    # row at most once per pass (max row occupancy passes, O(T) memory).
    rank = torch.arange(len(rows), device=x.device) - a.row_ptr.long()[:-1][rows]
    passes = int((a.row_ptr[1:] - a.row_ptr[:-1]).max()) if a.n_row_blocks else 0
    for s in range(passes):
        sel = torch.nonzero(a.valid & (rank == s)).flatten()
        r = rows[sel]
        out[r] = semiring.add(out[r], x[sel])
    return out


def bcsr_matmul(
    a: BlockCSRMatrix, b: torch.Tensor, semiring: Semiring = PLUS_TIMES
) -> torch.Tensor:
    """C (m, k) = A (m, n) ⊕.⊗ B (n, k) for the flattened CSR layout.

    One block product per stored block, invalid tail slots set to the
    semiring zero, then a segment-⊕ keyed by ``row_id``. Block-rows with
    no stored block come out as the semiring zero.
    """
    m = a.shape[0]
    gathered = _panels(a, b)[a.col_idx.long()]  # (T, bs_c, k)
    if semiring.name == "plus_times":
        dtype = torch.promote_types(a.dtype, b.dtype)
        safe = torch.where(a.valid[:, None, None], a.values.to(dtype),
                           torch.zeros((), dtype=dtype, device=b.device))
        prod = torch.bmm(safe, gathered.to(dtype))  # (T, bs_r, k)
    else:
        prod = semiring.matmul(a.values, gathered)
        prod = torch.where(a.valid[:, None, None], prod, _fill(semiring, prod))
    return _segment_add_reduce(semiring, prod, a).reshape(m, -1)


def bsr_matmul_fused_relu(
    a: BlockSparseMatrix, b: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """max(A·B + bias, 0) for the ELL layout."""
    return relu(bsr_matmul(a, b) + bias[:, None])


def bcsr_matmul_fused_relu(
    a: BlockCSRMatrix, b: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """max(A·B + bias, 0) for the CSR layout."""
    return relu(bcsr_matmul(a, b) + bias[:, None])


def dense_matmul_fused_relu(
    w: torch.Tensor, y: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Dense fused baseline: max(W·Y + b, 0)."""
    return relu(torch.matmul(w, y) + bias[:, None])


def bsr_transpose_matmul(a: BlockSparseMatrix, y: torch.Tensor) -> torch.Tensor:
    """``Aᵀ (k, m) @ Y (m, n)`` without forming the transpose: each stored
    block (r, c, W) adds ``Wᵀ @ Y_row(r)`` to output row-block c (the
    reference's form of the ELL layer's dX = Wᵀ·dZ). Pad slots are masked.
    The kernels' backward does not use it: on CUDA ``index_add_`` adds a
    block-column's products in the order they arrive, so it launches
    ``bcsr_spmm`` on the transpose instead (``kernels.autodiff``)."""
    m, k = a.shape
    if y.shape[0] != m:
        raise ValueError(f"shape mismatch: Aᵀ {(k, m)} @ Y {tuple(y.shape)}")
    n = y.shape[1]
    nrb, mbpr = a.col_idx.shape
    bs_r, bs_c = a.block_shape
    safe = torch.where(a.block_mask[:, :, None, None], a.blocks,
                       torch.zeros((), dtype=a.dtype, device=a.device))
    # prod[r, s] = W[r, s]ᵀ @ Y_row(r): (nrb, mbpr, bs_c, n)
    prod = torch.matmul(safe.transpose(-1, -2), y.reshape(nrb, 1, bs_r, n))
    out = torch.zeros((a.n_col_blocks, bs_c, n), dtype=prod.dtype, device=y.device)
    out.index_add_(0, a.col_idx.reshape(-1).long(), prod.reshape(nrb * mbpr, bs_c, n))
    return out.reshape(k, n)


def bsr_weight_cotangent(a: BlockSparseMatrix, dz: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``a.blocks`` for ``Z = A @ B``: the sampled products
    ``dW[r, s] = dZ_row(r) @ B_col(col_idx[r, s])ᵀ`` at the stored slots;
    pad slots come back exactly 0."""
    nrb, mbpr = a.col_idx.shape
    bs_r, bs_c = a.block_shape
    n = dz.shape[1]
    b_panels = b.reshape(a.n_col_blocks, bs_c, n)[a.col_idx.long()]  # (nrb, mbpr, bs_c, n)
    d = torch.matmul(dz.reshape(nrb, 1, bs_r, n), b_panels.transpose(-1, -2))
    return torch.where(a.block_mask[:, :, None, None], d,
                       torch.zeros((), dtype=d.dtype, device=d.device))


def bcsr_transpose_matmul(c: BlockCSRMatrix, y: torch.Tensor) -> torch.Tensor:
    """``Aᵀ (k, m) @ Y (m, n)`` for the block-CSR layout: per stored block
    ``Wᵀ @ Y_row(row_id)``, summed into block-row ``col_idx`` — the plain
    mirror of the ``bcsr_spmm`` launch on ``c``'s transpose. Invalid tail
    slots are masked by ``valid`` (they ride on the last real row)."""
    m, k = c.shape
    if y.shape[0] != m:
        raise ValueError(f"shape mismatch: Aᵀ {(k, m)} @ Y {tuple(y.shape)}")
    n = y.shape[1]
    bs_r, bs_c = c.block_shape
    y_rows = y.reshape(c.n_row_blocks, bs_r, n)[c.row_id.long()]  # (T, bs_r, n)
    safe = torch.where(c.valid[:, None, None], c.values,
                       torch.zeros((), dtype=c.dtype, device=c.device))
    prod = torch.bmm(safe.transpose(1, 2), y_rows)  # (T, bs_c, n)
    out = torch.zeros((c.n_col_blocks, bs_c, n), dtype=prod.dtype, device=y.device)
    out.index_add_(0, c.col_idx.long(), prod)
    return out.reshape(k, n)


def bcsr_weight_cotangent(c: BlockCSRMatrix, dz: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cotangent of ``c.values`` for ``Z = A @ B``: ``dW[t] =
    dZ_row(row_id[t]) @ B_col(col_idx[t])ᵀ`` at the stored blocks; invalid
    tail slots come back exactly 0."""
    bs_r, bs_c = c.block_shape
    n = dz.shape[1]
    dz_rows = dz.reshape(c.n_row_blocks, bs_r, n)[c.row_id.long()]  # (T, bs_r, n)
    b_cols = b.reshape(c.n_col_blocks, bs_c, n)[c.col_idx.long()]  # (T, bs_c, n)
    d = torch.bmm(dz_rows, b_cols.transpose(1, 2))
    return torch.where(c.valid[:, None, None], d, torch.zeros((), dtype=d.dtype, device=d.device))
