"""Plain-PyTorch sparse products — the oracles of the CUDA kernels.

Counterpart of ``repro/sparse/ops.py`` in its ``plus_times`` form, which
is the only semiring the serving path uses. The other seven semirings
of the reference registry arrive with the GraphBLAS slice (ROADMAP
Queue 1 item 8) and raise ``NotImplementedError`` until then.

These run on any device. They repeat the kernels' arithmetic in another
summation order (a gather of the needed B panels, then one batched
product), so a kernel is compared with them under an f32 tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

PLUS_TIMES = "plus_times"


def check_semiring(semiring: str) -> None:
    if semiring != PLUS_TIMES:
        raise NotImplementedError(
            f"semiring {semiring!r}: the port computes plus_times only; "
            "the other semirings arrive with the GraphBLAS slice "
            "(ROADMAP Queue 1 item 8, Queue 2 item 6)"
        )


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) that keeps NaN, like ``jnp.maximum`` (the engine's
    per-column NaN quarantine depends on NaN reaching the output)."""
    return torch.where(x < 0, torch.zeros_like(x), x)


def bsr_matmul(
    a: BlockSparseMatrix, b: torch.Tensor, semiring: str = PLUS_TIMES
) -> torch.Tensor:
    """C (m, k) = A (m, n) ⊕.⊗ B (n, k) for an ELL-padded BSR ``A``.

    Gathers the B row-panel of every slot, zeroes the padded slots and
    contracts with one batched product.
    """
    check_semiring(semiring)
    m, n = a.shape
    if b.shape[0] != n:
        raise ValueError(f"shape mismatch: A {a.shape} @ B {tuple(b.shape)}")
    k = b.shape[1]
    bs_r, bs_c = a.block_shape
    dtype = torch.promote_types(a.dtype, b.dtype)
    gathered = b.to(dtype).reshape(n // bs_c, bs_c, k)[a.col_idx.long()]
    safe = torch.where(
        a.block_mask[:, :, None, None], a.blocks.to(dtype),
        torch.zeros((), dtype=dtype, device=b.device),
    )
    out = torch.einsum("rmbc,rmck->rbk", safe, gathered)
    return out.reshape(m, k)


def bcsr_matmul(
    a: BlockCSRMatrix, b: torch.Tensor, semiring: str = PLUS_TIMES
) -> torch.Tensor:
    """C (m, k) = A (m, n) ⊕.⊗ B (n, k) for the flattened CSR layout.

    One block product per stored block, then a sum keyed by ``row_id``.
    Block-rows with no stored block come out as the semiring zero.
    """
    check_semiring(semiring)
    m, n = a.shape
    if b.shape[0] != n:
        raise ValueError(f"shape mismatch: A {a.shape} @ B {tuple(b.shape)}")
    k = b.shape[1]
    bs_r, bs_c = a.block_shape
    dtype = torch.promote_types(a.dtype, b.dtype)
    gathered = b.to(dtype).reshape(n // bs_c, bs_c, k)[a.col_idx.long()]
    safe = torch.where(
        a.valid[:, None, None], a.values.to(dtype),
        torch.zeros((), dtype=dtype, device=b.device),
    )
    prod = torch.bmm(safe, gathered)  # (T, bs_r, k)
    out = torch.zeros((a.n_row_blocks, bs_r, k), dtype=dtype, device=b.device)
    out.index_add_(0, a.row_id.long(), prod)
    return out.reshape(m, k)


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
