"""The GraphBLAS primitive set over torch tensors — counterpart of
``repro/core/graphblas.py`` (paper §II, §IV).

The operations of the paper's Fig. 4 code — ``mxm``, ``ewise_mult``,
``ewise_add`` — and the rest of the standard set (``mxv``/``vxm``,
``apply``, ``reduce_*``, ``select``, ``extract``, ``assign``,
``transpose``), with the GraphBLAS mask and accumulator rule.

Dense tensors and :class:`BlockSparseMatrix` / :class:`BlockCSRMatrix`
operands are accepted where meaningful. A sparse × dense product goes
through a cached, semiring-aware :class:`repro_torch.plan.mxm.MxmPlan`,
which launches the CUDA kernel for CUDA tensors (the kernel wrappers run
their plain versions on CPU tensors); ``use_kernel=False`` pins the
oracle of ``repro_torch.sparse.ops``. Either way a boolean semiring's
sparse product comes back in the kernels' {0, 1} f32 encoding.

The reference falls back to its oracle when a sparse operand is a jit
tracer, because a plan hashes concrete index arrays. PyTorch runs
eagerly, every operand is concrete, and there is no such fallback here.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.core.semiring import PLUS_TIMES, Semiring
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

MatrixLike = Union[torch.Tensor, BlockSparseMatrix, BlockCSRMatrix]
Accum = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _is_sparse(a) -> bool:
    return isinstance(a, (BlockSparseMatrix, BlockCSRMatrix))


def _sparse_product(
    a: MatrixLike, b: torch.Tensor, semiring: Semiring, use_kernel: bool
) -> torch.Tensor:
    """Sparse ``a`` ⊕.⊗ dense ``b`` through the plan (kernel route) or
    the oracle, f32 either way."""
    if use_kernel:
        # plan.mxm imports the plan package, which imports core.dnn, which
        # imports this module: bind it at call time
        from repro_torch.plan.mxm import mxm_plan

        return mxm_plan(a, b.shape[1], semiring.name)(b)
    matmul = sparse_ops.bcsr_matmul if isinstance(a, BlockCSRMatrix) else sparse_ops.bsr_matmul
    out = matmul(a, b, semiring)
    return out.float() if out.dtype == torch.bool else out


def _apply_mask_and_accum(
    out: torch.Tensor,
    prev: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    accum: Optional[Accum],
) -> torch.Tensor:
    """GraphBLAS output rule: out = mask ? accum(prev, out) : prev."""
    if accum is not None:
        if prev is None:
            raise ValueError("accum requires a previous output value")
        out = accum(prev, out)
    if mask is not None:
        base = prev if prev is not None else torch.zeros_like(out)
        out = torch.where(mask, out, base)
    return out


def mxm(
    a: MatrixLike,
    b: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """C = A ⊕.⊗ B (GrB_mxm). ``a`` dense, ELL-BSR or block-CSR; ``b``
    dense (the paper keeps Y dense, §V-B)."""
    if _is_sparse(a):
        out = _sparse_product(a, b, semiring, use_kernel)
    else:
        out = semiring.matmul(a, b)
    return _apply_mask_and_accum(out, prev, mask, accum)


def mxv(
    a: MatrixLike,
    v: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """w = A ⊕.⊗ v (GrB_mxv); the vector rides as a width-1 panel,
    billed at the 8-wide tile the kernels run
    (``repro_torch.plan.cost.mxv_grid_steps``)."""
    out = mxm(a, v[:, None], semiring, use_kernel=use_kernel)[:, 0]
    return _apply_mask_and_accum(out, prev, mask, accum)


def vxm(
    v: torch.Tensor,
    a: MatrixLike,
    semiring: Semiring = PLUS_TIMES,
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> torch.Tensor:
    """wᵀ = vᵀ ⊕.⊗ A (GrB_vxm): Aᵀ ⊕.⊗ v, for a sparse ``a`` on the
    same narrow-panel route as :func:`mxv`."""
    if _is_sparse(a):
        out = _sparse_product(a.transpose(), v[:, None], semiring, use_kernel)[:, 0]
    else:
        out = semiring.vecmat(v, a)
    return _apply_mask_and_accum(out, prev, mask, accum)


def ewise_mult(
    a: torch.Tensor,
    b: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C(i,j) = A(i,j) ⊗ B(i,j) (GrB_eWiseMult). In the paper's DNN
    (Fig. 4 line 31) the max-plus ⊗ = + adds the bias."""
    return _apply_mask_and_accum(semiring.mul(a, b), prev, mask, accum)


def ewise_add(
    a: torch.Tensor,
    b: torch.Tensor,
    semiring: Semiring = PLUS_TIMES,
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C(i,j) = A(i,j) ⊕ B(i,j) (GrB_eWiseAdd). In the paper's DNN
    (Fig. 4 line 32) the max-plus ⊕ = max against Zero is the ReLU."""
    return _apply_mask_and_accum(semiring.add(a, b), prev, mask, accum)


def apply(
    a: torch.Tensor,
    unary_op: Callable[[torch.Tensor], torch.Tensor],
    *,
    mask: Optional[torch.Tensor] = None,
    accum: Optional[Accum] = None,
    prev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C = f(A) elementwise (GrB_apply)."""
    return _apply_mask_and_accum(unary_op(a), prev, mask, accum)


def reduce_rows(a: torch.Tensor, semiring: Semiring = PLUS_TIMES, *, dim: int = -1):
    """w(i) = ⊕_j A(i,j) (GrB_reduce to vector)."""
    return semiring.add_reduce(a, dim)


def reduce_scalar(a: torch.Tensor, semiring: Semiring = PLUS_TIMES) -> torch.Tensor:
    """s = ⊕_{ij} A(i,j) (GrB_reduce to scalar)."""
    return semiring.add_reduce(a)


def select(a: torch.Tensor, predicate: Callable[[torch.Tensor], torch.Tensor],
           fill=0.0) -> torch.Tensor:
    """C = A where predicate(A), else ``fill`` (GrB_select)."""
    return torch.where(predicate(a), a, torch.tensor(fill, dtype=a.dtype, device=a.device))


def transpose(a: MatrixLike) -> MatrixLike:
    return a.transpose() if _is_sparse(a) else a.T


def extract(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """C = A(rows, cols) (GrB_extract)."""
    return a[rows[:, None], cols[None, :]]


def assign(a: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, value) -> torch.Tensor:
    """A(rows, cols) = value (GrB_assign), on a copy: ``a`` is left as it was."""
    out = a.clone()
    out[rows[:, None], cols[None, :]] = value
    return out
