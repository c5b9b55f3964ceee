"""Autograd for the two SpMM kernels — counterpart of ``repro/kernels/autodiff.py``.

Two ``torch.autograd.Function``s, for ``plus_times`` with the optional
fused ``max(Z + b·1ᵀ, 0)`` epilogue, in place of the reference's
``bsr_spmm_diff`` (``autodiff.py:104``) and ``bcsr_spmm_diff``
(``:150``). No weight is densified in either pass:

  primal      Z = A·B (+ epilogue), the kernel launch of ``kernels.ops``
  dB (dense)  = Aᵀ·dZ
  dA (sparse) at the stored blocks only: dA[blk] = dZ_row(blk)·B_col(blk)ᵀ,
              pad (ELL) and tail (block-CSR) slots exactly 0
  db (bias)   = Σₙ dZ, dZ masked by ``out > 0`` when the epilogue is fused

dB for both layouts launches the ``bcsr_spmm`` kernel, through its
wrapper, on the block-CSR transpose: from a cached
:class:`~repro_torch.sparse.bcsr.BcsrTransposePlan` (a gather, no sort)
or from a transpose sorted for this call (``a.transpose_plan()``, or
``ell_transpose_plan(a)`` over an ELL matrix's stored slots). The
reference's ELL dB is an XLA scatter-sum; the port's plain mirror of
that, ``sparse.ops.bsr_transpose_matmul``, is an ``index_add_``, which
on CUDA adds a block-column's products in the order they arrive, so two
identical backward passes differed in the low bits on the card. The
``bcsr_spmm`` launch folds each row of Aᵀ in one fixed order: a
restored or resumed training run replays its losses bit for bit. The
transpose's block shape is ``(bs_c, bs_r)``; the wrapper re-tiles it if
the kernel cannot take it, and column skew in A becomes row skew in Aᵀ,
which its piece table cuts. Rows of Aᵀ with no stored block (empty
columns of A) come out of that launch as the semiring zero, 0, so their
dB rows are exactly 0 with no mask (the reference masks them because its
kernel leaves them unwritten).

The value tensor (``a.blocks`` / ``a.values``), the panel and the bias
are the Functions' direct inputs, so gradients reach them; the
topology tensors ride along untouched.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import ops as kernel_ops
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix, ell_transpose_plan
from repro_torch.sparse.bsr import BlockSparseMatrix


def _relu_mask_and_bias_grad(fuse_bias_relu: bool, out: torch.Tensor, g: torch.Tensor):
    """The epilogue's backward (reference ``_relu_mask_and_bias_grad``,
    ``autodiff.py:86``): (dZ, dbias)."""
    g = g.float()
    if not fuse_bias_relu:
        return g, None
    dz = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return dz, dz.sum(dim=1)


def _transpose_product(a, transpose_plan, dz, block_n):
    """dB = Aᵀ·dZ: one ``bcsr_spmm`` launch on A's block-CSR transpose."""
    if transpose_plan is None:
        transpose_plan = (ell_transpose_plan(a) if isinstance(a, BlockSparseMatrix)
                          else a.transpose_plan())
    return kernel_ops.bcsr_spmm(transpose_plan.apply(a), dz, block_n=block_n)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, b, bias, a, transpose_plan, fuse_bias_relu, block_n):
        out = kernel_ops.bsr_spmm(dataclasses.replace(a, blocks=blocks), b, bias,
                                  fuse_bias_relu=fuse_bias_relu, block_n=block_n)
        ctx.save_for_backward(blocks, b, out)
        ctx.a = dataclasses.replace(a, blocks=None)  # topology only
        ctx.transpose_plan = transpose_plan
        ctx.fuse_bias_relu, ctx.block_n = fuse_bias_relu, block_n
        return out

    @staticmethod
    def backward(ctx, g):
        blocks, b, out = ctx.saved_tensors
        a = dataclasses.replace(ctx.a, blocks=blocks)
        dz, dbias = _relu_mask_and_bias_grad(ctx.fuse_bias_relu, out, g)
        db = (_transpose_product(a, ctx.transpose_plan, dz, ctx.block_n)
              if ctx.needs_input_grad[1] else None)
        dblocks = (sparse_ops.bsr_weight_cotangent(a, dz, b)
                   if ctx.needs_input_grad[0] else None)
        return dblocks, db, dbias, None, None, None, None


class _BcsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, b, bias, a, transpose_plan, fuse_bias_relu, block_n):
        out = kernel_ops.bcsr_spmm(dataclasses.replace(a, values=values), b, bias,
                                   fuse_bias_relu=fuse_bias_relu, block_n=block_n)
        ctx.save_for_backward(values, b, out)
        ctx.a = dataclasses.replace(a, values=None)  # topology only
        ctx.transpose_plan = transpose_plan
        ctx.fuse_bias_relu, ctx.block_n = fuse_bias_relu, block_n
        return out

    @staticmethod
    def backward(ctx, g):
        values, b, out = ctx.saved_tensors
        a = dataclasses.replace(ctx.a, values=values)
        dz, dbias = _relu_mask_and_bias_grad(ctx.fuse_bias_relu, out, g)
        db = (_transpose_product(a, ctx.transpose_plan, dz, ctx.block_n)
              if ctx.needs_input_grad[1] else None)
        dvalues = (sparse_ops.bcsr_weight_cotangent(a, dz, b)
                   if ctx.needs_input_grad[0] else None)
        return dvalues, db, dbias, None, None, None, None


def bsr_spmm_diff(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    bias: torch.Tensor,
    transpose_plan: BcsrTransposePlan | None = None,
    *,
    fuse_bias_relu: bool,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Differentiable ``bsr_spmm`` in ``plus_times``: gradients reach
    ``a.blocks``, ``b`` and ``bias``. ``transpose_plan``
    (``ell_transpose_plan(a)``) only feeds the backward, as in
    :func:`bcsr_spmm_diff`."""
    return _BsrSpmm.apply(a.blocks, b, bias, a, transpose_plan, fuse_bias_relu, block_n)


def bcsr_spmm_diff(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor,
    transpose_plan: BcsrTransposePlan | None = None,
    *,
    fuse_bias_relu: bool,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Differentiable ``bcsr_spmm`` in ``plus_times``: gradients reach
    ``a.values``, ``b`` and ``bias``. ``transpose_plan`` only feeds the
    backward: with it dB's transpose is a gather through the cached
    permutation; without it every backward re-sorts the topology."""
    return _BcsrSpmm.apply(a.values, b, bias, a, transpose_plan, fuse_bias_relu, block_n)
