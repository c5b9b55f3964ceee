"""ELL-padded BSR × dense: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/bsr_spmm.py`` (Pallas ``_kernel``, launch
at ``bsr_spmm.py:142``), over any registry semiring, with the
optional fused ``max(C + bias, 0)`` epilogue. The kernel source is
``repro_torch/csrc/bsr_spmm.cu``; its header says how it is laid out.

Launch geometry: grid ``(nrb, n / block_n)``, block ``(block_n, bs_r)``;
each CTA walks its block-row's ``max_blocks_per_row`` slots, padding
included (masked slots are skipped, but still visited).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.kernels.semirings import kernel_semiring
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bsr import BlockSparseMatrix

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # blocks, col_idx, mask, b, bias, out, nrb, mbpr, bs_r, bs_c, n,
    # block_n, fuse_bias_relu, semiring, stream
    "bsr_spmm_f32": (_P,) * 6 + (_I,) * 8 + (_P,),
}


def launch_geometry(
    a: BlockSparseMatrix, n: int, block_n: int = DEFAULT_BLOCK_N
) -> tuple[tuple[int, int], tuple[int, int]]:
    """(grid, block) of the launch for an (·, n) panel, n % block_n == 0."""
    return (a.n_row_blocks, n // block_n), (block_n, a.block_shape[0])


def grid_steps(a: BlockSparseMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products the launch walks: every CTA visits every slot of
    its block-row, so the ELL pad is billed in full
    (``nrb × max_blocks_per_row × n_tiles``)."""
    nrb, mbpr = a.col_idx.shape
    return nrb * mbpr * (-(-n // block_n))


def bsr_spmm_plain(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device (f32)."""
    out = sparse_ops.bsr_matmul(a.to(dtype=torch.float32), b.float(),
                               kernel_semiring(semiring_name))
    if fuse_bias_relu:
        out = sparse_ops.relu(out + bias.float()[:, None])
    return out


def bsr_spmm_cuda(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    bias: torch.Tensor,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool,
    block_n: int,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32 values, ``b`` (k, n)
    contiguous with ``n % block_n == 0``, ``bias`` (m,) f32."""
    m, k = a.shape
    n = b.shape[1]
    bs_r, bs_c = a.block_shape
    nrb, mbpr = a.col_idx.shape
    need = functools.partial(_build.require, "bsr_spmm")
    need(a.blocks.dtype == b.dtype == bias.dtype == torch.float32,
         "f32 values, panel and bias")
    need(a.col_idx.dtype == torch.int32 and a.block_mask.dtype == torch.bool,
         "int32 col_idx and bool block_mask")
    _build.require_contiguous_on(b.device, "bsr_spmm",
                                 a.blocks, a.col_idx, a.block_mask, b, bias)
    need(b.shape[0] == k and n % block_n == 0 and bias.shape == (m,),
         f"b ({k}, n) with n % {block_n} == 0 and bias ({m},)")
    need(block_n * bs_r <= 1024, "block_n * bs_r <= 1024 threads")
    sid = kernel_semiring(semiring_name).id
    lib = _build.load("bsr_spmm", SIGNATURES)
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    p = _build.pointer
    err = lib.bsr_spmm_f32(
        p(a.blocks), p(a.col_idx), p(a.block_mask), p(b), p(bias), p(out),
        nrb, mbpr, bs_r, bs_c, n, block_n, int(fuse_bias_relu), sid,
        _build.stream_handle(b.device),
    )
    _build.check(lib, err, "bsr_spmm")
    return out

