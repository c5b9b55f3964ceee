"""Occupancy-exact block-CSR × dense: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/bcsr_spmm.py`` (Pallas ``_kernel``, launch
at ``bcsr_spmm.py:165``), ``plus_times`` form with the optional fused
``max(C + bias, 0)`` epilogue. The kernel source is
``repro_torch/csrc/bcsr_spmm.cu``.

Launch geometry: a row-split grid ``(nrb, n / block_n)``, block
``(block_n, bs_r)``; the CTA of block-row i walks ``row_ptr[i] ..
row_ptr[i+1]``, so work scales with the valid stored blocks and tail
padding is never visited. Empty block-rows are written by the kernel
itself (the epilogue of the semiring zero), which is the fill the
reference wrapper splices in after its Pallas call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # values, row_ptr, col_idx, valid, b, bias, out, nrb, bs_r, bs_c, n,
    # block_n, fuse_bias_relu, stream
    "bcsr_spmm_f32": (_P,) * 7 + (_I,) * 6 + (_P,),
}


def launch_geometry(
    a: BlockCSRMatrix, n: int, block_n: int = DEFAULT_BLOCK_N
) -> tuple[tuple[int, int], tuple[int, int]]:
    """(grid, block) of the launch for an (·, n) panel, n % block_n == 0."""
    return (a.n_row_blocks, n // block_n), (block_n, a.block_shape[0])


def grid_steps(a: BlockCSRMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products the launch walks: the valid stored blocks, once
    per column tile (host-side: reads ``row_ptr[-1]``)."""
    return a.nnz_blocks() * (-(-n // block_n))


def bcsr_spmm_plain(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    fuse_bias_relu: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device (f32).
    Empty block-rows come out as the semiring zero and then pass the
    epilogue, exactly the kernel's (and the reference wrapper's) fill."""
    out = sparse_ops.bcsr_matmul(a.to(dtype=torch.float32), b.float())
    if fuse_bias_relu:
        out = sparse_ops.relu(out + bias.float()[:, None])
    return out


def bcsr_spmm_cuda(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor,
    *,
    fuse_bias_relu: bool,
    block_n: int,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32 values, ``b`` (k, n)
    contiguous with ``n % block_n == 0``, ``bias`` (m,) f32."""
    m, k = a.shape
    n = b.shape[1]
    bs_r, bs_c = a.block_shape
    need = functools.partial(_build.require, "bcsr_spmm")
    need(a.values.dtype == b.dtype == bias.dtype == torch.float32,
         "f32 values, panel and bias")
    need(a.row_ptr.dtype == a.col_idx.dtype == torch.int32 and a.valid.dtype == torch.bool,
         "int32 row_ptr/col_idx and bool valid")
    _build.require_contiguous_on(b.device, "bcsr_spmm",
                                 a.values, a.row_ptr, a.col_idx, a.valid, b, bias)
    need(b.shape[0] == k and n % block_n == 0 and bias.shape == (m,),
         f"b ({k}, n) with n % {block_n} == 0 and bias ({m},)")
    need(block_n * bs_r <= 1024, "block_n * bs_r <= 1024 threads")
    lib = _build.load("bcsr_spmm", SIGNATURES)
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    p = _build.pointer
    err = lib.bcsr_spmm_f32(
        p(a.values), p(a.row_ptr), p(a.col_idx), p(a.valid), p(b), p(bias),
        p(out), a.n_row_blocks, bs_r, bs_c, n, block_n, int(fuse_bias_relu),
        _build.stream_handle(b.device),
    )
    _build.check(lib, err, "bcsr_spmm")
    return out

