"""Whole-stack fused forward: the two CUDA kernels and their plain version.

Counterpart of ``repro/kernels/fused_mlp.py``: ``_kernel`` (launch at
``fused_mlp.py:214``, panel resident on chip) and ``_tiled_kernel``
(launch at ``fused_mlp.py:409``, panel in off-chip scratch). Both run
all L layers of a homogeneous square ``stack_bsr`` stack in one launch,
read ``y0`` and write only ``Y[L]``. The kernel source is
``repro_torch/csrc/fused_mlp.cu``.

Launch geometry (both): grid ``(n / block_n,)`` — one CTA per column
stripe — of 1024 threads. The resident kernel holds the ``(2, m,
block_n)`` ping-pong panel in dynamic shared memory; the tiled kernel
holds it in a global scratch slice of its own per stripe, so its stripes
run in parallel (the TPU version runs them in sequence over one shared
scratch).

On-chip budget: the reference's ``VMEM_SOFT_LIMIT_BYTES`` (12 MiB of
TPU VMEM) becomes :data:`SMEM_LIMIT_BYTES`, the shared memory one Hopper
block can hold, and ``fused_mlp_vmem_bytes`` becomes
:func:`fused_mlp_smem_bytes`, the bytes the resident kernel actually
allocates (the panel pair only: y0 and Y[L] stay in global memory).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bsr import BlockSparseMatrix

# Shared memory one thread block can hold on Hopper (H100/H200): 227 KB
# of the SM's 256 KB, reachable as dynamic shared memory after
# cudaFuncSetAttribute (the kernel's launcher does that above 48 KB).
SMEM_LIMIT_BYTES = 232_448

THREADS = 1024  # kThreads in fused_mlp.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # blocks, col_idx, mask, y0, bias, out, n_layers, nrb, mbpr, bs, n,
    # block_n, panel_bf16, stream
    "fused_mlp_resident": (_P,) * 6 + (_I,) * 7 + (_P,),
    # ... the same with the scratch pointer after out
    "fused_mlp_tiled": (_P,) * 7 + (_I,) * 7 + (_P,),
}

PANEL_DTYPES = {None: torch.float32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def panel_torch_dtype(panel_dtype) -> torch.dtype:
    """Canonical activation-panel dtype: f32 unless the caller opts into
    bf16 panels (``None``, a name, or a torch dtype)."""
    if isinstance(panel_dtype, torch.dtype):
        if panel_dtype in (torch.float32, torch.bfloat16):
            return panel_dtype
    elif panel_dtype in PANEL_DTYPES:
        return PANEL_DTYPES[panel_dtype]
    raise ValueError(f"panel_dtype must be float32 or bfloat16, got {panel_dtype!r}")


def fused_mlp_smem_bytes(
    m: int, block_n: int = DEFAULT_BLOCK_N, panel_dtype=None
) -> int:
    """Shared-memory bytes the resident kernel holds for an m-neuron
    stack: the (2, m, block_n) ping-pong panel in ``panel_dtype``."""
    itemsize = torch.finfo(panel_torch_dtype(panel_dtype)).bits // 8
    return 2 * m * block_n * itemsize


def fused_mlp_eligible(
    w: BlockSparseMatrix,
    block_n: int = DEFAULT_BLOCK_N,
    *,
    panel_dtype=None,
) -> bool:
    """Square layer whose panel pair fits one block's shared memory."""
    m, k = w.shape
    return m == k and fused_mlp_smem_bytes(m, block_n, panel_dtype) <= SMEM_LIMIT_BYTES


def fused_mlp_tiled_eligible(w: BlockSparseMatrix) -> bool:
    """Square layer of any height: the tiled kernel keeps the panel in
    global scratch, so there is no panel-size ceiling."""
    m, k = w.shape
    return m == k


def launch_geometry(n: int, block_n: int = DEFAULT_BLOCK_N) -> tuple[tuple[int], tuple[int]]:
    """(grid, block) of either fused launch for an (m, n) panel."""
    return (n // block_n,), (THREADS,)


def grid_steps(stacked_w: BlockSparseMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products either fused launch walks: every stripe visits
    every slot of every layer (``n_tiles × L × nrb × mbpr``) — the sum
    of the layers' ELL bills."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    return n_layers * nrb * mbpr * (-(-n // block_n))


def fused_mlp_plain(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    panel_dtype=None,
) -> torch.Tensor:
    """Both kernels' function in plain PyTorch, layer by layer, on any
    device: the panel is rounded to ``panel_dtype`` after every layer
    (and on entry), accumulation is f32, the result is f32."""
    pdt = panel_torch_dtype(panel_dtype)
    n_layers = stacked_b.shape[0]
    y = y0.to(pdt)
    for l in range(n_layers):
        w_l = BlockSparseMatrix(
            stacked_w.blocks[l].float(),
            stacked_w.col_idx[l],
            stacked_w.block_mask[l],
            stacked_w.shape,
            stacked_w.block_shape,
        )
        z = sparse_ops.bsr_matmul(w_l, y.float()) + stacked_b[l].float()[:, None]
        y = sparse_ops.relu(z).to(pdt)
    return y.float()


def fused_mlp_cuda(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    tiled: bool,
    block_n: int,
    panel_dtype=None,
) -> torch.Tensor:
    """Launch the resident (``tiled=False``) or tiled kernel on CUDA
    tensors: f32 stack, ``y0`` (m, n) f32 contiguous, n % block_n == 0."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    bs_r, bs_c = stacked_w.block_shape
    m, k = stacked_w.shape
    n = y0.shape[1]
    pdt = panel_torch_dtype(panel_dtype)
    need = functools.partial(_build.require, "fused MLP")
    need(stacked_w.blocks.dtype == y0.dtype == stacked_b.dtype == torch.float32,
         "f32 weights, panel and bias")
    need(stacked_w.col_idx.dtype == torch.int32 and stacked_w.block_mask.dtype == torch.bool,
         "int32 col_idx and bool block_mask")
    _build.require_contiguous_on(y0.device, "fused MLP", stacked_w.blocks,
                                 stacked_w.col_idx, stacked_w.block_mask, stacked_b, y0)
    need(m == k and bs_r == bs_c, "square layers of square blocks")
    need(y0.shape[0] == k and n % block_n == 0 and tuple(stacked_b.shape) == (n_layers, m),
         f"y0 ({k}, n) with n % {block_n} == 0 and bias ({n_layers}, {m})")
    lib = _build.load("fused_mlp", SIGNATURES)
    out = torch.empty((m, n), dtype=torch.float32, device=y0.device)
    p = _build.pointer
    common = (n_layers, nrb, mbpr, bs_r, n, block_n, int(pdt == torch.bfloat16),
              _build.stream_handle(y0.device))
    head = (p(stacked_w.blocks), p(stacked_w.col_idx), p(stacked_w.block_mask),
            p(y0), p(stacked_b), p(out))
    if tiled:
        # one (2, m, block_n) panel pair per column stripe
        scratch = torch.empty((n // block_n, 2, m, block_n), dtype=pdt, device=y0.device)
        err = lib.fused_mlp_tiled(*head, p(scratch), *common)
    else:
        need(fused_mlp_smem_bytes(m, block_n, pdt) <= SMEM_LIMIT_BYTES,
             f"a panel pair within {SMEM_LIMIT_BYTES} B of shared memory")
        err = lib.fused_mlp_resident(*head, *common)
    _build.check(lib, err, "fused_mlp_tiled" if tiled else "fused_mlp_resident")
    return out

