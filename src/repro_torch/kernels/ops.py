"""Public wrappers around the kernels — counterpart of ``repro/kernels/ops.py``.

One wrapper per kernel: ``bsr_spmm`` (ELL), ``bcsr_spmm`` (block-CSR),
``fused_mlp_forward`` (panel in shared memory) and
``fused_mlp_tiled_forward`` (panel in global scratch). Each pads the
panel's columns to the tile width the launch runs at
(:func:`effective_block_n`), then:

* on CUDA tensors launches its CUDA kernel — there is no fallback: a
  kernel that cannot build or launch raises;
* on CPU tensors runs the kernel module's plain PyTorch version.

Each CUDA launch adds one to the wrapper's count in :func:`launch_counts`
(and nothing else does), so a run can show which kernels it went
through. The fused wrappers refuse autograd: their activations never
exist outside the kernel, so there is nothing to differentiate.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bcsr_spmm as _bcsr
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import fused_mlp as _fmlp
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.sparse.ops import check_semiring

KERNELS = ("bsr_spmm", "bcsr_spmm", "fused_mlp_forward", "fused_mlp_tiled_forward")
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """CUDA launches per wrapper since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _ceil_mult(size: int, base: int = 8) -> int:
    """Largest power-of-two tile ≤ DEFAULT_BLOCK_N that keeps the pad small."""
    b = DEFAULT_BLOCK_N
    while b > base and size < b:
        b //= 2
    return b


def effective_block_n(n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """The column-tile width a wrapper actually runs for an (·, n) panel
    — the clamp every wrapper below applies, exposed so the cost model
    (``repro_torch.plan.cost``) bills the grid the kernels launch."""
    return min(block_n, _ceil_mult(n))


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[1]) % mult
    return F.pad(x, (0, pad)) if pad else x


def _bias_or_zeros(bias, m: int, like: torch.Tensor, fuse_bias_relu: bool):
    if fuse_bias_relu and bias is None:
        raise ValueError("fuse_bias_relu requires bias")
    if bias is None:
        return torch.zeros((m,), dtype=torch.float32, device=like.device)
    return bias


def bsr_spmm(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Padded ELL-BSR ``C = A · B`` (+ fused ``max(C + bias, 0)``)."""
    check_semiring(semiring_name)
    n = b.shape[1]
    block_n = effective_block_n(n, block_n)
    bias = _bias_or_zeros(bias, a.shape[0], b, fuse_bias_relu)
    bp = _pad_cols(b, block_n)
    if bp.is_cuda:
        out = _bsr.bsr_spmm_cuda(
            a, bp.contiguous(), bias.contiguous(),
            fuse_bias_relu=fuse_bias_relu, block_n=block_n,
        )
        _launches["bsr_spmm"] += 1
    else:
        out = _bsr.bsr_spmm_plain(a, bp, bias, fuse_bias_relu=fuse_bias_relu)
    return out[:, :n]


def bcsr_spmm(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Padded occupancy-exact block-CSR ``C = A · B`` (+ fused epilogue).

    Block-rows with no stored block come out as the epilogue of the
    semiring zero (``max(bias, 0)`` when fused, else 0) — the kernel
    writes them itself, the plain version gets them from its sum.
    """
    check_semiring(semiring_name)
    n = b.shape[1]
    block_n = effective_block_n(n, block_n)
    bias = _bias_or_zeros(bias, a.shape[0], b, fuse_bias_relu)
    bp = _pad_cols(b, block_n)
    if bp.is_cuda:
        out = _bcsr.bcsr_spmm_cuda(
            a, bp.contiguous(), bias.contiguous(),
            fuse_bias_relu=fuse_bias_relu, block_n=block_n,
        )
        _launches["bcsr_spmm"] += 1
    else:
        out = _bcsr.bcsr_spmm_plain(a, bp, bias, fuse_bias_relu=fuse_bias_relu)
    return out[:, :n]


def _refuse_autograd(name: str, where: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward: the {where} kernel never "
            "materializes per-layer activations, so there is nothing to "
            "checkpoint for the backward pass. Differentiate the layered "
            "kernel path instead (the trainable layered forward arrives "
            "with the training slice, ROADMAP Queue 1 item 7)."
        )


def _fused(name, tiled, stacked_w, stacked_b, y0, block_n, panel_dtype):
    n = y0.shape[1]
    block_n = effective_block_n(n, block_n)
    yp = _pad_cols(y0, block_n)
    if yp.is_cuda:
        out = _fmlp.fused_mlp_cuda(
            stacked_w, stacked_b.contiguous(), yp.contiguous(),
            tiled=tiled, block_n=block_n, panel_dtype=panel_dtype,
        )
        _launches[name] += 1
    else:
        out = _fmlp.fused_mlp_plain(stacked_w, stacked_b, yp, panel_dtype=panel_dtype)
    return out[:, :n]


def fused_mlp_forward(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> torch.Tensor:
    """Padded whole-stack forward, ONE launch, the ping-pong panel in
    shared memory. ``stacked_w`` carries a leading L axis
    (``repro_torch.core.dnn.stack_bsr``); square layers only.
    ``panel_dtype="bfloat16"`` halves the panel's shared-memory bill
    (f32 accumulation, f32 result). Not differentiable."""
    _refuse_autograd("fused_mlp_forward", "shared-memory-resident",
                     stacked_w.blocks, stacked_b, y0)
    return _fused("fused_mlp_forward", False, stacked_w, stacked_b, y0,
                  block_n, panel_dtype)


def fused_mlp_tiled_forward(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> torch.Tensor:
    """Padded whole-stack forward, ONE launch, the ping-pong panel in
    global scratch — the route for stacks past the shared-memory budget.
    Same contract as :func:`fused_mlp_forward`, forward-only."""
    _refuse_autograd("fused_mlp_tiled_forward", "global-scratch",
                     stacked_w.blocks, stacked_b, y0)
    return _fused("fused_mlp_tiled_forward", True, stacked_w, stacked_b, y0,
                  block_n, panel_dtype)
