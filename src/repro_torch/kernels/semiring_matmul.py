"""Dense semiring product: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/semiring_matmul.py`` (Pallas ``_kernel``,
launch at ``semiring_matmul.py:112``): ``C = A ⊕.⊗ B`` over any registry
semiring, with the optional fused ``max(C + bias, 0)`` epilogue. The
kernel source is ``repro_torch/csrc/semiring_matmul.cu``.

Launch geometry: grid ``(m / block_m, n / block_n)``, block
``(block_n, block_m)``; each CTA walks ``k / block_k`` k-steps, staging
one A and one B tile in shared memory per step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.semirings import kernel_semiring
from repro_torch.sparse import ops as sparse_ops

MAX_TILE = 16  # kMaxTile of the kernel's shared-memory tiles

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # a, b, bias, out, m, n, k, block_m, block_n, block_k, fuse_bias_relu,
    # semiring, stream
    "semiring_matmul_f32": (_P,) * 4 + (_I,) * 8 + (_P,),
}


def launch_geometry(
    m: int, n: int, block_m: int, block_n: int
) -> tuple[tuple[int, int], tuple[int, int]]:
    """(grid, block) of the launch for padded m × n, whole tiles."""
    return (m // block_m, n // block_n), (block_n, block_m)


def grid_steps(m: int, n: int, k: int, block_m: int, block_n: int, block_k: int) -> int:
    """Tile products the launch walks: every CTA takes every k-step."""
    return -(-m // block_m) * -(-n // block_n) * -(-k // block_k)


def semiring_matmul_plain(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device (f32; the
    boolean semirings in their {0, 1} encoding)."""
    out = kernel_semiring(semiring_name).matmul(a.float(), b.float())
    if fuse_bias_relu:
        out = sparse_ops.relu(out + bias.float()[:, None])
    return out


def semiring_matmul_cuda(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool,
    block_m: int,
    block_n: int,
    block_k: int,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32, ``a`` (m, k) and ``b``
    (k, n) contiguous in whole tiles, ``bias`` (m,)."""
    m, k = a.shape
    n = b.shape[1]
    need = functools.partial(_build.require, "semiring_matmul")
    need(a.dtype == b.dtype == bias.dtype == torch.float32, "f32 operands and bias")
    _build.require_contiguous_on(b.device, "semiring_matmul", a, b, bias)
    need(b.shape[0] == k and bias.shape == (m,), f"b ({k}, n) and bias ({m},)")
    need(max(block_m, block_n, block_k) <= MAX_TILE,
         f"block sizes of at most {MAX_TILE}")
    need(m % block_m == 0 and n % block_n == 0 and k % block_k == 0,
         f"m, n, k in whole ({block_m}, {block_n}, {block_k}) tiles")
    sid = kernel_semiring(semiring_name).id
    lib = _build.load("semiring_matmul", SIGNATURES)
    out = torch.empty((m, n), dtype=torch.float32, device=b.device)
    p = _build.pointer
    err = lib.semiring_matmul_f32(
        p(a), p(b), p(bias), p(out), m, n, k, block_m, block_n, block_k,
        int(fuse_bias_relu), sid, _build.stream_handle(b.device),
    )
    _build.check(lib, err, "semiring_matmul")
    return out
