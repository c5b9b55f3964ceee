"""Dense semiring product: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/semiring_matmul.py`` (Pallas ``_kernel``,
launch at ``semiring_matmul.py:112``): ``C = A ⊕.⊗ B`` over any registry
semiring, with the optional fused ``max(C + bias, 0)`` epilogue. The
kernel source is ``repro_torch/csrc/semiring_matmul.cu``; its header says
how it is laid out.

Launch geometry: one CTA per ``bm × bn`` output tile of the chosen
:class:`Tile` (``wide``, or ``narrow`` for panels of at most 16
columns), grid ``(⌈m / bm⌉, ⌈n / bn⌉)``, ``threads`` threads each
folding a ``tm × tn`` micro-tile in registers; each CTA walks
``⌈k / bk⌉`` k-tiles through ``stages`` cp.async stages in shared
memory and masks its own ragged edge.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.semirings import kernel_semiring
from repro_torch.sparse import ops as sparse_ops

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # a, b, bias, out, m, n, k, tile, fuse_bias_relu, semiring, stream
    "semiring_matmul_f32": (_P,) * 4 + (_I,) * 6 + (_P,),
}


@dataclasses.dataclass(frozen=True)
class Tile:
    """One tile shape of the kernel: the ``Tile<BM, BN, BK, TM, TN,
    STAGES>`` instantiations of ``csrc/semiring_matmul.cu``, mirrored."""

    id: int  # the tile argument of the C entry
    bm: int
    bn: int
    bk: int
    tm: int
    tn: int
    stages: int

    @property
    def threads(self) -> int:
        return (self.bm // self.tm) * (self.bn // self.tn)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one CTA: ``stages`` A tiles with rows
        padded to ``bk + 4`` floats and ``stages`` B tiles."""
        return self.stages * (self.bm * (self.bk + 4) + self.bk * self.bn) * 4


TILES = {
    "wide": Tile(0, bm=64, bn=64, bk=32, tm=4, tn=4, stages=2),
    "narrow": Tile(1, bm=16, bn=8, bk=32, tm=1, tn=1, stages=3),
}
NARROW_MAX_N = 16  # panels this narrow run the narrow tile


def tile_for(n: int) -> Tile:
    """The tile the launch runs for an (·, n) panel."""
    return TILES["narrow" if n <= NARROW_MAX_N else "wide"]


def launch_geometry(m: int, n: int) -> tuple[tuple[int, int], tuple[int]]:
    """(grid, block) of the launch for an (m, ·) × (·, n) product."""
    t = tile_for(n)
    return (-(-m // t.bm), -(-n // t.bn)), (t.threads,)


def grid_steps(m: int, n: int, k: int, block_m: int, block_n: int, block_k: int) -> int:
    """The launch's bill: the ``block_m × block_n × block_k`` tile
    products of the product at the wrapper's tiles (``dense_block_sizes``
    in ``kernels/ops.py``), whatever tile a CTA covers — every output
    tile takes every k-step."""
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
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32, ``a`` (m, k) and ``b``
    (k, n) contiguous with n and k multiples of 4 and 16-byte aligned,
    ``bias`` (m,)."""
    m, k = a.shape
    n = b.shape[1]
    need = functools.partial(_build.require, "semiring_matmul")
    need(a.dtype == b.dtype == bias.dtype == torch.float32, "f32 operands and bias")
    _build.require_contiguous_on(b.device, "semiring_matmul", a, b, bias)
    need(b.shape[0] == k and bias.shape == (m,), f"b ({k}, n) and bias ({m},)")
    need(n % 4 == 0 and k % 4 == 0, "n and k multiples of 4 (16-byte rows)")
    _build.require_aligned("semiring_matmul", a, b)
    (_, gy), _ = launch_geometry(m, n)
    need(gy <= 65535, "at most 65535 column tiles")
    with _build.on_card(b.device):
        sid = kernel_semiring(semiring_name).id
        lib = _build.load("semiring_matmul", SIGNATURES)
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        p = _build.pointer
        err = lib.semiring_matmul_f32(
            p(a), p(b), p(bias), p(out), m, n, k, tile_for(n).id,
            int(fuse_bias_relu), sid, _build.stream_handle(b.device),
        )
        _build.check(lib, err, "semiring_matmul")
    return out
