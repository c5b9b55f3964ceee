"""ELL-padded BSR × dense: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/bsr_spmm.py`` (Pallas ``_kernel``, launch
at ``bsr_spmm.py:142``), over any registry semiring, with the
optional fused ``max(C + bias, 0)`` epilogue. The kernel source is
``repro_torch/csrc/bsr_spmm.cu``; its header says how it is laid out.

Launch geometry: one CTA per (block-row, ``cn`` columns) of the chosen
:class:`Tile` (``wide``, or ``narrow`` for panels of at most 16
columns), grid ``(nrb, ⌈n / cn⌉)``, ``⌈bs_r / tm⌉ · cn / tn`` threads
each folding a ``tm × tn`` micro-tile in registers; each CTA walks its
block-row's stored slots (masked slots are skipped before any copy)
through ``stages`` cp.async stages in shared memory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES
from repro_torch.kernels.semirings import kernel_semiring
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bsr import BlockSparseMatrix

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # blocks, col_idx, mask, b, bias, out, nrb, mbpr, bs_r, bs_c, n,
    # tile, fuse_bias_relu, semiring, stream
    "bsr_spmm_f32": (_P,) * 6 + (_I,) * 8 + (_P,),
}
MAX_THREADS = 512  # kMaxThreads, the kernel's __launch_bounds__


@dataclasses.dataclass(frozen=True)
class Tile:
    """One tile shape of the kernel: the ``Tile<CN, TM, TN, STAGES>``
    instantiations of ``csrc/bsr_spmm.cu``, mirrored."""

    id: int  # the tile argument of the C entry
    cn: int
    tm: int
    tn: int
    stages: int

    def threads(self, bs_r: int) -> int:
        return -(-bs_r // self.tm) * (self.cn // self.tn)

    def smem_bytes(self, bs_r: int, bs_c: int) -> int:
        """Dynamic shared memory of one CTA: ``stages`` × (a block with
        ``⌈bs_r / tm⌉ · tm`` rows padded to ``bs_c + 4`` floats, and
        ``bs_c`` gathered panel rows of ``cn`` columns)."""
        rows = -(-bs_r // self.tm) * self.tm
        return self.stages * (rows * (bs_c + 4) + bs_c * self.cn) * 4


TILES = {
    "wide": Tile(0, cn=128, tm=4, tn=4, stages=3),
    "narrow": Tile(1, cn=8, tm=1, tn=1, stages=4),
}
NARROW_MAX_N = 16  # panels this narrow run the narrow tile


def tile_for(n: int) -> Tile:
    """The tile the launch runs for an (·, n) panel."""
    return TILES["narrow" if n <= NARROW_MAX_N else "wide"]


def launch_geometry(a: BlockSparseMatrix, n: int) -> tuple[tuple[int, int], tuple[int]]:
    """(grid, block) of the launch for an (·, n) panel."""
    t = tile_for(n)
    return (a.n_row_blocks, -(-n // t.cn)), (t.threads(a.block_shape[0]),)


def grid_steps(a: BlockSparseMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """The launch's bill: block products in ``block_n``-wide column
    tiles, whatever width a CTA covers. Every CTA visits every slot of
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
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32 values with ``bs_c`` a
    multiple of 4, ``b`` (k, n) contiguous with n a multiple of 4,
    ``bias`` (m,) f32; blocks and panel 16-byte aligned."""
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
    need(b.shape[0] == k and n % 4 == 0 and bias.shape == (m,),
         f"b ({k}, n) with n % 4 == 0 and bias ({m},)")
    need(bs_c % 4 == 0, "block columns in multiples of 4 (16-byte rows)")
    _build.require_aligned("bsr_spmm", a.blocks, b)
    tile = tile_for(n)
    need(tile.threads(bs_r) <= MAX_THREADS, f"at most {MAX_THREADS} threads a CTA")
    need(tile.smem_bytes(bs_r, bs_c) <= SMEM_LIMIT_BYTES,
         f"at most {SMEM_LIMIT_BYTES} bytes of shared memory a CTA")
    need(-(-n // tile.cn) <= 65535, "at most 65535 column tiles")
    with _build.on_card(b.device):
        sid = kernel_semiring(semiring_name).id
        lib = _build.load("bsr_spmm", SIGNATURES)
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        p = _build.pointer
        err = lib.bsr_spmm_f32(
            p(a.blocks), p(a.col_idx), p(a.block_mask), p(b), p(bias), p(out),
            nrb, mbpr, bs_r, bs_c, n, tile.id, int(fuse_bias_relu), sid,
            _build.stream_handle(b.device),
        )
        _build.check(lib, err, "bsr_spmm")
    return out
