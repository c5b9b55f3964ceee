"""Occupancy-exact block-CSR × dense: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/bcsr_spmm.py`` (Pallas ``_kernel``, launch
at ``bcsr_spmm.py:165``), over any registry semiring, with the
optional fused ``max(C + bias, 0)`` epilogue. The kernel source is
``repro_torch/csrc/bcsr_spmm.cu``; its header says how it is laid out.

Launch geometry: one CTA per (piece, ``cn`` columns) of the chosen
:class:`~repro_torch.kernels.bsr_spmm.Tile` (``wide``, or ``narrow`` for
panels of at most 16 columns), grid ``(pieces, ⌈n / cn⌉)``. The pieces
come from :func:`piece_table`: a block-row of at most
:data:`PIECE_SLOTS` stored blocks is one piece (an empty row a piece of
none, which writes the epilogue of the semiring zero, the fill the
reference wrapper splices in after its Pallas call); a longer row is cut
into ``⌈len / PIECE_SLOTS⌉`` pieces of near-equal length, whose partial
tiles the last of them to finish folds in piece order. Work follows the
valid stored blocks, as the TPU kernel's grid over them does, and tail
padding is never visited.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.kernels.bsr_spmm import NARROW_MAX_N, Tile
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES
from repro_torch.kernels.semirings import kernel_semiring
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # values, col_idx, valid, pieces, cuts, n_pieces, b, bias, out,
    # partials, counters, bs_r, bs_c, n, tile, fuse_bias_relu, semiring,
    # stream
    "bcsr_spmm_f32": (_P,) * 5 + (_I,) + (_P,) * 5 + (_I,) * 6 + (_P,),
}
MAX_THREADS = 512  # kMaxThreads, the kernel's __launch_bounds__
PIECE_SLOTS = 32  # kPieceSlots: the most stored blocks one piece folds
TILES = {  # the Tile<CN, TM, TN, STAGES> instantiations of csrc/bcsr_spmm.cu
    "wide": Tile(0, cn=128, tm=4, tn=4, stages=3),
    "narrow": Tile(1, cn=8, tm=1, tn=1, stages=4),
}


def tile_for(n: int) -> Tile:
    """The tile the launch runs for an (·, n) panel."""
    return TILES["narrow" if n <= NARROW_MAX_N else "wide"]


@dataclasses.dataclass(frozen=True)
class PieceTable:
    """The pieces a launch walks, on the matrix's device.

    ``pieces`` (P, 4) int32 rows ``(block-row, first slot, end slot,
    cut row or -1)``: the ``n_cut_pieces`` pieces of the cut rows first
    (each cut row's in slot order), then one piece per whole row, longest
    first. ``cuts`` (C, 2) int32 rows ``(first piece, pieces)`` of each
    cut row. Only cut pieces write a partial tile, so the workspace holds
    ``n_cut_pieces`` tiles per column tile."""

    pieces: torch.Tensor
    cuts: torch.Tensor
    n_pieces: int
    n_cut_rows: int
    n_cut_pieces: int


def _build_piece_table(row_ptr: torch.Tensor, slots: int) -> PieceTable:
    rp = row_ptr.long()
    lens = rp[1:] - rp[:-1]
    nrb = lens.numel()
    cut = lens > slots
    parts = torch.where(cut, (lens + slots - 1) // slots, torch.ones_like(lens))
    # one host read per table: the cut rows and their pieces
    n_cut_rows, n_cut_pieces = torch.stack(
        [cut.sum(), torch.where(cut, parts, 0).sum()]).tolist()
    n_pieces = nrb - n_cut_rows + n_cut_pieces
    # cut rows first (in row order), then whole rows longest first
    order = torch.argsort(torch.where(cut, slots + 1, lens), descending=True, stable=True)
    per_row = parts[order]
    first = torch.cumsum(per_row, 0) - per_row  # each ordered row's first piece
    ranked = torch.arange(nrb, device=rp.device).repeat_interleave(per_row, output_size=n_pieces)
    row = order[ranked]
    k = torch.arange(n_pieces, device=rp.device) - first[ranked]
    length, base, count = lens[row], rp[row], parts[row]
    pieces = torch.stack([row, base + k * length // count, base + (k + 1) * length // count,
                          torch.where(ranked < n_cut_rows, ranked, -1)], dim=1)
    cuts = torch.stack([first[:n_cut_rows], per_row[:n_cut_rows]], dim=1)
    return PieceTable(pieces.int().contiguous(), cuts.int().contiguous(), n_pieces, n_cut_rows,
                      n_cut_pieces)


_tables: dict[int, tuple[weakref.ref, int, PieceTable]] = {}


def piece_table(a: BlockCSRMatrix, slots: int = PIECE_SLOTS) -> PieceTable:
    """The piece table of ``a``'s ``row_ptr``, built with torch ops on its
    device. Tables of :data:`PIECE_SLOTS` are cached per ``row_ptr``
    tensor (weakly, and keyed on its in-place version), so a matrix the
    layered or GraphBLAS loops reuse reads the table's size to the host
    once, not once a call."""
    rp = a.row_ptr
    if slots != PIECE_SLOTS:
        return _build_piece_table(rp, slots)
    key = id(rp)
    hit = _tables.get(key)
    if hit is not None and hit[0]() is rp and hit[1] == rp._version:
        return hit[2]
    table = _build_piece_table(rp, slots)

    def forget(ref, key=key):
        if _tables.get(key, (None,))[0] is ref:
            del _tables[key]

    _tables[key] = (weakref.ref(rp, forget), rp._version, table)
    return table


def launch_geometry(a: BlockCSRMatrix, n: int) -> tuple[tuple[int, int], tuple[int]]:
    """(grid, block) of the launch for an (·, n) panel."""
    t = tile_for(n)
    return (piece_table(a).n_pieces, -(-n // t.cn)), (t.threads(a.block_shape[0]),)


def grid_steps(a: BlockCSRMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """The launch's bill: block products in ``block_n``-wide column
    tiles, whatever width a CTA covers — the valid stored blocks, each
    folded by exactly one piece (host-side: reads ``row_ptr[-1]``)."""
    return a.nnz_blocks() * (-(-n // block_n))


def bcsr_spmm_plain(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device (f32).
    Empty block-rows come out as the semiring zero and then pass the
    epilogue, exactly the kernel's (and the reference wrapper's) fill."""
    out = sparse_ops.bcsr_matmul(a.to(dtype=torch.float32), b.float(),
                                kernel_semiring(semiring_name))
    if fuse_bias_relu:
        out = sparse_ops.relu(out + bias.float()[:, None])
    return out


def bcsr_spmm_cuda(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool,
) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: f32 values with ``bs_c`` a
    multiple of 4, ``b`` (k, n) contiguous with n a multiple of 4,
    ``bias`` (m,) f32; values and panel 16-byte aligned. A matrix with a
    cut row also gets a workspace of partial tiles and zeroed counters."""
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
    need(b.shape[0] == k and n % 4 == 0 and bias.shape == (m,),
         f"b ({k}, n) with n % 4 == 0 and bias ({m},)")
    need(bs_c % 4 == 0, "block columns in multiples of 4 (16-byte rows)")
    _build.require_aligned("bcsr_spmm", a.values, b)
    tile = tile_for(n)
    need(tile.threads(bs_r) <= MAX_THREADS, f"at most {MAX_THREADS} threads a CTA")
    need(tile.smem_bytes(bs_r, bs_c) <= SMEM_LIMIT_BYTES,
         f"at most {SMEM_LIMIT_BYTES} bytes of shared memory a CTA")
    tiles = -(-n // tile.cn)
    need(tiles <= 65535, "at most 65535 column tiles")
    with _build.on_card(b.device):
        table = piece_table(a)
        sid = kernel_semiring(semiring_name).id
        lib = _build.load("bcsr_spmm", SIGNATURES)
        out = torch.empty((m, n), dtype=torch.float32, device=b.device)
        p = _build.pointer
        partials = counters = None
        if table.n_cut_rows:
            partials = torch.empty((table.n_cut_pieces, tiles, bs_r, tile.cn),
                                   dtype=torch.float32, device=b.device)
            counters = torch.zeros((table.n_cut_rows, tiles), dtype=torch.int32, device=b.device)
        null = ctypes.c_void_p(0)
        err = lib.bcsr_spmm_f32(
            p(a.values), p(a.col_idx), p(a.valid), p(table.pieces), p(table.cuts), table.n_pieces,
            p(b), p(bias), p(out), null if partials is None else p(partials),
            null if counters is None else p(counters), bs_r, bs_c, n, tile.id,
            int(fuse_bias_relu), sid, _build.stream_handle(b.device),
        )
        _build.check(lib, err, "bcsr_spmm")
    return out
