"""Re-tiling of block shapes the SpMM kernels cannot launch.

The ELL and block-CSR kernels (``csrc/bsr_spmm.cu``, ``csrc/bcsr_spmm.cu``)
copy 16-byte rows, run at most ``MAX_THREADS`` threads a CTA and stage
their blocks in at most ``SMEM_LIMIT_BYTES`` of shared memory, so they
refuse a block with ``bs_c % 4 != 0``, one taller than 64 rows, or one
too large to stage (128 × 128, 32 × 256). The reference takes any block
shape, so the wrappers in ``kernels.ops`` hand such a matrix over in
launchable sub-blocks:

* block columns are padded to a multiple of 4 with the semiring zero,
  in the blocks and in the matching panel rows (the ⊕-identity and
  ⊗-annihilator, so the pad changes nothing in any semiring);
* a block too tall or too large is split into ``sub_r × sub_c``
  sub-blocks, the largest that launch (ties: more rows), with the ELL
  ``col_idx``/``block_mask`` or the block-CSR ``row_ptr``, ``row_id``,
  ``col_idx`` and ``valid`` re-derived over them.

Every stored entry is still folded once, so the order-independent
semirings give the same bits and NaN still propagates; under
``plus_times`` and ``log_plus`` the fold runs in another order. A shape
that launches as it is passes through untouched.

The topology map is built once per index tensors (cached weakly on them
and their in-place versions, like the piece table); the values are
gathered anew only when the value tensor changes, which a training step
does every step.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.bsr_spmm import MAX_THREADS, Tile
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES
from repro_torch.kernels.semirings import kernel_zero
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.tensor_cache import cached_on


def fits(tile: Tile, bs_r: int, bs_c: int) -> bool:
    """Can ``tile`` launch a ``bs_r × bs_c`` block as it is?"""
    return (bs_c % 4 == 0 and tile.threads(bs_r) <= MAX_THREADS
            and tile.smem_bytes(bs_r, bs_c) <= SMEM_LIMIT_BYTES)


def _divisors(x: int) -> list[int]:
    return [d for d in range(1, x + 1) if x % d == 0]


@functools.lru_cache(maxsize=None)
def launch_block_shape(tile: Tile, bs_r: int, bs_c: int) -> tuple[int, int, int]:
    """``(sub_r, sub_c, pad_c)``: the sub-block shape ``tile`` launches for
    a ``bs_r × bs_c`` block, and ``bs_c`` padded to a multiple of 4 (the
    width the sub-blocks split). ``(bs_r, bs_c, bs_c)`` when the block
    launches as it is."""
    pad_c = -(-bs_c // 4) * 4
    if fits(tile, bs_r, pad_c):
        return bs_r, pad_c, pad_c
    best = None
    for sr in _divisors(bs_r):
        for sc in _divisors(pad_c):
            if sc % 4 == 0 and fits(tile, sr, sc):
                cand = (sr * sc, sr)
                if best is None or cand > best[0]:
                    best = (cand, (sr, sc))
    if best is None:  # a 4-wide column of one row always fits
        raise ValueError(f"no launchable sub-block of {bs_r} x {bs_c}")
    return best[1][0], best[1][1], pad_c


def _split_values(values: torch.Tensor, sub_r: int, sub_c: int, pad_c: int,
                  fill: float) -> torch.Tensor:
    """(..., bs_r, bs_c) blocks → (..., fr, fc, sub_r, sub_c) sub-blocks,
    the columns first padded to ``pad_c`` with ``fill``."""
    bs_r, bs_c = values.shape[-2:]
    if pad_c != bs_c:
        values = F.pad(values, (0, pad_c - bs_c), value=fill)
    lead = values.shape[:-2]
    fr, fc = bs_r // sub_r, pad_c // sub_c
    v = values.reshape(*lead, fr, sub_r, fc, sub_c)
    return v.transpose(-3, -2)  # (..., fr, fc, sub_r, sub_c)


def _pad_panel(b: torch.Tensor, bs_c: int, pad_c: int, fill: float) -> torch.Tensor:
    """Pad each block-column's ``bs_c`` panel rows to ``pad_c`` with ``fill``."""
    if pad_c == bs_c:
        return b
    k, n = b.shape
    return F.pad(b.reshape(k // bs_c, bs_c, n), (0, 0, 0, pad_c - bs_c),
                 value=fill).reshape(-1, n)


def _ell_topology(a: BlockSparseMatrix, sub_r: int, sub_c: int, pad_c: int):
    nrb, mbpr = a.col_idx.shape
    fr, fc = a.block_shape[0] // sub_r, pad_c // sub_c
    shape = (nrb, fr, mbpr, fc)
    j = torch.arange(fc, dtype=torch.int32, device=a.device)
    mask = a.block_mask[:, None, :, None].expand(shape)
    cols = torch.where(mask, a.col_idx[:, None, :, None] * fc + j, 0)
    return (cols.reshape(nrb * fr, mbpr * fc).contiguous(),
            mask.reshape(nrb * fr, mbpr * fc).contiguous())


def retile_bsr(a: BlockSparseMatrix, sub_r: int, sub_c: int, pad_c: int,
               fill: float = 0.0) -> BlockSparseMatrix:
    """``a`` in ``sub_r × sub_c`` sub-blocks over columns padded to
    ``pad_c`` (shape ``(m, n_col_blocks · pad_c)``); sub-row i of block-row
    r is block-row ``r·fr + i``, sub-column j of slot s is slot
    ``s·fc + j``, so the columns stay ascending and the mask a prefix."""
    bs_r, bs_c = a.block_shape
    col_idx, mask = cached_on((a.col_idx, a.block_mask), ("ell", sub_r, sub_c, pad_c),
                            lambda: _ell_topology(a, sub_r, sub_c, pad_c))

    def values():
        v = _split_values(a.blocks, sub_r, sub_c, pad_c, fill)  # (nrb, mbpr, fr, fc, sr, sc)
        return v.transpose(1, 2).reshape(*col_idx.shape, sub_r, sub_c).contiguous()

    blocks = cached_on((a.blocks,), ("ell", sub_r, sub_c, pad_c, fill), values)
    return BlockSparseMatrix(blocks, col_idx, mask, (a.shape[0], a.n_col_blocks * pad_c),
                             (sub_r, sub_c))


def _bcsr_topology(a: BlockCSRMatrix, sub_r: int, sub_c: int, pad_c: int):
    """The sub-block slots in CSR order: ``(perm, row_ptr, row_id,
    col_idx, valid)``, ``perm[new slot]`` the flat index
    ``t·fr·fc + i·fc + j`` of stored slot t's sub-block (i, j)."""
    fr, fc = a.block_shape[0] // sub_r, pad_c // sub_c
    dev = a.device
    total = a.total_blocks
    rp = a.row_ptr.long()
    lens = rp[1:] - rp[:-1]
    t = torch.arange(total, device=dev)
    rows = torch.where(a.valid, a.row_id.long(), 0)
    i = torch.arange(fr, device=dev)[None, :, None]
    j = torch.arange(fc, device=dev)[None, None, :]
    # valid slot t of row r, sub-block (i, j): row r·fr + i holds, in
    # order, sub-column j of each of row r's slots; tail slots stay last
    start = (fr * fc * rp[rows] + (t - rp[rows]) * fc)[:, None, None]
    pos = torch.where(a.valid[:, None, None], start + i * (lens[rows] * fc)[:, None, None] + j,
                      fr * fc * t[:, None, None] + i * fc + j)
    perm = torch.empty(total * fr * fc, dtype=torch.long, device=dev)
    perm[pos.reshape(-1)] = torch.arange(total * fr * fc, device=dev)
    valid = a.valid.repeat_interleave(fr * fc)[perm]
    new_rows = (rows[:, None, None] * fr + i).expand(total, fr, fc).reshape(-1)[perm]
    new_cols = (a.col_idx.long()[:, None, None] * fc + j).expand(total, fr, fc).reshape(-1)[perm]
    nnz = valid.sum()
    last_row = torch.where(nnz > 0, new_rows[(nnz - 1).clamp_min(0)], 0)
    row_ptr = torch.cat([(fr * fc * rp[:-1, None]
                          + torch.arange(fr, device=dev)[None] * (lens * fc)[:, None]).reshape(-1),
                         (fr * fc * rp[-1:])])
    return (perm, row_ptr.int(), torch.where(valid, new_rows, last_row).int(),
            torch.where(valid, new_cols, 0).int(), valid)


def retile_bcsr(a: BlockCSRMatrix, sub_r: int, sub_c: int, pad_c: int,
                fill: float = 0.0) -> BlockCSRMatrix:
    """``a`` in ``sub_r × sub_c`` sub-blocks over columns padded to
    ``pad_c``: block-row ``r·fr + i`` holds sub-row i of row r's blocks,
    each split into its ``fc`` sub-columns in order; invalid tail slots
    stay invalid at the end, riding on the last valid row."""
    keys = (a.row_ptr, a.row_id, a.col_idx, a.valid)
    perm, row_ptr, row_id, col_idx, valid = cached_on(
        keys, ("bcsr", sub_r, sub_c, pad_c), lambda: _bcsr_topology(a, sub_r, sub_c, pad_c))

    def values():
        v = _split_values(a.values, sub_r, sub_c, pad_c, fill)  # (T, fr, fc, sr, sc)
        return v.reshape(-1, sub_r, sub_c)[perm]

    vals = cached_on((a.values, *keys), ("bcsr", sub_r, sub_c, pad_c, fill), values)
    return BlockCSRMatrix(vals, row_ptr, row_id, col_idx, valid,
                          (a.shape[0], a.n_col_blocks * pad_c), (sub_r, sub_c))


def for_launch(a, b: torch.Tensor, tile: Tile, semiring_name: str):
    """``(a, b)`` as ``tile`` launches them: unchanged when ``a``'s block
    shape fits, else ``a`` re-tiled and ``b``'s rows padded to match, the
    pads filled with ``semiring_name``'s zero."""
    bs_r, bs_c = a.block_shape
    sub_r, sub_c, pad_c = launch_block_shape(tile, bs_r, bs_c)
    if (sub_r, sub_c) == (bs_r, bs_c):
        return a, b
    fill = kernel_zero(semiring_name)
    retile = retile_bcsr if isinstance(a, BlockCSRMatrix) else retile_bsr
    return retile(a, sub_r, sub_c, pad_c, fill), _pad_panel(b, bs_c, pad_c, fill)
