"""Block-CSR weight matrices — the occupancy-exact sparse layout.

Counterpart of ``repro/sparse/bcsr.py`` over torch tensors. The same
topology as :class:`~repro_torch.sparse.bsr.BlockSparseMatrix` stored in
flattened CSR order, so work scales with the true number of stored
blocks instead of the worst row's occupancy.

Layout (leading dimension ``total_blocks``):

  values:  (total_blocks, bs_r, bs_c)  stored blocks, row-major by
           block-row, columns ascending within a row.
  row_id:  (total_blocks,) int32       block-row of each stored block.
  col_idx: (total_blocks,) int32       block-column of each stored block.
  valid:   (total_blocks,) bool        False only for optional tail
           padding; padded slots carry the ``row_id`` of the last real
           block (the reference kernel's flush rule needs that; the
           port's kernel walks ``row_ptr`` and never reads ``row_id``).
  row_ptr: (n_row_blocks + 1,) int32   CSR offsets over valid blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse.bsr import BlockSparseMatrix


@dataclasses.dataclass
class BlockCSRMatrix:
    """Flattened block-CSR matrix of logical shape ``shape``."""

    values: torch.Tensor  # (T, bs_r, bs_c)
    row_ptr: torch.Tensor  # (nrb + 1,) int32 over valid blocks
    row_id: torch.Tensor  # (T,) int32
    col_idx: torch.Tensor  # (T,) int32
    valid: torch.Tensor  # (T,) bool
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    # --- derived structure ----------------------------------------------
    @property
    def n_row_blocks(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def n_col_blocks(self) -> int:
        return self.shape[1] // self.block_shape[1]

    @property
    def total_blocks(self) -> int:
        """Stored blocks including tail padding."""
        return self.values.shape[0]

    def nnz_blocks(self) -> int:
        """Valid stored blocks; syncs one scalar to the host."""
        return int(self.row_ptr[-1])

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def nbytes(self) -> int:
        return int(
            self.values.numel() * self.values.element_size()
            + self.row_ptr.numel() * self.row_ptr.element_size()
            + self.row_id.numel() * self.row_id.element_size()
            + self.col_idx.numel() * self.col_idx.element_size()
            + self.valid.numel()  # bool = 1 byte
        )

    def to(self, device=None, dtype=None) -> "BlockCSRMatrix":
        """Move to ``device`` (and cast the values to ``dtype``)."""
        return BlockCSRMatrix(
            self.values.to(device=device, dtype=dtype),
            self.row_ptr.to(device=device),
            self.row_id.to(device=device),
            self.col_idx.to(device=device),
            self.valid.to(device=device),
            self.shape,
            self.block_shape,
        )

    # --- integrity --------------------------------------------------------
    def validate(self, *, name: str = "") -> "BlockCSRMatrix":
        """Check the layout invariants; raise ValueError with a precise
        message on the first violation, return ``self`` when clean.

        Host-side: call at trust boundaries, not per step. Checked:
        shape/block divisibility, index-array shapes, ``row_ptr``
        monotone from 0 to nnz, validity a contiguous prefix, in-bounds
        ``row_id``/``col_idx``, row-major storage with strictly ascending
        columns within a block-row, ``row_ptr`` consistent with per-row
        counts, and finite stored values.
        """
        label = name or f"BlockCSRMatrix{self.shape}"
        m, n = self.shape
        bs_r, bs_c = self.block_shape
        if m % bs_r or n % bs_c:
            raise ValueError(
                f"{label}: shape {self.shape} not divisible by block "
                f"{self.block_shape}"
            )
        nrb, ncb = self.n_row_blocks, self.n_col_blocks
        values = self.values.detach().cpu().float().numpy()
        row_ptr = self.row_ptr.cpu().numpy()
        row_id = self.row_id.cpu().numpy()
        col_idx = self.col_idx.cpu().numpy()
        valid = self.valid.cpu().numpy().astype(bool)
        total = values.shape[0]
        if values.shape != (total, bs_r, bs_c):
            raise ValueError(
                f"{label}: values shape {values.shape} != "
                f"({total}, {bs_r}, {bs_c})"
            )
        for arr_name, arr in (("row_id", row_id), ("col_idx", col_idx),
                              ("valid", valid)):
            if arr.shape != (total,):
                raise ValueError(
                    f"{label}: {arr_name} shape {arr.shape} != ({total},)"
                )
        if row_ptr.shape != (nrb + 1,):
            raise ValueError(
                f"{label}: row_ptr shape {row_ptr.shape} != ({nrb + 1},)"
            )
        if row_ptr[0] != 0:
            raise ValueError(f"{label}: row_ptr[0] = {row_ptr[0]}, expected 0")
        if np.any(np.diff(row_ptr) < 0):
            i = int(np.argmax(np.diff(row_ptr) < 0))
            raise ValueError(
                f"{label}: row_ptr not monotone at block-row {i} "
                f"({row_ptr[i]} -> {row_ptr[i + 1]})"
            )
        nnz = int(valid.sum())
        if int(row_ptr[-1]) != nnz:
            raise ValueError(
                f"{label}: row_ptr[-1] = {int(row_ptr[-1])} != valid block "
                f"count {nnz}"
            )
        if np.any(valid[1:] & ~valid[:-1]):
            raise ValueError(
                f"{label}: valid mask is not a contiguous prefix (a valid "
                "block follows an invalid slot)"
            )
        if np.any((row_id < 0) | (row_id >= nrb)):
            bad = int(np.argmax((row_id < 0) | (row_id >= nrb)))
            raise ValueError(
                f"{label}: row_id[{bad}] = {int(row_id[bad])} out of "
                f"[0, {nrb})"
            )
        rows, cols = row_id[:nnz], col_idx[:nnz]
        if nnz and np.any((cols < 0) | (cols >= ncb)):
            bad = int(np.argmax((cols < 0) | (cols >= ncb)))
            raise ValueError(
                f"{label}: col_idx[{bad}] = {int(cols[bad])} out of "
                f"[0, {ncb})"
            )
        if nnz > 1:
            if np.any(rows[1:] < rows[:-1]):
                bad = int(np.argmax(rows[1:] < rows[:-1]))
                raise ValueError(
                    f"{label}: blocks not stored row-major (row_id drops "
                    f"{int(rows[bad])} -> {int(rows[bad + 1])} at slot "
                    f"{bad + 1})"
                )
            same_row = rows[1:] == rows[:-1]
            if np.any(same_row & (cols[1:] <= cols[:-1])):
                bad = int(np.argmax(same_row & (cols[1:] <= cols[:-1])))
                raise ValueError(
                    f"{label}: col_idx not strictly ascending within "
                    f"block-row {int(rows[bad])} (slot {bad}: "
                    f"{int(cols[bad])} -> {int(cols[bad + 1])})"
                )
        counts = np.bincount(rows, minlength=nrb) if nnz else np.zeros(nrb, int)
        if not np.array_equal(np.cumsum(counts), row_ptr[1:]):
            bad = int(np.argmax(np.cumsum(counts) != row_ptr[1:]))
            raise ValueError(
                f"{label}: row_ptr inconsistent with row_id counts at "
                f"block-row {bad}"
            )
        if nnz and not np.isfinite(values[:nnz]).all():
            flat = np.isfinite(values[:nnz]).all(axis=(1, 2))
            bad = int(np.argmax(~flat))
            raise ValueError(
                f"{label}: non-finite value in stored block {bad} "
                f"(block-row {int(rows[bad])}, block-col {int(cols[bad])})"
            )
        return self

    # --- conversions ------------------------------------------------------
    @classmethod
    def from_bsr(
        cls, a: BlockSparseMatrix, *, pad_to: int | None = None
    ) -> "BlockCSRMatrix":
        """Flatten an ELL-padded BSR matrix to CSR order (host-side; the
        result lives on ``a``'s device).

        ``pad_to`` forces ``total_blocks``; padded tail slots are invalid
        zero blocks riding on the last real row.
        """
        mask = a.block_mask.cpu().numpy().astype(bool)
        col_idx = a.col_idx.cpu().numpy()
        blocks = a.blocks.detach().cpu().numpy()
        nrb, mbpr = mask.shape
        bs_r, bs_c = a.block_shape

        rows, slots = np.nonzero(mask)  # row-major → CSR order
        nnz = len(rows)
        total = int(pad_to) if pad_to is not None else max(nnz, 1)
        if nnz > total:
            raise ValueError(f"pad_to={pad_to} < nnz blocks {nnz}")

        values = np.zeros((total, bs_r, bs_c), blocks.dtype)
        row_id = np.zeros((total,), np.int32)
        cols = np.zeros((total,), np.int32)
        valid = np.zeros((total,), bool)
        values[:nnz] = blocks[rows, slots]
        row_id[:nnz] = rows
        cols[:nnz] = col_idx[rows, slots]
        valid[:nnz] = True
        # Tail padding rides on the last real row (reference rule).
        row_id[nnz:] = rows[-1] if nnz else 0

        counts = mask.sum(axis=1).astype(np.int64)
        row_ptr = np.zeros((nrb + 1,), np.int32)
        np.cumsum(counts, out=row_ptr[1:])
        dev = a.device
        return cls(
            torch.from_numpy(values).to(dev),
            torch.from_numpy(row_ptr).to(dev),
            torch.from_numpy(row_id).to(dev),
            torch.from_numpy(cols).to(dev),
            torch.from_numpy(valid).to(dev),
            a.shape,
            a.block_shape,
        )

    @classmethod
    def from_dense(
        cls,
        dense,
        block_shape: Tuple[int, int],
        *,
        pad_to: int | None = None,
        device=None,
    ) -> "BlockCSRMatrix":
        return cls.from_bsr(
            BlockSparseMatrix.from_dense(dense, block_shape, device=device),
            pad_to=pad_to,
        )

    def to_bsr(self, *, pad_to: int | None = None) -> BlockSparseMatrix:
        """Re-widen to the ELL layout (host-side)."""
        row_ptr = self.row_ptr.cpu().numpy()
        counts = row_ptr[1:] - row_ptr[:-1]
        nrb = self.n_row_blocks
        bs_r, bs_c = self.block_shape
        mbpr = int(pad_to if pad_to is not None else max(int(counts.max()), 1))
        if counts.max() > mbpr:
            raise ValueError(f"pad_to={pad_to} < max row occupancy")
        vals = self.values.detach().cpu().numpy()
        cols = self.col_idx.cpu().numpy()
        blocks = np.zeros((nrb, mbpr, bs_r, bs_c), vals.dtype)
        col_idx = np.zeros((nrb, mbpr), np.int32)
        mask = np.zeros((nrb, mbpr), bool)
        for i in range(nrb):
            lo, hi = int(row_ptr[i]), int(row_ptr[i + 1])
            blocks[i, : hi - lo] = vals[lo:hi]
            col_idx[i, : hi - lo] = cols[lo:hi]
            mask[i, : hi - lo] = True
        dev = self.device
        return BlockSparseMatrix(
            torch.from_numpy(blocks).to(dev),
            torch.from_numpy(col_idx).to(dev),
            torch.from_numpy(mask).to(dev),
            self.shape,
            self.block_shape,
        )

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        bs_r, bs_c = self.block_shape
        nrb, ncb = self.n_row_blocks, self.n_col_blocks
        safe = torch.where(
            self.valid[:, None, None], self.values,
            torch.zeros((), dtype=self.dtype, device=self.device),
        )
        tiles = torch.zeros(
            (nrb * ncb, bs_r, bs_c), dtype=self.dtype, device=self.device
        )
        flat = self.row_id.long() * ncb + self.col_idx.long()
        # invalid slots scatter zeros (construction never aliases a pair)
        tiles.index_add_(0, flat, safe)
        return (
            tiles.reshape(nrb, ncb, bs_r, bs_c)
            .permute(0, 2, 1, 3)
            .reshape(m, n)
        )
