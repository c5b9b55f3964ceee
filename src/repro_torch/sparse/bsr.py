"""Block-compressed sparse row (BSR) weight matrices, ELL-padded.

Counterpart of ``repro/sparse/bsr.py`` over torch tensors. Each block-row
stores ``max_blocks_per_row`` dense ``bs_r × bs_c`` blocks addressed by a
block-column table; rows with fewer blocks are padded.

Padding discipline (unchanged from the reference): padded slots carry
``col_idx = 0``, a zero block and ``block_mask = False``. The kernels
skip masked slots, so padding contributes exactly the semiring zero.

A stacked matrix (``repro_torch.core.dnn.stack_bsr``) is the same class
whose three tensors carry a leading layer axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class BlockSparseMatrix:
    """ELL-padded BSR matrix of logical shape ``shape``.

    Attributes:
      blocks:     (n_row_blocks, max_blocks_per_row, bs_r, bs_c) values.
      col_idx:    (n_row_blocks, max_blocks_per_row) int32 block-column ids.
      block_mask: (n_row_blocks, max_blocks_per_row) bool validity.
      shape:      logical (m, n).
      block_shape: (bs_r, bs_c).
    """

    blocks: torch.Tensor
    col_idx: torch.Tensor
    block_mask: torch.Tensor
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
    def max_blocks_per_row(self) -> int:
        return self.col_idx.shape[-1]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def nnz_blocks(self) -> int:
        """Stored (mask-true) blocks; syncs one scalar to the host."""
        return int(self.block_mask.sum())

    @property
    def nbytes(self) -> int:
        """Storage actually consumed (values + index + mask)."""
        return int(
            self.blocks.numel() * self.blocks.element_size()
            + self.col_idx.numel() * self.col_idx.element_size()
            + self.block_mask.numel()  # bool = 1 byte
        )

    def to(self, device=None, dtype=None) -> "BlockSparseMatrix":
        """Move to ``device`` (and cast the values to ``dtype``)."""
        return BlockSparseMatrix(
            self.blocks.to(device=device, dtype=dtype),
            self.col_idx.to(device=device),
            self.block_mask.to(device=device),
            self.shape,
            self.block_shape,
        )

    # --- integrity --------------------------------------------------------
    def validate(self, *, name: str = "") -> "BlockSparseMatrix":
        """Check the ELL layout invariants; raise ValueError with a
        precise message on the first violation, return ``self`` clean.

        Host-side (copies the arrays to the host once): call at trust
        boundaries such as engine construction, not per step.
        """
        label = name or f"BlockSparseMatrix{self.shape}"
        m, n = self.shape
        bs_r, bs_c = self.block_shape
        if m % bs_r or n % bs_c:
            raise ValueError(
                f"{label}: shape {self.shape} not divisible by block "
                f"{self.block_shape}"
            )
        nrb, ncb = self.n_row_blocks, self.n_col_blocks
        blocks = self.blocks.detach().cpu().float().numpy()
        col_idx = self.col_idx.cpu().numpy()
        mask = self.block_mask.cpu().numpy().astype(bool)
        mbpr = col_idx.shape[1] if col_idx.ndim == 2 else -1
        if col_idx.shape != (nrb, mbpr) or mask.shape != (nrb, mbpr):
            raise ValueError(
                f"{label}: col_idx {col_idx.shape} / block_mask "
                f"{mask.shape} must both be ({nrb}, max_blocks_per_row)"
            )
        if blocks.shape != (nrb, mbpr, bs_r, bs_c):
            raise ValueError(
                f"{label}: blocks shape {blocks.shape} != "
                f"({nrb}, {mbpr}, {bs_r}, {bs_c})"
            )
        if mbpr > 1 and np.any(mask[:, 1:] & ~mask[:, :-1]):
            row = int(np.argmax((mask[:, 1:] & ~mask[:, :-1]).any(axis=1)))
            raise ValueError(
                f"{label}: block_mask of block-row {row} is not a "
                "contiguous prefix (a valid slot follows padding)"
            )
        oob = mask & ((col_idx < 0) | (col_idx >= ncb))
        if np.any(oob):
            row = int(np.argmax(oob.any(axis=1)))
            slot = int(np.argmax(oob[row]))
            raise ValueError(
                f"{label}: col_idx[{row}, {slot}] = "
                f"{int(col_idx[row, slot])} out of [0, {ncb})"
            )
        if mbpr > 1:
            unsorted = mask[:, 1:] & (col_idx[:, 1:] <= col_idx[:, :-1])
            if np.any(unsorted):
                row = int(np.argmax(unsorted.any(axis=1)))
                slot = int(np.argmax(unsorted[row]))
                raise ValueError(
                    f"{label}: col_idx not strictly ascending within "
                    f"block-row {row} (slot {slot}: "
                    f"{int(col_idx[row, slot])} -> "
                    f"{int(col_idx[row, slot + 1])})"
                )
        bad = mask & ~np.isfinite(blocks).all(axis=(2, 3))
        if np.any(bad):
            row = int(np.argmax(bad.any(axis=1)))
            slot = int(np.argmax(bad[row]))
            raise ValueError(
                f"{label}: non-finite value in stored block at "
                f"block-row {row}, slot {slot} "
                f"(block-col {int(col_idx[row, slot])})"
            )
        return self

    # --- conversions ------------------------------------------------------
    @classmethod
    def from_dense(
        cls,
        dense,
        block_shape: Tuple[int, int],
        *,
        pad_to: int | None = None,
        device=None,
    ) -> "BlockSparseMatrix":
        """Build from a dense matrix, keeping blocks with any nonzero.

        Host-side: topology discovery reads the values. ``pad_to`` forces
        ``max_blocks_per_row``. ``device`` defaults to the input's (the
        CPU for a numpy array).
        """
        if device is None:
            device = dense.device if isinstance(dense, torch.Tensor) else "cpu"
        if isinstance(dense, torch.Tensor):
            dense = dense.detach().cpu().numpy()
        dense = np.asarray(dense)
        m, n = dense.shape
        bs_r, bs_c = block_shape
        if m % bs_r or n % bs_c:
            raise ValueError(
                f"shape {dense.shape} not divisible by block {block_shape}"
            )
        nrb, ncb = m // bs_r, n // bs_c
        tiles = dense.reshape(nrb, bs_r, ncb, bs_c).transpose(0, 2, 1, 3)
        nz = np.any(tiles != 0, axis=(2, 3))  # (nrb, ncb)
        counts = nz.sum(axis=1)
        mbpr = int(pad_to if pad_to is not None else max(int(counts.max()), 1))
        if counts.max() > mbpr:
            raise ValueError(f"pad_to={pad_to} < max row occupancy {counts.max()}")
        blocks = np.zeros((nrb, mbpr, bs_r, bs_c), dense.dtype)
        col_idx = np.zeros((nrb, mbpr), np.int32)
        mask = np.zeros((nrb, mbpr), bool)
        for i in range(nrb):
            cols = np.nonzero(nz[i])[0]
            blocks[i, : len(cols)] = tiles[i, cols]
            col_idx[i, : len(cols)] = cols
            mask[i, : len(cols)] = True
        return cls(
            torch.from_numpy(blocks).to(device),
            torch.from_numpy(col_idx).to(device),
            torch.from_numpy(mask).to(device),
            (m, n),
            (bs_r, bs_c),
        )

    def to_dense(self) -> torch.Tensor:
        nrb, mbpr = self.col_idx.shape
        bs_r, bs_c = self.block_shape
        ncb = self.n_col_blocks
        safe = torch.where(
            self.block_mask[:, :, None, None], self.blocks,
            torch.zeros((), dtype=self.dtype, device=self.device),
        )
        tiles = torch.zeros(
            (nrb * ncb, bs_r, bs_c), dtype=self.dtype, device=self.device
        )
        rows = torch.arange(nrb, device=self.device)[:, None].expand(nrb, mbpr)
        flat = (rows * ncb + self.col_idx.long()).reshape(-1)
        # scatter-add: construction never aliases a (row, col) twice
        tiles.index_add_(0, flat, safe.reshape(nrb * mbpr, bs_r, bs_c))
        return (
            tiles.reshape(nrb, ncb, bs_r, bs_c)
            .permute(0, 2, 1, 3)
            .reshape(self.shape)
        )
