"""Weight sparsification — counterpart of ``repro/core/pruning.py``.

The pipeline the paper assumes (§I: train with a full matrix, remove
small weights, retrain), at two granularities:

* ``magnitude_prune`` — elements, one global threshold;
* ``block_prune`` — blocks: score each block by a norm and keep the top
  ``blocks_per_row`` of each block-row, an ELL-regular
  :class:`BlockSparseMatrix` the SpMM kernels take.

``PruneSchedule`` drives iterative prune → retrain. Ties rank as the
reference ranks them (a stable sort of the negated scores), so the same
inputs keep the same blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.sparse.bsr import BlockSparseMatrix


def _threshold(w: torch.Tensor, density: float) -> torch.Tensor:
    k = max(1, int(round(w.numel() * density)))
    return torch.sort(w.abs().reshape(-1)).values[-k]


def magnitude_prune(w: torch.Tensor, density: float) -> torch.Tensor:
    """Zero all but the top ``density`` fraction of |w| (global threshold)."""
    if not 0.0 < density <= 1.0:
        raise ValueError(f"density must be in (0, 1], got {density}")
    return torch.where(w.abs() >= _threshold(w, density), w, torch.zeros((), dtype=w.dtype,
                                                                          device=w.device))


def prune_mask(w: torch.Tensor, density: float) -> torch.Tensor:
    """Boolean keep-mask of ``magnitude_prune`` (for masked retraining)."""
    return w.abs() >= _threshold(w, density)


def block_scores(
    w: torch.Tensor, block_shape: tuple[int, int], *, norm: str = "l1"
) -> torch.Tensor:
    """(n_row_blocks, n_col_blocks) score of every block by ``norm``."""
    m, n = w.shape
    bs_r, bs_c = block_shape
    tiles = w.reshape(m // bs_r, bs_r, n // bs_c, bs_c).permute(0, 2, 1, 3)
    if norm == "l1":
        return tiles.abs().sum(dim=(2, 3))
    if norm == "l2":
        return torch.sqrt((tiles * tiles).sum(dim=(2, 3)))
    if norm == "linf":
        return tiles.abs().amax(dim=(2, 3))
    raise ValueError(f"unknown norm {norm!r}")


def block_prune_mask(
    w: torch.Tensor, block_shape: tuple[int, int], blocks_per_row: int, *, norm: str = "l1"
) -> torch.Tensor:
    """(n_row_blocks, n_col_blocks) bool mask keeping the top
    ``blocks_per_row`` blocks of each block-row by ``norm``."""
    scores = block_scores(w, block_shape, norm=norm)
    if blocks_per_row > scores.shape[1]:
        raise ValueError(f"blocks_per_row {blocks_per_row} > {scores.shape[1]}")
    keep = torch.argsort(-scores, dim=1, stable=True)[:, :blocks_per_row]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=w.device)
    return mask.scatter_(1, keep, True)


def apply_block_mask(w: torch.Tensor, mask: torch.Tensor,
                     block_shape: tuple[int, int]) -> torch.Tensor:
    """Zero the masked-off blocks of a dense ``w`` (masked retraining)."""
    bs_r, bs_c = block_shape
    full = mask.repeat_interleave(bs_r, dim=0).repeat_interleave(bs_c, dim=1)
    return torch.where(full, w, torch.zeros((), dtype=w.dtype, device=w.device))


def block_prune(
    w: torch.Tensor, block_shape: tuple[int, int], blocks_per_row: int, *, norm: str = "l1"
) -> BlockSparseMatrix:
    """Prune ``w`` to an ELL-regular BSR matrix of ``blocks_per_row`` slots a
    block-row, on ``w``'s device (the layout is built on the host)."""
    mask = block_prune_mask(w, block_shape, blocks_per_row, norm=norm)
    return BlockSparseMatrix.from_dense(apply_block_mask(w, mask, block_shape), block_shape,
                                        pad_to=blocks_per_row)


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    """Iterative prune → retrain: at ``steps[i]`` the density drops to
    ``densities[i]`` (non-increasing); training goes on with the mask
    frozen."""

    steps: Sequence[int]
    densities: Sequence[float]

    def __post_init__(self):
        if len(self.steps) != len(self.densities):
            raise ValueError("steps and densities must align")
        if list(self.densities) != sorted(self.densities, reverse=True):
            raise ValueError("densities must be non-increasing")

    def density_at(self, step: int) -> float:
        d = 1.0
        for s, dens in zip(self.steps, self.densities):
            if step >= s:
                d = dens
        return d

    def is_prune_step(self, step: int) -> bool:
        return step in set(self.steps)
