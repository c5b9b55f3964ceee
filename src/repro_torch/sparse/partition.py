"""Balanced row-block partitioning of block-CSR matrices across a mesh —
counterpart of ``repro/sparse/partition.py``.

The flattened nnz-block segment of a
:class:`~repro_torch.sparse.bcsr.BlockCSRMatrix` (row-major by
construction) is cut into ``n_shards`` contiguous runs of near-equal
nnz. The arithmetic semiring's ``⊕`` is ``+``, so a block-row whose
blocks straddle a cut is still correct: each shard computes a partial
row product and the sharded plan (``repro_torch.plan.sharded``) sums the
partial panels before the bias and ReLU.

:class:`ShardedBlockCSR` stacks the per-shard sub-layouts into tensors
with a leading shard axis, as the reference's does, and shard ``s``'s
slice is an ordinary :class:`BlockCSRMatrix` of the global shape and
row indexing, which the ``bcsr_spmm`` kernel runs unchanged. The
partition is host numpy, the reference's own code, so every integer
tensor (``row_ptr``, ``row_id``, ``col_idx``, ``valid``,
``gather_index``) equals the reference's.

A shard that receives no block (a very sparse or skewed topology) gets
an empty sub-layout — one invalid padding slot, an all-zero ``row_ptr``
— whose product is exactly zero.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix

# Tensor order of a ShardedBlockCSR (the reference's pytree leaf order).
SHARDED_CSR_LEAVES = (
    "values",
    "row_ptr",
    "row_id",
    "col_idx",
    "valid",
    "gather_index",
)


class _Rescatter(torch.autograd.Function):
    """Fresh unsharded values → the stacked shard layout, and back.

    The backward writes each valid slot's cotangent to its one source
    slot by index assignment: valid slots map one-to-one onto the
    source's valid slots, so nothing is accumulated and the result does
    not depend on the order a device writes in (an atomic scatter-add
    would)."""

    @staticmethod
    def forward(ctx, flat_values, gather_index, valid):
        ctx.save_for_backward(gather_index, valid)
        ctx.source_shape = flat_values.shape
        gathered = flat_values[gather_index.long()]
        return torch.where(valid[:, :, None, None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=gathered.device))

    @staticmethod
    def backward(ctx, g):
        gather_index, valid = ctx.saved_tensors
        out = torch.zeros(ctx.source_shape, dtype=g.dtype, device=g.device)
        out[gather_index[valid].long()] = g[valid]
        return out, None, None


@dataclasses.dataclass
class ShardedBlockCSR:
    """A block-CSR matrix split into per-shard sub-segments.

    Every tensor has a leading ``n_shards`` axis; shard ``s``'s slice is
    a valid :class:`BlockCSRMatrix` of the same logical ``shape`` holding
    only its blocks (global ``row_id``/``col_idx``, a per-shard
    ``row_ptr`` counting its blocks per global block-row; rows with none
    come out of the kernel as exact zeros). ``gather_index`` maps each
    slot back to its source slot in the unsharded ``values``, so fresh
    values re-shard with one gather (:meth:`rescatter_values`).
    """

    values: torch.Tensor  # (S, Tp, bs_r, bs_c)
    row_ptr: torch.Tensor  # (S, nrb + 1) int32 — local counts per global row
    row_id: torch.Tensor  # (S, Tp) int32 — GLOBAL block-row ids
    col_idx: torch.Tensor  # (S, Tp) int32
    valid: torch.Tensor  # (S, Tp) bool
    gather_index: torch.Tensor  # (S, Tp) int32 into the unsharded segment
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    # --- structure --------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return self.values.shape[0]

    @property
    def local_total_blocks(self) -> int:
        """Per-shard segment length ``Tp``."""
        return self.values.shape[1]

    @property
    def n_row_blocks(self) -> int:
        return self.shape[0] // self.block_shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def nnz_per_shard(self) -> np.ndarray:
        """(S,) valid-block counts — the balance the partitioner targets."""
        return self.valid.cpu().numpy().sum(axis=1)

    def imbalance(self) -> float:
        """max-shard-nnz / mean-shard-nnz (1.0 = perfectly balanced);
        ``1 + O(S / nnz)`` for the equal-count split."""
        nnz = self.nnz_per_shard()
        total = int(nnz.sum())
        if total == 0:
            return 1.0
        return float(nnz.max() * self.n_shards / total)

    def shard(self, s: int) -> BlockCSRMatrix:
        """Shard ``s``'s sub-layout as a :class:`BlockCSRMatrix` of views
        (global shape and indexing)."""
        return BlockCSRMatrix(self.values[s], self.row_ptr[s], self.row_id[s],
                              self.col_idx[s], self.valid[s], self.shape, self.block_shape)

    def rescatter_values(self, flat_values: torch.Tensor) -> torch.Tensor:
        """Fresh unsharded values (``(T, bs_r, bs_c)``) → the stacked
        ``(S, Tp, bs_r, bs_c)`` layout through the frozen partition;
        differentiable, its backward an index assignment onto the
        caller's segment (invalid source slots get 0)."""
        return _Rescatter.apply(flat_values, self.gather_index, self.valid)

    def with_values(self, stacked_values: torch.Tensor) -> "ShardedBlockCSR":
        return dataclasses.replace(self, values=stacked_values)

    def to_dense(self) -> torch.Tensor:
        """Σ over shards of the per-shard densifications: every stored
        block lands in exactly one shard, so this is the original."""
        out = self.shard(0).to_dense()
        for s in range(1, self.n_shards):
            out = out + self.shard(s).to_dense()
        return out


def partition_block_csr(a: BlockCSRMatrix, n_shards: int) -> ShardedBlockCSR:
    """Split ``a``'s stored-block segment into ``n_shards`` contiguous,
    nnz-balanced sub-segments (host numpy; the result on ``a``'s device).

    Valid slots are dealt to shards in CSR order by an equal-count split
    (sizes differ by at most one), so the nnz imbalance is at most
    ``1 + n_shards / nnz``. The source's tail padding is dropped; each
    shard is padded to the common length ``Tp = max(1, ceil(nnz /
    n_shards))`` with invalid slots whose ``row_id`` is the shard's last
    valid block's. Shards beyond the available blocks are empty
    sub-layouts, not errors.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    row_id = a.row_id.cpu().numpy()
    col_idx = a.col_idx.cpu().numpy()
    valid = a.valid.cpu().numpy().astype(bool)
    values = a.values.detach().cpu().numpy()
    bs_r, bs_c = a.block_shape
    nrb = a.n_row_blocks

    slots = np.nonzero(valid)[0]  # CSR order by construction
    splits = np.array_split(slots, n_shards)
    tp = max(1, max((len(s) for s in splits), default=1))

    S = n_shards
    out_values = np.zeros((S, tp, bs_r, bs_c), values.dtype)
    out_row_id = np.zeros((S, tp), np.int32)
    out_col = np.zeros((S, tp), np.int32)
    out_valid = np.zeros((S, tp), bool)
    out_gidx = np.zeros((S, tp), np.int32)
    out_rptr = np.zeros((S, nrb + 1), np.int32)
    for s, idx in enumerate(splits):
        k = len(idx)
        if k == 0:
            continue  # degenerate shard: the empty sub-layout stays inert
        out_values[s, :k] = values[idx]
        out_row_id[s, :k] = row_id[idx]
        out_row_id[s, k:] = row_id[idx][-1]  # pin padding to the last row
        out_col[s, :k] = col_idx[idx]
        out_valid[s, :k] = True
        out_gidx[s, :k] = idx
        counts = np.bincount(row_id[idx], minlength=nrb).astype(np.int64)
        np.cumsum(counts, out=out_rptr[s, 1:])
    dev = a.device
    return ShardedBlockCSR(
        *(torch.from_numpy(x).to(dev)
          for x in (out_values, out_rptr, out_row_id, out_col, out_valid, out_gidx)),
        a.shape,
        a.block_shape,
    )


def stack_transpose_plans(sharded: ShardedBlockCSR) -> BcsrTransposePlan:
    """The per-shard backward transposes, stacked: each shard's
    sub-layout sorted into transposed CSR order once (S sorts per
    topology), the plans' tensors stacked on a leading shard axis.
    :func:`shard_transpose_plan` is shard ``s``'s own plan."""
    plans = [sharded.shard(s).transpose_plan() for s in range(sharded.n_shards)]
    first = plans[0]
    return BcsrTransposePlan(
        *(torch.stack([getattr(p, f) for p in plans])
          for f in ("order", "row_ptr", "row_id", "col_idx", "valid")),
        first.shape,
        first.block_shape,
    )


def shard_transpose_plan(stacked: BcsrTransposePlan, s: int) -> BcsrTransposePlan:
    """Shard ``s``'s slice of :func:`stack_transpose_plans` (views)."""
    return BcsrTransposePlan(stacked.order[s], stacked.row_ptr[s], stacked.row_id[s],
                             stacked.col_idx[s], stacked.valid[s], stacked.shape,
                             stacked.block_shape)
