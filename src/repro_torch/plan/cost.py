"""Exact launch accounting — counterpart of ``repro/plan/cost.py``.

The reference bills Pallas grid steps. The port bills the block products
its CUDA launches fold, counted in ``DEFAULT_BLOCK_N``-wide column tiles
at the tile width the wrappers run (:func:`effective_block_n`), whatever
width a CTA covers (a wider CTA folds several such tiles and changes no
bill). Each kernel module's ``grid_steps`` gives its bill:

* ELL (``bsr_spmm``): ``nrb × max_blocks_per_row × n_tiles`` — every
  CTA visits its whole row of slots, padding included;
* block-CSR (``bcsr_spmm``): ``valid_blocks × n_tiles`` — the launch
  walks a piece table that cuts ``row_ptr`` ranges into pieces (long
  rows into several), each valid block in exactly one piece, so tail
  padding is never visited;
* dense (``semiring_matmul``): ``(m/bm) × (n/bn) × (k/bk)`` tile
  products at the wrapper's tiles (:func:`dense_block_sizes`) — every
  output tile takes every k-step;
* fused stack: the sum of its layers' ELL bills (every column tile is
  folded over every slot of every layer).

:func:`stack_block_work` weighs each layer's bill by the area of what one
block product folds (:func:`layer_block_area`): the autotuner's score,
which a re-blocked candidate cannot lower by coarsening the grid.

``tests/test_torch_plan.py``, ``tests/test_torch_mxm_plan.py`` and
``tests/test_torch_tiling.py`` pin these against the launch geometry the
kernel modules expose.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.dnn import Weight
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bcsr_spmm as _bcsr
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import semiring_matmul as _smm
from repro_torch.kernels.ops import dense_block_sizes, effective_block_n
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def layer_grid_steps(w: Weight, n: int, *, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products one forward layer's launch walks on an (·, n) panel."""
    bn = effective_block_n(n, block_n)
    if isinstance(w, BlockCSRMatrix):
        return _bcsr.grid_steps(w, n, bn)
    if isinstance(w, BlockSparseMatrix):
        return _bsr.grid_steps(w, n, bn)
    m, k = w.shape
    return _smm.grid_steps(m, n, k, *dense_block_sizes(m, n, k, block_n))


def mxv_grid_steps(w: Weight, *, block_n: int = DEFAULT_BLOCK_N) -> int:
    """The bill of a GraphBLAS ``mxv``/``vxm``: the vector rides as a
    width-1 panel, which the wrappers run at ``effective_block_n(1)``
    (an 8-wide tile), not a full ``DEFAULT_BLOCK_N`` tile."""
    return layer_grid_steps(w, 1, block_n=block_n)


def stack_grid_steps(
    weights: Sequence[Weight], n: int, *, block_n: int = DEFAULT_BLOCK_N
) -> int:
    """Total block products of the L-layer stack on an (m, n) panel —
    the same for the layered and (ELL stacks) the fused launches."""
    return sum(layer_grid_steps(w, n, block_n=block_n) for w in weights)


def layer_block_area(w: Weight) -> int:
    """Weights one block product of this layer folds: the stored block's
    area (``bs_r × bs_c``), or the dense tile's at the port's own tiles
    (:func:`~repro_torch.kernels.ops.dense_block_sizes`: 16 × 16, where
    the reference bills 128 × 128). Bills at different block sizes are
    comparable only after this weighting: a 32 × 32 product folds 4× the
    weights of a 16 × 16 one."""
    if isinstance(w, (BlockCSRMatrix, BlockSparseMatrix)):
        bs_r, bs_c = w.block_shape
        return bs_r * bs_c
    m, k = w.shape
    bm, _, bk = dense_block_sizes(m, DEFAULT_BLOCK_N, k)
    return bm * bk


def stack_block_work(
    weights: Sequence[Weight], n: int, *, block_n: int = DEFAULT_BLOCK_N
) -> int:
    """Σ layer bill × block area: the block-size-invariant cost the
    autotuner ranks candidates by (``stack_grid_steps × bs²`` for a
    homogeneous stack of square blocks)."""
    return sum(layer_grid_steps(w, n, block_n=block_n) * layer_block_area(w) for w in weights)
