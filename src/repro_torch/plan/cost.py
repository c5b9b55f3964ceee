"""Exact launch accounting — counterpart of ``repro/plan/cost.py``.

The reference bills Pallas grid steps. The port bills the block products
its own CUDA launches walk (a CTA visiting one stored-block slot for one
column tile is one step), read from each kernel module's ``grid_steps``
at the tile width the wrappers actually run (:func:`effective_block_n`):

* ELL (``bsr_spmm``): ``nrb × max_blocks_per_row × n_tiles`` — every
  CTA visits its whole row of slots, padding included;
* block-CSR (``bcsr_spmm``): ``valid_blocks × n_tiles`` — the row-split
  launch walks ``row_ptr`` ranges, so tail padding is never visited;
* fused stack: the sum of its layers' ELL bills (each stripe's CTA walks
  every slot of every layer).

``tests/test_torch_plan.py`` pins these against the launch geometry the
kernel modules expose.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.dnn import Weight
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bcsr_spmm as _bcsr
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels.ops import effective_block_n
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def layer_grid_steps(w: Weight, n: int, *, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products one forward layer's launch walks on an (·, n) panel."""
    bn = effective_block_n(n, block_n)
    if isinstance(w, BlockCSRMatrix):
        return _bcsr.grid_steps(w, n, bn)
    if isinstance(w, BlockSparseMatrix):
        return _bsr.grid_steps(w, n, bn)
    raise NotImplementedError(
        "dense layers run through semiring_matmul, which the port brings "
        "with the GraphBLAS slice (ROADMAP Queue 1 item 8)"
    )


def stack_grid_steps(
    weights: Sequence[Weight], n: int, *, block_n: int = DEFAULT_BLOCK_N
) -> int:
    """Total block products of the L-layer stack on an (m, n) panel —
    the same for the layered and (ELL stacks) the fused launches."""
    return sum(layer_grid_steps(w, n, block_n=block_n) for w in weights)
