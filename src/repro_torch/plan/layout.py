"""Per-layer layout choice — the ELL-pad waste heuristic.

Counterpart of ``repro/plan/layout.py``, unchanged: the rule has no
hardware content. The ELL launch walks ``nrb × max_blocks_per_row``
slots per column tile; the block-CSR launch walks the valid blocks.
"""

from __future__ import annotations

from repro_torch.core.dnn import Weight
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

# A weight whose ELL pad wastes more than this fraction of its slots
# (1 - nnz / (nrb·mbpr)) is better served by the occupancy-exact grid.
ELL_WASTE_THRESHOLD = 0.25


def layer_layout(w: Weight) -> str:
    """The storage layout of a weight: ``"dense"``, ``"ell"``, ``"bcsr"``."""
    if isinstance(w, BlockCSRMatrix):
        return "bcsr"
    if isinstance(w, BlockSparseMatrix):
        return "ell"
    return "dense"


def preferred_layout(w: BlockSparseMatrix) -> str:
    """``"ell"`` or ``"bcsr"`` — which launch wastes less work
    (host-side: reads the mask)."""
    nrb, mbpr = w.col_idx.shape
    waste = 1.0 - w.nnz_blocks() / float(nrb * mbpr)
    return "bcsr" if waste > ELL_WASTE_THRESHOLD else "ell"


def to_preferred_layout(w: Weight) -> Weight:
    """Re-layout an ELL weight to block-CSR when its pad is wasteful
    enough (host-side; identity for dense and already-CSR weights)."""
    if isinstance(w, BlockSparseMatrix) and preferred_layout(w) == "bcsr":
        return BlockCSRMatrix.from_bsr(w)
    return w
