"""The route decision tree — counterpart of ``repro/plan/routes.py``.

    homogeneous square BSR stack, fused allowed?
      └─ panel pair fits shared memory → **fused**: ONE launch of the
               resident kernel for the whole stack
      └─ panel past ``SMEM_LIMIT_BYTES`` → **fused-tiled**: ONE launch,
               the ping-pong panel in global scratch
      └─ no  → **layered**, per layer by execution layout:
               block-CSR → kernel-bcsr, ELL-BSR → kernel-ell

Dense layers (kernel-dense, the reference's ``semiring_matmul``) arrive
with the GraphBLAS slice; a plan over one raises until then.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.dnn import Weight
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import fused_mlp as _fmlp
from repro_torch.plan.layout import layer_layout
from repro_torch.sparse.bsr import BlockSparseMatrix

ROUTE_FUSED = "fused"
ROUTE_FUSED_TILED = "fused-tiled"
ROUTE_LAYERED = "layered"


def _homogeneous_bsr_stack(weights: Sequence[Weight]) -> bool:
    """≥1 layer, all BSR with identical shape / block shape / pad width
    — the structural precondition both fused kernels share."""
    if not weights:
        return False
    first = weights[0]
    if not isinstance(first, BlockSparseMatrix):
        return False
    return all(
        isinstance(w, BlockSparseMatrix)
        and w.shape == first.shape
        and w.block_shape == first.block_shape
        and w.max_blocks_per_row == first.max_blocks_per_row
        for w in weights
    )


def resident_eligible(
    weights: Sequence[Weight],
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> bool:
    """Can this stack run through the shared-memory-resident kernel?"""
    if not _homogeneous_bsr_stack(weights):
        return False
    return _fmlp.fused_mlp_eligible(weights[0], block_n, panel_dtype=panel_dtype)


def fused_route(
    weights: Sequence[Weight],
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> str | None:
    """Which single-launch fused route (if any) fits this stack.

    The boundary is exact: the last resident m is the largest with
    ``fused_mlp_smem_bytes(m, block_n, panel_dtype) <= SMEM_LIMIT_BYTES``,
    and bf16 panels halve the bill. At the defaults (block_n 16, f32
    panels) the 1024-neuron challenge stack is resident and the 4096-,
    16384- and 65536-neuron stacks take fused-tiled.
    """
    if not _homogeneous_bsr_stack(weights):
        return None
    first = weights[0]
    if not _fmlp.fused_mlp_tiled_eligible(first):  # square check
        return None
    if _fmlp.fused_mlp_eligible(first, block_n, panel_dtype=panel_dtype):
        return ROUTE_FUSED
    return ROUTE_FUSED_TILED


def layer_path(w: Weight) -> str:
    """The per-layer execution path of the layered route."""
    layout = layer_layout(w)
    if layout == "bcsr":
        return "kernel-bcsr"
    if layout == "ell":
        return "kernel-ell"
    raise NotImplementedError(
        "dense layers run through semiring_matmul, which the port brings "
        "with the GraphBLAS slice (ROADMAP Queue 1 item 8)"
    )
