"""The route decision tree — counterpart of ``repro/plan/routes.py``.

    homogeneous square BSR stack, not differentiable, fused allowed?
      └─ panel pair fits shared memory → **fused**: ONE launch of the
               resident kernel for the whole stack
      └─ panel past ``SMEM_LIMIT_BYTES`` → **fused-tiled**: ONE launch,
               the ping-pong panel in global scratch
      └─ no  → **layered**, per layer by execution layout:
               block-CSR → kernel-bcsr, ELL-BSR → kernel-ell,
               dense → kernel-dense (``semiring_matmul``), or
               **xla-dense** (the plain fused form, which autograd
               differentiates) when the plan is differentiable
    all layers xla-dense → the stack route reads **xla**.

The route strings are the reference's (public names); ``xla`` names the
plain PyTorch path here.
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
ROUTE_XLA = "xla"


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
    smem_limit: int | None = None,
) -> bool:
    """Can this stack run through the shared-memory-resident kernel (within
    ``smem_limit`` bytes of shared memory, default ``SMEM_LIMIT_BYTES``)?"""
    if not _homogeneous_bsr_stack(weights):
        return False
    return _fmlp.fused_mlp_eligible(weights[0], block_n, panel_dtype=panel_dtype,
                                    smem_limit=smem_limit)


def fused_route(
    weights: Sequence[Weight],
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
    smem_limit: int | None = None,
) -> str | None:
    """Which single-launch fused route (if any) fits this stack.

    The boundary is exact: the last resident m is the largest with
    ``fused_mlp_smem_bytes(m, panel_dtype, block_size) <= smem_limit``
    (default ``SMEM_LIMIT_BYTES``), and bf16 panels halve the panel's
    bill. At the defaults (block_n 16, f32 panels) the 1024-neuron
    challenge stack is resident and the 4096-, 16384- and 65536-neuron
    stacks take fused-tiled. The autotuner moves the boundary through
    ``panel_dtype`` and ``smem_limit`` (a budget above the card's is
    refused). Both fused kernels take ``block_n`` 8 or 16 only: a stack
    either would take at another ``block_n`` is refused with a
    ValueError, not handed a launch that fails.
    """
    if not _homogeneous_bsr_stack(weights):
        return None
    first = weights[0]
    if not _fmlp.fused_mlp_tiled_eligible(first):  # square check
        return None
    if block_n not in _fmlp.BLOCK_NS:
        raise ValueError(
            f"block_n={block_n}: the fused kernels take block_n in {_fmlp.BLOCK_NS}")
    if _fmlp.fused_mlp_eligible(first, block_n, panel_dtype=panel_dtype,
                                smem_limit=smem_limit):
        return ROUTE_FUSED
    return ROUTE_FUSED_TILED


def layer_path(w: Weight, *, differentiable: bool = False) -> str:
    """The per-layer execution path of the layered route."""
    layout = layer_layout(w)
    if layout == "bcsr":
        return "kernel-bcsr"
    if layout == "ell":
        return "kernel-ell"
    return "xla-dense" if differentiable else "kernel-dense"
