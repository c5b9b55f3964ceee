"""Build-once plans for GraphBLAS ``mxm``/``mxv`` on sparse operands —
counterpart of ``repro/plan/mxm.py``.

``repro_torch.core.graphblas`` sends every sparse × dense product here
instead of to the plain oracles (``repro_torch.sparse.ops``). A plan
binds the execution layout (the ELL-waste heuristic of the stack plans:
a skewed ELL operand is re-laid out to block-CSR once, at build), the
exact launch bill of the kernel route and of the source layout, and the
kernel wrapper for the plan's semiring.

Plans are keyed by :class:`~repro_torch.plan.stack_plan.PlanKey` with the
exact panel width (not quantized: a width-1 ``mxv`` panel is billed at
the 8-wide tile the wrappers run) and the semiring, and reused only for
the *same* operand object, because the fingerprint hashes topology, not
values. The cache is per process, bounded at ``_MAX_PLANS``.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Union

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.plan.cost import layer_grid_steps
from repro_torch.plan.layout import layer_layout, to_preferred_layout
from repro_torch.plan.stack_plan import PlanKey, topology_fingerprint
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

SparseMatrix = Union[BlockSparseMatrix, BlockCSRMatrix]

_MAX_PLANS = 32


@dataclasses.dataclass
class MxmPlan:
    """One sparse operand × one panel width × one semiring.

    ``grid_steps`` is the launch bill of the kernel route on the
    execution layout; ``xla_equiv_grid_steps`` is the bill of the
    *source* layout — what a product on the caller's ELL operand pays,
    padding included (the reference's name for its XLA einsum path).
    """

    key: PlanKey
    source_layout: str  # caller's layout ("ell" / "bcsr")
    layout: str  # execution layout after the waste heuristic
    width: int  # the exact panel width this plan bills for
    grid_steps: int
    xla_equiv_grid_steps: int
    weight: SparseMatrix  # execution operand (possibly re-laid out)
    source: SparseMatrix  # the operand the plan was built from
    _fn: Callable[[SparseMatrix, torch.Tensor], torch.Tensor]

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self._fn(self.weight, b)


_cache: "OrderedDict[PlanKey, MxmPlan]" = OrderedDict()
_stats = {"lookups": 0, "hits": 0, "builds": 0, "evictions": 0}


def mxm_cache_stats() -> dict:
    return dict(_stats)


def reset_mxm_cache() -> None:
    _cache.clear()
    for k in _stats:
        _stats[k] = 0


def _executable(layout: str, semiring_name: str):
    if layout == "bcsr":
        return lambda w, b: kernel_ops.bcsr_spmm(w, b, semiring_name=semiring_name)
    return lambda w, b: kernel_ops.bsr_spmm(w, b, semiring_name=semiring_name)


def _build(a: SparseMatrix, n: int, semiring_name: str, key: PlanKey) -> MxmPlan:
    exec_w = to_preferred_layout(a)  # ELL → block-CSR once the pad waste crosses
    return MxmPlan(
        key=key,
        source_layout=layer_layout(a),
        layout=layer_layout(exec_w),
        width=n,
        grid_steps=layer_grid_steps(exec_w, n),
        xla_equiv_grid_steps=layer_grid_steps(a, n),
        weight=exec_w,
        source=a,
        _fn=_executable(layer_layout(exec_w), semiring_name),
    )


def mxm_plan(a: SparseMatrix, n: int, semiring_name: str = "plus_times") -> MxmPlan:
    """The cached plan for ``a ⊕.⊗ B`` with an ``(·, n)`` dense panel.

    A key hit whose plan was built from a *different* operand object
    rebuilds (same topology, possibly other values).
    """
    key = PlanKey(topology_fingerprint([a]), n, False, semiring_name)
    _stats["lookups"] += 1
    plan = _cache.get(key)
    if plan is not None and plan.source is a:
        _stats["hits"] += 1
        _cache.move_to_end(key)
        return plan
    plan = _build(a, n, semiring_name, key)
    _stats["builds"] += 1
    _cache[key] = plan
    _cache.move_to_end(key)
    while len(_cache) > _MAX_PLANS:
        _cache.popitem(last=False)
        _stats["evictions"] += 1
    return plan
