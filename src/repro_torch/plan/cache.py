"""LRU cache of :class:`~repro_torch.plan.StackPlan` objects.

Counterpart of ``repro/plan/cache.py`` without the mesh branch (sharded
plans arrive with the scale-out slice, ROADMAP Queue 1 item 10).
Serving looks a plan up per dispatched panel; after the first panel of
each width class every lookup is a hit.

Because plans bind weight/bias tensors (serving weights are frozen), a
hit additionally requires the cached plan's bound tensors to be the
same objects the caller passed; a same-topology stack with different
values rebuilds instead of silently serving stale numbers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

from repro_torch.core.dnn import Weight
from repro_torch.plan.stack_plan import (
    PlanKey,
    StackPlan,
    build_plan,
    topology_fingerprint,
)


def _same_objects(a: Sequence, b: Sequence) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


class PlanCache:
    """Bounded LRU plan cache with observable hit/miss/eviction stats."""

    def __init__(self, max_size: int = 16):
        if max_size < 1:
            raise ValueError("max_size must be >= 1")
        self.max_size = max_size
        self._entries: "OrderedDict[PlanKey, StackPlan]" = OrderedDict()
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(
        self,
        weights: Sequence[Weight],
        biases,
        width: int,
        *,
        use_resident: bool | None = None,
        fingerprint: str | None = None,
        differentiable: bool = False,
    ) -> StackPlan:
        """The plan for this (stack, width, residency, differentiable?) —
        cached. ``fingerprint`` skips the host-side topology hash when the
        caller already knows it."""
        weights = tuple(weights)
        biases = tuple(biases)
        if fingerprint is None:
            fingerprint = topology_fingerprint(weights)
        key = PlanKey(fingerprint, width, use_resident, differentiable=differentiable)
        self.lookups += 1
        plan = self._entries.get(key)
        if (
            plan is not None
            and _same_objects(plan.source_weights, weights)
            and _same_objects(plan.biases, biases)
        ):
            self.hits += 1
            self._entries.move_to_end(key)
            return plan
        self.misses += 1
        # A plan for the same stack at ANOTHER width class donates its
        # width-independent pieces (relayouted weights, fused stack,
        # cached transposes: a topology is sorted once for every width).
        donor = None
        for cand in reversed(self._entries.values()):
            if (
                cand.key._replace(width=width) == key
                and _same_objects(cand.source_weights, weights)
                and _same_objects(cand.biases, biases)
            ):
                donor = cand
                break
        plan = build_plan(
            weights,
            biases,
            width,
            use_resident=use_resident,
            fingerprint=fingerprint,
            donor=donor,
            differentiable=differentiable,
        )
        self.builds += 1
        self._entries[plan.key] = plan
        self._entries.move_to_end(plan.key)
        while len(self._entries) > self.max_size:
            self._entries.popitem(last=False)
            self.evictions += 1
        return plan
