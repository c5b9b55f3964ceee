"""LRU cache of execution plans — counterpart of ``repro/plan/cache.py``.

Holds :class:`~repro_torch.plan.StackPlan` objects and, for a ``mesh``,
:class:`~repro_torch.plan.sharded.ShardedStackPlan` objects, keyed apart
by the mesh fingerprint in :class:`~repro_torch.plan.PlanKey`.
Serving looks a plan up per dispatched panel; after the first panel of
each width class every lookup is a hit, and on the card a hit replays
the plan's captured CUDA graph. Plans of one stack at other width
classes share their width-independent pieces and one graph memory pool
(the ``donor`` of ``build_plan`` and ``build_sharded_plan``).

Because plans bind weight/bias tensors (serving weights are frozen), a
hit additionally requires the cached plan's bound tensors to be the
same objects the caller passed; a same-topology stack with different
values rebuilds instead of silently serving stale numbers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

from repro_torch.core.dnn import Weight
from repro_torch.plan import sharded as _sharded
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

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._entries

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._entries),
            "max_size": self.max_size,
            "lookups": self.lookups,
            "hits": self.hits,
            "misses": self.misses,
            "builds": self.builds,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }

    def plans(self) -> list[StackPlan]:
        """The cached plans, least recently used first."""
        return list(self._entries.values())

    def get(
        self,
        weights: Sequence[Weight],
        biases,
        width: int,
        *,
        use_resident: bool | None = None,
        fingerprint: str | None = None,
        differentiable: bool = False,
        tuned=None,
        mesh=None,
    ) -> StackPlan:
        """The plan for this (stack, width, residency, differentiable?,
        tuned config, mesh) — cached. ``fingerprint`` skips the topology
        hash when the caller already knows it; ``tuned`` (a
        :class:`repro_torch.tune.TunedConfig`) keys the entry by its
        ``token()``; ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`)
        builds a :class:`~repro_torch.plan.sharded.ShardedStackPlan`,
        keyed by the mesh's fingerprint. ``build_sharded_plan`` takes no
        tuning knobs, so a mesh with a tuned config is refused."""
        weights = tuple(weights)
        biases = tuple(biases)
        if mesh is not None and tuned is not None:
            raise ValueError(
                "tuned configs apply to single-device plans only; pass tuned=None "
                "with a mesh")
        if fingerprint is None:
            fingerprint = topology_fingerprint(weights)
        key = PlanKey(fingerprint, width, use_resident, differentiable=differentiable,
                      tuned=None if tuned is None else tuned.token(),
                      mesh=None if mesh is None else _sharded.mesh_fingerprint(mesh))
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
        # cached transposes, partitions, graph memory pool).
        donor = None
        for cand in reversed(self._entries.values()):
            if (
                cand.key._replace(width=width) == key
                and _same_objects(cand.source_weights, weights)
                and _same_objects(cand.biases, biases)
            ):
                donor = cand
                break
        if mesh is not None:
            plan = _sharded.build_sharded_plan(
                weights, biases, width, mesh, differentiable=differentiable,
                use_resident=use_resident, fingerprint=fingerprint, donor=donor)
        else:
            plan = build_plan(
                weights,
                biases,
                width,
                use_resident=use_resident,
                fingerprint=fingerprint,
                donor=donor,
                differentiable=differentiable,
                tuned=tuned,
            )
        self.builds += 1
        self._entries[plan.key] = plan
        self._entries.move_to_end(plan.key)
        while len(self._entries) > self.max_size:
            self._entries.popitem(last=False)
            self.evictions += 1
        return plan

    def compiled_widths(self, fingerprint: str) -> set[int]:
        """Width classes this cache holds a plan for, for one topology
        fingerprint (no building, no LRU touch)."""
        return {key.width for key in self._entries if key.fingerprint == fingerprint}

    def clear(self) -> None:
        self._entries.clear()


# Shared cache behind the module-level convenience wrappers
# (repro_torch.core.dnn.dnn_forward_resident). Engines own their own
# caches; this one serves ad-hoc functional callers. Plans hold strong
# references to the weight stacks they bind (and, on the card, their
# captured graphs), so it is kept SMALL.
_DEFAULT_CACHE: PlanCache | None = None


def default_cache() -> PlanCache:
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        _DEFAULT_CACHE = PlanCache(max_size=4)
    return _DEFAULT_CACHE


def reset_default_cache() -> None:
    """Drop the shared default cache (entries AND stats)."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = None
