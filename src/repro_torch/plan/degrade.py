"""Graceful plan degradation: sharded → resident → layered.

Counterpart of ``repro/plan/degrade.py``, with its three levels:

1. ``sharded``  — the mesh-sharded plan
   (:class:`~repro_torch.plan.sharded.ShardedStackPlan`), when the engine
   was built with a mesh and the level is healthy;
2. ``resident`` — the fused whole-stack plan (shared-memory panel or its
   tiled variant), when the engine resolved residency and the level is
   healthy;
3. ``layered``  — the per-layer kernel plan, the floor: it needs nothing
   but one device and always exists.

``get_plan`` walks the levels top-down and returns the first that builds.
A level whose build fails — a plan-build error, an injected fault — is
marked unhealthy and the walk continues, so the panel that hit the
failure is still served. A CUDA graph capture that fails is a compile
failure too: the engine marks the level unhealthy the same way
(:meth:`DegradationLadder.mark_unhealthy`), and a lost shard
(``SITE_SHARD_FAILURE``) marks ``sharded``. Health marks are sticky
until :meth:`DegradationLadder.restore`, and every transition is recorded
in :attr:`DegradationLadder.events`: a demotion is counted and reported,
never hidden. Only the floor's failure propagates. The ladder knows
nothing about *why* a level failed: fault injection reaches it only
through the engine's ``compile_hook`` and ``mark_unhealthy``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

LEVEL_SHARDED = "sharded"
LEVEL_RESIDENT = "resident"
LEVEL_LAYERED = "layered"


@dataclasses.dataclass(frozen=True)
class DegradeEvent:
    """One ladder transition (demotion or restore)."""

    step: int  # engine dispatch ordinal when the transition happened
    level: str  # the level whose health changed
    healthy: bool  # False = demoted, True = restored
    reason: str


class DegradationLadder:
    """Health-aware plan lookup over a :class:`~repro_torch.plan.PlanCache`.

    ``mesh``/``use_resident`` name the engine's preferred level; the
    ladder serves the highest healthy level at or below it. ``tuned`` (a
    :class:`repro_torch.tune.TunedConfig`) is applied at the
    single-device levels; ``build_sharded_plan`` takes no tuning knobs.
    """

    def __init__(self, cache, *, mesh=None, use_resident: bool = False, tuned=None):
        self.cache = cache
        self.mesh = mesh
        self.use_resident = bool(use_resident)
        self.tuned = tuned
        self._healthy = {LEVEL_SHARDED: True, LEVEL_RESIDENT: True}
        self.events: list[DegradeEvent] = []

    @property
    def preferred_level(self) -> str:
        if self.mesh is not None:
            return LEVEL_SHARDED
        return LEVEL_RESIDENT if self.use_resident else LEVEL_LAYERED

    def levels(self) -> list[str]:
        """Currently serviceable levels, most preferred first."""
        out = []
        if self.mesh is not None and self._healthy[LEVEL_SHARDED]:
            out.append(LEVEL_SHARDED)
        if self.use_resident and self._healthy[LEVEL_RESIDENT]:
            out.append(LEVEL_RESIDENT)
        out.append(LEVEL_LAYERED)
        return out

    def is_healthy(self, level: str) -> bool:
        return self._healthy.get(level, True)

    @property
    def degraded(self) -> bool:
        return self.levels()[0] != self.preferred_level

    def mark_unhealthy(self, level: str, *, reason: str, step: int = -1) -> None:
        """Demote a level (its plan failed to build or capture, or the mesh
        lost a shard). Idempotent."""
        if level not in self._healthy:
            raise ValueError(f"level {level!r} cannot be demoted (floor or unknown)")
        if self._healthy[level]:
            self._healthy[level] = False
            self.events.append(DegradeEvent(step, level, False, reason))

    def restore(self, level: str, *, reason: str = "restored", step: int = -1) -> None:
        """Re-admit a demoted level (an operator cleared the fault)."""
        if level not in self._healthy:
            raise ValueError(f"level {level!r} has no health state")
        if not self._healthy[level]:
            self._healthy[level] = True
            self.events.append(DegradeEvent(step, level, True, reason))

    def get_plan(
        self,
        weights,
        biases,
        width: int,
        *,
        differentiable: bool = False,
        fingerprint: str | None = None,
        step: int = -1,
        compile_hook: Callable[[str], None] | None = None,
    ):
        """(plan, level, cache_hit) at the best healthy level.

        ``compile_hook(level)`` runs before each level's cache lookup;
        raising from it (fault injection) demotes that level and falls
        through. Differentiable plans have no resident level to try."""
        for level in self.levels():
            if differentiable and level == LEVEL_RESIDENT:
                continue
            try:
                if compile_hook is not None:
                    compile_hook(level)
                before = self.cache.hits
                plan = self.cache.get(
                    weights,
                    biases,
                    width,
                    use_resident=level == LEVEL_RESIDENT,
                    fingerprint=fingerprint,
                    differentiable=differentiable,
                    tuned=self.tuned if level != LEVEL_SHARDED else None,
                    mesh=self.mesh if level == LEVEL_SHARDED else None,
                )
                return plan, level, self.cache.hits > before
            except Exception as e:  # noqa: BLE001 — any plan-build failure
                if level == LEVEL_LAYERED:
                    raise
                self.mark_unhealthy(level, reason=f"{type(e).__name__}: {e}", step=step)
        raise AssertionError("unreachable: the layered floor returns or raises")

    def describe(self) -> dict:
        return {
            "preferred": self.preferred_level,
            "current": self.levels()[0],
            "degraded": self.degraded,
            "health": dict(self._healthy),
            "events": [dataclasses.asdict(e) for e in self.events],
        }
