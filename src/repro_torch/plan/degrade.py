"""Graceful plan degradation: resident → layered.

Counterpart of ``repro/plan/degrade.py`` with its two single-device
levels (the ``sharded`` level arrives with the scale-out slice, ROADMAP
Queue 1 item 5):

1. ``resident`` — the fused whole-stack plan (shared-memory panel or its
   tiled variant), when the engine resolved residency and the level is
   healthy;
2. ``layered``  — the per-layer kernel plan, the floor: it needs nothing
   but one device and always exists.

``get_plan`` walks the levels top-down and returns the first that builds.
A level whose build fails — a plan-build error, an injected fault — is
marked unhealthy and the walk continues, so the panel that hit the
failure is still served. A CUDA graph capture that fails is a compile
failure too: the engine marks the level unhealthy the same way
(:meth:`DegradationLadder.mark_unhealthy`). Health marks are sticky
until :meth:`DegradationLadder.restore`, and every transition is recorded
in :attr:`DegradationLadder.events`. Only the floor's failure
propagates. The ladder knows nothing about *why* a level failed: fault
injection reaches it only through the engine's ``compile_hook``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

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

    ``use_resident`` names the engine's preferred level; the ladder serves
    the highest healthy level at or below it. ``tuned`` (a
    :class:`repro_torch.tune.TunedConfig`) is applied at both levels.
    """

    def __init__(self, cache, *, use_resident: bool = False, tuned=None):
        self.cache = cache
        self.use_resident = bool(use_resident)
        self.tuned = tuned
        self._healthy = {LEVEL_RESIDENT: True}
        self.events: list[DegradeEvent] = []

    @property
    def preferred_level(self) -> str:
        return LEVEL_RESIDENT if self.use_resident else LEVEL_LAYERED

    def levels(self) -> list[str]:
        """Currently serviceable levels, most preferred first."""
        out = []
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
        """Demote a level (its plan failed to build or capture). Idempotent."""
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
            if differentiable and level != LEVEL_LAYERED:
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
                    tuned=self.tuned,
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
