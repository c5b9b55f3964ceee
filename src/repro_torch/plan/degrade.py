"""Graceful plan degradation: resident → layered.

Counterpart of ``repro/plan/degrade.py`` with its two single-device
levels (the ``sharded`` level arrives with the scale-out slice, ROADMAP
Queue 1 item 10; the health API the fault injector drives arrives with
item 9):

1. ``resident`` — the fused whole-stack plan (shared-memory panel or its
   tiled variant), when the engine resolved residency and no plan-build
   failure demoted it;
2. ``layered``  — the per-layer kernel plan, the floor: it needs nothing
   but one device and always exists.

``get_plan`` tries the resident level first; if its build raises, the
ladder records why and serves the floor from then on. Only the floor's
failure propagates. Failures while a plan RUNS (a kernel that does not
build or launch) are not caught here.
"""

from __future__ import annotations

LEVEL_RESIDENT = "resident"
LEVEL_LAYERED = "layered"


class DegradationLadder:
    """Plan lookup over a :class:`~repro_torch.plan.PlanCache` that demotes
    the resident level for good once its plan fails to build."""

    def __init__(self, cache, *, use_resident: bool = False):
        self.cache = cache
        self.use_resident = bool(use_resident)
        self.demotion: str | None = None  # why the resident build failed

    @property
    def preferred_level(self) -> str:
        return LEVEL_RESIDENT if self.use_resident else LEVEL_LAYERED

    def get_plan(self, weights, biases, width: int, *, fingerprint=None,
                 differentiable: bool = False):
        """(plan, level, cache_hit) at the best level that builds.
        ``differentiable`` plans have no resident level to try."""
        if self.use_resident and self.demotion is None and not differentiable:
            try:
                return self._get(weights, biases, width, fingerprint, LEVEL_RESIDENT, False)
            except Exception as e:  # noqa: BLE001 — any plan-build failure
                self.demotion = f"{type(e).__name__}: {e}"
        return self._get(weights, biases, width, fingerprint, LEVEL_LAYERED, differentiable)

    def _get(self, weights, biases, width, fingerprint, level, differentiable):
        before = self.cache.hits
        plan = self.cache.get(
            weights,
            biases,
            width,
            use_resident=level == LEVEL_RESIDENT,
            fingerprint=fingerprint,
            differentiable=differentiable,
        )
        return plan, level, self.cache.hits > before
