"""Build-once execution plans (counterpart of ``repro.plan``).

A sparse stack's layout choices, route (fused / fused-tiled / layered),
exact launch bill and bound weights are analysed once per (topology
fingerprint, width class) into a :class:`StackPlan`, cached in a
:class:`PlanCache` and served through a :class:`DegradationLadder`.
"""

from repro_torch.plan.cache import PlanCache  # noqa: F401
from repro_torch.plan.cost import layer_grid_steps, stack_grid_steps  # noqa: F401
from repro_torch.plan.degrade import (  # noqa: F401
    LEVEL_LAYERED,
    LEVEL_RESIDENT,
    DegradationLadder,
)
from repro_torch.plan.layout import (  # noqa: F401
    ELL_WASTE_THRESHOLD,
    layer_layout,
    preferred_layout,
    to_preferred_layout,
)
from repro_torch.plan.routes import (  # noqa: F401
    ROUTE_FUSED,
    ROUTE_FUSED_TILED,
    ROUTE_LAYERED,
    fused_route,
    layer_path,
    resident_eligible,
)
from repro_torch.plan.stack_plan import (  # noqa: F401
    DEFAULT_WIDTH_CLASSES,
    LayerPlan,
    PlanKey,
    StackPlan,
    build_plan,
    quantize_width,
    topology_fingerprint,
)

__all__ = [
    "DEFAULT_WIDTH_CLASSES",
    "ELL_WASTE_THRESHOLD",
    "LEVEL_LAYERED",
    "LEVEL_RESIDENT",
    "ROUTE_FUSED",
    "ROUTE_FUSED_TILED",
    "ROUTE_LAYERED",
    "DegradationLadder",
    "LayerPlan",
    "PlanCache",
    "PlanKey",
    "StackPlan",
    "build_plan",
    "fused_route",
    "layer_grid_steps",
    "layer_layout",
    "layer_path",
    "preferred_layout",
    "quantize_width",
    "resident_eligible",
    "stack_grid_steps",
    "to_preferred_layout",
    "topology_fingerprint",
]
