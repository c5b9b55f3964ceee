"""Build-once execution plans (counterpart of ``repro.plan``).

A sparse stack's layout choices, route (fused / fused-tiled / layered),
exact launch bill and bound weights are analysed once per (topology
fingerprint, width class) into a :class:`StackPlan`, whose executable on
the card is a CUDA graph captured at its first forward; plans are cached
in a :class:`PlanCache` and served through a :class:`DegradationLadder`.
GraphBLAS products on one sparse operand get an :class:`MxmPlan` per
(topology, width, semiring) from :func:`mxm_plan`.
"""

from repro_torch.plan.cache import (  # noqa: F401
    PlanCache,
    default_cache,
    reset_default_cache,
)
from repro_torch.plan.cost import (  # noqa: F401
    layer_block_area,
    layer_grid_steps,
    mxv_grid_steps,
    stack_block_work,
    stack_grid_steps,
)
from repro_torch.plan.degrade import (  # noqa: F401
    LEVEL_LAYERED,
    LEVEL_RESIDENT,
    DegradationLadder,
    DegradeEvent,
)
from repro_torch.plan.layout import (  # noqa: F401
    ELL_WASTE_THRESHOLD,
    layer_layout,
    preferred_layout,
    to_preferred_layout,
)
from repro_torch.plan.mxm import (  # noqa: F401
    MxmPlan,
    mxm_cache_stats,
    mxm_plan,
    reset_mxm_cache,
)
from repro_torch.plan.routes import (  # noqa: F401
    ROUTE_FUSED,
    ROUTE_FUSED_TILED,
    ROUTE_LAYERED,
    ROUTE_XLA,
    fused_route,
    layer_path,
    resident_eligible,
)
from repro_torch.plan.stack_plan import (  # noqa: F401
    DEFAULT_WIDTH_CLASSES,
    LayerPlan,
    PlanCaptureError,
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
    "ROUTE_XLA",
    "DegradationLadder",
    "DegradeEvent",
    "LayerPlan",
    "MxmPlan",
    "PlanCache",
    "PlanCaptureError",
    "PlanKey",
    "StackPlan",
    "build_plan",
    "default_cache",
    "fused_route",
    "layer_block_area",
    "layer_grid_steps",
    "layer_layout",
    "layer_path",
    "mxm_cache_stats",
    "mxm_plan",
    "mxv_grid_steps",
    "preferred_layout",
    "quantize_width",
    "reset_default_cache",
    "reset_mxm_cache",
    "resident_eligible",
    "stack_block_work",
    "stack_grid_steps",
    "to_preferred_layout",
    "topology_fingerprint",
]
