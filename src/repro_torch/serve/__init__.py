"""Serving (counterpart of ``repro.serve``): the LLM ``Engine``, the
sparse DNN's engine, the continuous batcher above it, the challenge run,
the clocks, and the replica fleet (load generator, router, front end)."""

from repro_torch.serve.challenge import ChallengeResult, run_challenge  # noqa: F401
from repro_torch.serve.clock import (  # noqa: F401
    WALL_CLOCK,
    Clock,
    VirtualClock,
    WallClock,
)
from repro_torch.serve.engine import Engine, SparseDNNEngine, cache_nbytes  # noqa: F401
from repro_torch.serve.fleet import (  # noqa: F401
    Replica,
    ReplicaFleet,
    RoutingDecision,
)
from repro_torch.serve.frontend import (  # noqa: F401
    CompletedJob,
    FleetFrontend,
    ServiceModel,
)
from repro_torch.serve.loadgen import (  # noqa: F401
    ArrivalJob,
    LoadProfile,
    generate_jobs,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    ContinuousBatcher,
    FaultCounters,
    QueueFull,
    Request,
    RequestQueue,
    ServeStats,
    StepRecord,
    compare_static_continuous,
    poissonish_trace,
    serve_trace_static,
)

__all__ = [
    "WALL_CLOCK",
    "ArrivalJob",
    "ChallengeResult",
    "Clock",
    "CompletedJob",
    "Engine",
    "ContinuousBatcher",
    "FaultCounters",
    "FleetFrontend",
    "LoadProfile",
    "QueueFull",
    "Replica",
    "ReplicaFleet",
    "Request",
    "RequestQueue",
    "RoutingDecision",
    "ServeStats",
    "ServiceModel",
    "SparseDNNEngine",
    "StepRecord",
    "VirtualClock",
    "WallClock",
    "cache_nbytes",
    "compare_static_continuous",
    "generate_jobs",
    "poissonish_trace",
    "run_challenge",
    "serve_trace_static",
]
