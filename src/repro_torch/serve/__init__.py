"""Serving the sparse DNN (counterpart of ``repro.serve``): the engine,
the continuous batcher above it, the challenge run, the clocks, and the
replica fleet (load generator, router, front end). The reference's LLM
``Engine`` is not ported yet (ROADMAP Queue 1 item 7)."""

from repro_torch.serve.challenge import ChallengeResult, run_challenge  # noqa: F401
from repro_torch.serve.clock import (  # noqa: F401
    WALL_CLOCK,
    Clock,
    VirtualClock,
    WallClock,
)
from repro_torch.serve.engine import SparseDNNEngine  # noqa: F401
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
    "compare_static_continuous",
    "generate_jobs",
    "poissonish_trace",
    "run_challenge",
    "serve_trace_static",
]
