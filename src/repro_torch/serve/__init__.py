"""Serving the sparse DNN (counterpart of ``repro.serve``): the engine,
the continuous batcher above it, the challenge run and the clocks.
The reference's LLM ``Engine``, fleet, front end and load generator are
not ported yet (ROADMAP Queue 1 items 5 and 7)."""

from repro_torch.serve.challenge import ChallengeResult, run_challenge  # noqa: F401
from repro_torch.serve.clock import (  # noqa: F401
    WALL_CLOCK,
    Clock,
    VirtualClock,
    WallClock,
)
from repro_torch.serve.engine import SparseDNNEngine  # noqa: F401
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
    "ChallengeResult",
    "Clock",
    "ContinuousBatcher",
    "FaultCounters",
    "QueueFull",
    "Request",
    "RequestQueue",
    "ServeStats",
    "SparseDNNEngine",
    "StepRecord",
    "VirtualClock",
    "WallClock",
    "compare_static_continuous",
    "poissonish_trace",
    "run_challenge",
    "serve_trace_static",
]
