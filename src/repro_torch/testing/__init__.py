"""Robustness harnesses that ship with the library (counterpart of
``repro.testing``): the deterministic fault injector the serving engine,
the continuous batcher, the fleet front end and resilient training poll
at named sites."""

from repro_torch.testing.faults import (  # noqa: F401
    ALL_SITES,
    SITE_CACHE_EVICTION,
    SITE_PANEL_NANS,
    SITE_PLAN_COMPILE,
    SITE_REPLICA_LOSS,
    SITE_REPLICA_SLOW,
    SITE_SHARD_FAILURE,
    SITE_STEP_TRANSIENT,
    SITE_STRAGGLER,
    SITE_TRAIN_NAN_LOSS,
    FaultEvent,
    FaultInjector,
    InjectedFault,
    TransientFault,
    poison_panel,
)

__all__ = [
    "ALL_SITES",
    "SITE_CACHE_EVICTION",
    "SITE_PANEL_NANS",
    "SITE_PLAN_COMPILE",
    "SITE_REPLICA_LOSS",
    "SITE_REPLICA_SLOW",
    "SITE_SHARD_FAILURE",
    "SITE_STEP_TRANSIENT",
    "SITE_STRAGGLER",
    "SITE_TRAIN_NAN_LOSS",
    "FaultEvent",
    "FaultInjector",
    "InjectedFault",
    "TransientFault",
    "poison_panel",
]
