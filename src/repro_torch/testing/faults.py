"""Deterministic fault injection for serving and training — counterpart of
``repro/testing/faults.py``.

Faults are **scheduled**, never sampled: a :class:`FaultInjector` holds a
map ``(site, when) → payload`` armed by a test or a run, and each
subsystem polls :meth:`FaultInjector.fires` at its named site with its
own monotonic counter:

=========================  ============================================
site                       ``when`` counter (owner)
=========================  ============================================
``SITE_PANEL_NANS``        engine dispatch ordinal (``SparseDNNEngine``)
``SITE_STEP_TRANSIENT``    engine dispatch ordinal
``SITE_PLAN_COMPILE``      engine dispatch ordinal
``SITE_CACHE_EVICTION``    engine dispatch ordinal
``SITE_STRAGGLER``         scheduler tick (``ContinuousBatcher``)
``SITE_SHARD_FAILURE``     engine dispatch ordinal (a mesh engine)
``SITE_TRAIN_NAN_LOSS``    train step (``run_resilient_training``)
``SITE_REPLICA_LOSS``      fleet dispatch ordinal (``FleetFrontend``)
``SITE_REPLICA_SLOW``      fleet dispatch ordinal
=========================  ============================================

A fired fault is consumed (popped) and logged in :attr:`FaultInjector.
fired`, so one ``schedule`` call produces exactly one fault — same
schedule + same trace → the same faulted run. Randomness (which panel
columns to poison) comes from the injector's own numpy generator, the
reference's, so one seed poisons the same columns in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

SITE_PANEL_NANS = "panel-nans"
SITE_STEP_TRANSIENT = "step-transient"
SITE_PLAN_COMPILE = "plan-compile"
SITE_CACHE_EVICTION = "cache-eviction"
SITE_SHARD_FAILURE = "shard-failure"
SITE_STRAGGLER = "straggler"
SITE_TRAIN_NAN_LOSS = "train-nan-loss"
SITE_REPLICA_LOSS = "replica-loss"
SITE_REPLICA_SLOW = "replica-slow"

ALL_SITES = (
    SITE_PANEL_NANS,
    SITE_STEP_TRANSIENT,
    SITE_PLAN_COMPILE,
    SITE_CACHE_EVICTION,
    SITE_SHARD_FAILURE,
    SITE_STRAGGLER,
    SITE_TRAIN_NAN_LOSS,
    SITE_REPLICA_LOSS,
    SITE_REPLICA_SLOW,
)


class InjectedFault(RuntimeError):
    """A scripted failure fired by the injector (not retryable)."""


class TransientFault(InjectedFault):
    """A scripted failure the engine is allowed to retry."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One consumed fault — the injector's audit log entry."""

    site: str
    when: int
    payload: dict


class FaultInjector:
    """Seeded, scheduled fault source shared across subsystems.

    ``schedule(site, when, **payload)`` arms one fault; the owning
    subsystem's ``fires(site, when)`` pops and returns the payload (or
    None). Faults armed at the same (site, when) pop in schedule order.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._scheduled: dict[tuple[str, int], list[dict]] = {}
        self.fired: list[FaultEvent] = []

    def schedule(self, site: str, when: int, **payload) -> None:
        if site not in ALL_SITES:
            raise ValueError(f"unknown fault site {site!r}; one of {ALL_SITES}")
        if when < 0:
            raise ValueError(f"when must be >= 0, got {when}")
        self._scheduled.setdefault((site, int(when)), []).append(dict(payload))

    def fires(self, site: str, when: int) -> dict | None:
        """Pop-and-log the next fault armed at (site, when), if any."""
        queue = self._scheduled.get((site, int(when)))
        if not queue:
            return None
        payload = queue.pop(0)
        if not queue:
            del self._scheduled[(site, int(when))]
        self.fired.append(FaultEvent(site, int(when), dict(payload)))
        return payload

    def pending(self, site: str | None = None) -> int:
        """Armed-but-unfired fault count (optionally one site's)."""
        return sum(len(q) for (s, _), q in self._scheduled.items() if site is None or s == site)

    def fired_at(self, site: str) -> list[FaultEvent]:
        return [e for e in self.fired if e.site == site]


def poison_panel(
    panel: torch.Tensor,
    *,
    columns=None,
    count: int = 1,
    mode: str = "nan",
    limit: int | None = None,
    rng=None,
):
    """Non-finite values in whole columns of an (m, k) panel.

    Returns ``(poisoned_panel, columns)``; the caller's panel is not
    written. Columns are poisoned whole because one request is one
    column, which the engine's per-request quarantine relies on.
    ``limit`` restricts the random choice to the first ``limit`` columns
    (the real requests, not the pad). ``mode``: ``"nan"`` or ``"inf"``.
    """
    if mode not in ("nan", "inf"):
        raise ValueError(f"mode must be 'nan' or 'inf', got {mode!r}")
    k = panel.shape[1]
    hi = k if limit is None else min(int(limit), k)
    if columns is None:
        if hi < 1:
            return panel, ()
        rng = np.random.default_rng(0) if rng is None else rng
        count = min(int(count), hi)
        columns = sorted(int(c) for c in rng.choice(hi, size=count, replace=False))
    else:
        columns = sorted(int(c) for c in columns)
        bad = [c for c in columns if not 0 <= c < hi]
        if bad:
            raise ValueError(f"columns {bad} out of range [0, {hi})")
    if not columns:
        return panel, ()
    panel = panel.clone()
    panel[:, columns] = float("nan") if mode == "nan" else float("inf")
    return panel, tuple(columns)
