"""A replicated :class:`~repro_torch.serve.engine.SparseDNNEngine` fleet —
counterpart of ``repro/serve/fleet.py``.

One engine serves one panel at a time; GraphChallenge-scale offered load
(``repro_torch.serve.loadgen``) needs N of them. This module is the *routing*
half of the fleet serving layer: :class:`ReplicaFleet` owns N
data-parallel replicas — same frozen stack, but each with its **own**
:class:`repro_torch.plan.PlanCache` and :class:`repro_torch.plan.DegradationLadder`
(enforced at construction), so a compile storm or a health mark on one
replica never bleeds into another. The event loop that drives dispatch
against a clock lives above, in ``repro_torch.serve.frontend``.

Routing policy — width-class affinity, then load:

1. A job's *width class* is ``quantize_width(k, width_classes)`` — the
   padded panel width it will dispatch at, hence the
   :class:`repro_torch.plan.PlanKey` it will look up.
2. The first time a class is seen, the least-loaded replica (preferring
   replicas that own fewest classes) **claims** it and compiles its one
   plan. Every later job of that class prefers the owner
   (``"affinity"``) — a guaranteed plan-cache hit.
3. Affinity yields to load only when the owner is backed up by more
   than ``affinity_slack`` columns relative to the least-loaded replica
   (``"spill"``), and to liveness always: a dead owner's classes are
   re-claimed on next sight (``"claim"``), and its queued/in-flight
   jobs are re-routed (``"failover"``), never dropped.

Spreading classes across replicas costs one compile per class per
*owning* replica — the same total compile count as a single engine —
while spill/failover compiles are visible as ``cross_replica_compiles``
in :meth:`ReplicaFleet.stats`. With affinity on, a trace's fleet-wide
plan-cache hit rate matches single-engine levels; routing purely by
load would rebuild every class on every replica it lands on. On the
card a "compile" is a plan build and its CUDA graph capture.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Sequence

from repro_torch.plan import quantize_width
from repro_torch.serve.engine import SparseDNNEngine
from repro_torch.serve.loadgen import ArrivalJob

REASON_CLAIM = "claim"  # first sight of a class: claim + compile
REASON_AFFINITY = "affinity"  # owner alive and not overloaded
REASON_SPILL = "spill"  # owner too backed up; least-loaded wins
REASON_FAILOVER = "failover"  # owner/replica dead; re-routed


@dataclasses.dataclass(frozen=True)
class RoutingDecision:
    """One routing verdict — the fleet's audit log entry."""

    rid: int
    width_class: int
    replica: int
    reason: str


@dataclasses.dataclass
class Replica:
    """One engine plus the fleet's per-replica serving state."""

    index: int
    engine: SparseDNNEngine
    alive: bool = True
    queue: "deque[ArrivalJob]" = dataclasses.field(default_factory=deque)
    inflight: ArrivalJob | None = None
    # Counters accumulated from engine step stats by the frontend.
    dispatches: int = 0
    served_jobs: int = 0
    served_cols: int = 0
    plan_lookups: int = 0
    plan_hits: int = 0
    compiles: int = 0
    compiled_classes: set = dataclasses.field(default_factory=set)
    busy_s: float = 0.0

    @property
    def depth(self) -> int:
        """Backlog in feature columns (queued + in-flight) — the load
        signal the router balances on."""
        cols = sum(j.cols for j in self.queue)
        if self.inflight is not None:
            cols += self.inflight.cols
        return cols

    def observe_step(self, stats: dict) -> None:
        """Fold one engine ``step`` stats dict into the counters."""
        self.dispatches += 1
        plan = stats.get("plan")
        if plan is not None:
            self.plan_lookups += 1
            if plan["cache_hit"]:
                self.plan_hits += 1
            else:
                self.compiles += 1
                self.compiled_classes.add(plan["width_class"])
        if not stats.get("failed"):
            self.served_jobs += 1
            self.served_cols += stats["batch"]


class ReplicaFleet:
    """N isolated engine replicas behind a width-class-affinity router.

    ``engines`` must not share plan caches or ladders — replica
    isolation is the point (a compile or health event on one replica
    must not serialize the others), so sharing raises at construction.
    ``width_classes`` is the same quantization set every engine
    dispatches at (``step(pad_to=...)``); it defines the affinity key.
    """

    def __init__(
        self,
        engines: Sequence[SparseDNNEngine],
        *,
        width_classes: Sequence[int],
        affinity_slack: int | None = None,
    ):
        if not engines:
            raise ValueError("a fleet needs at least one engine replica")
        if not width_classes or min(width_classes) < 1:
            raise ValueError("width_classes must be positive ints")
        if affinity_slack is None:
            # Tolerate one largest-class panel of backlog imbalance
            # before spilling off the owner: a spill saves some queueing
            # but costs a fresh plan compile on the target, so small
            # imbalances should ride out on affinity.
            affinity_slack = max(width_classes)
        if affinity_slack < 0:
            raise ValueError(f"affinity_slack must be >= 0, got {affinity_slack}")
        caches = [e.plan_cache for e in engines]
        ladders = [e.ladder for e in engines]
        for name, objs in (("plan_cache", caches), ("ladder", ladders)):
            if len({id(o) for o in objs}) != len(objs):
                raise ValueError(
                    f"fleet replicas must not share a {name}: replica "
                    "isolation requires per-engine plan caches and "
                    "degradation ladders"
                )
        fps = {e._fingerprint for e in engines}
        if len(fps) != 1:
            raise ValueError(
                "fleet replicas serve different topologies "
                f"({len(fps)} distinct fingerprints); data-parallel "
                "replicas must share one stack"
            )
        self.fingerprint = next(iter(fps))
        self.width_classes = tuple(sorted(int(c) for c in width_classes))
        self.affinity_slack = int(affinity_slack)
        self.replicas = [Replica(i, e) for i, e in enumerate(engines)]
        self._owner: dict[int, int] = {}  # width class -> replica index
        self.decisions: list[RoutingDecision] = []
        self.events: list[dict] = []  # replica loss etc., for stats

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def width_class(self, k: int) -> int:
        return quantize_width(int(k), self.width_classes)

    def _alive(self) -> list[Replica]:
        alive = [r for r in self.replicas if r.alive]
        if not alive:
            raise RuntimeError("no live replicas in the fleet")
        return alive

    def _least_loaded(self, among: Sequence[Replica]) -> Replica:
        # Deterministic tie-break: lowest index.
        return min(among, key=lambda r: (r.depth, r.index))

    def route(self, job: ArrivalJob, *, reason: str | None = None) -> Replica:
        """Pick a replica for ``job``, enqueue it there, log why.

        ``reason`` overrides the logged reason (the frontend passes
        ``"failover"`` when re-routing off a dead replica).
        """
        alive = self._alive()
        cls = self.width_class(job.cols)
        owner_idx = self._owner.get(cls)
        owner = (
            self.replicas[owner_idx]
            if owner_idx is not None and self.replicas[owner_idx].alive
            else None
        )
        if owner is None:
            # Claim: spread ownership — among least-owning replicas,
            # take the least-loaded one.
            owned = {r.index: 0 for r in alive}
            for i in self._owner.values():
                if i in owned:
                    owned[i] += 1
            min_owned = min(owned.values())
            cands = [r for r in alive if owned[r.index] == min_owned]
            chosen = self._least_loaded(cands)
            self._owner[cls] = chosen.index
            why = REASON_CLAIM
        else:
            lightest = self._least_loaded(alive)
            if owner.depth - lightest.depth > self.affinity_slack:
                chosen, why = lightest, REASON_SPILL
            else:
                chosen, why = owner, REASON_AFFINITY
        self.decisions.append(
            RoutingDecision(job.rid, cls, chosen.index, reason or why)
        )
        chosen.queue.append(job)
        return chosen

    def fail_replica(self, index: int, *, at: float, reason: str) -> list[ArrivalJob]:
        """Kill replica ``index``; return its orphaned jobs (queued,
        FIFO order, plus any in-flight job LAST — the frontend re-routes
        every one of them, so a replica loss costs latency, never a
        dropped request). Its class ownerships lapse (re-claimed on next
        sight). Idempotent-safe: failing a dead replica returns []."""
        r = self.replicas[index]
        if not r.alive:
            return []
        r.alive = False
        orphans = list(r.queue)
        r.queue.clear()
        if r.inflight is not None:
            orphans.append(r.inflight)
            r.inflight = None
        self._owner = {c: i for c, i in self._owner.items() if i != index}
        self.events.append(
            {
                "event": "replica-loss",
                "replica": index,
                "at": float(at),
                "reason": reason,
                "requeued_jobs": len(orphans),
            }
        )
        return orphans

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    @property
    def owners(self) -> dict[int, int]:
        """width class -> owning replica index (live view, copied)."""
        return dict(self._owner)

    def cross_replica_compiles(self) -> int:
        """Compiles beyond one-per-class fleet-wide: how many times a
        class was compiled on a replica that was not its first compiler.
        0 under pure affinity; each spill/failover to a cold replica
        adds one."""
        per_class: dict[int, int] = {}
        for r in self.replicas:
            for cls in r.compiled_classes:
                per_class[cls] = per_class.get(cls, 0) + 1
        return sum(n - 1 for n in per_class.values() if n > 1)

    def plan_hit_rate(self) -> float:
        """Fleet-wide plan-cache hit rate over every dispatched panel."""
        lookups = sum(r.plan_lookups for r in self.replicas)
        hits = sum(r.plan_hits for r in self.replicas)
        return hits / lookups if lookups else 0.0

    def stats(self) -> dict:
        routing: dict[str, int] = {}
        for d in self.decisions:
            routing[d.reason] = routing.get(d.reason, 0) + 1
        return {
            "replicas": len(self.replicas),
            "alive": sum(r.alive for r in self.replicas),
            "width_classes": list(self.width_classes),
            "owners": {str(c): i for c, i in sorted(self._owner.items())},
            "routing": routing,
            "plan_lookups": sum(r.plan_lookups for r in self.replicas),
            "plan_hits": sum(r.plan_hits for r in self.replicas),
            "plan_hit_rate": self.plan_hit_rate(),
            "cross_replica_compiles": self.cross_replica_compiles(),
            "events": list(self.events),
            "per_replica": [
                {
                    "replica": r.index,
                    "alive": r.alive,
                    "dispatches": r.dispatches,
                    "served_jobs": r.served_jobs,
                    "served_cols": r.served_cols,
                    "compiles": r.compiles,
                    "compiled_classes": sorted(r.compiled_classes),
                    "plan_hits": r.plan_hits,
                    "busy_s": r.busy_s,
                }
                for r in self.replicas
            ],
        }


__all__ = [
    "Replica",
    "ReplicaFleet",
    "RoutingDecision",
    "REASON_CLAIM",
    "REASON_AFFINITY",
    "REASON_SPILL",
    "REASON_FAILOVER",
]
