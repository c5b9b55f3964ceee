"""Wall-clock serving front end for a replicated engine fleet —
counterpart of ``repro/serve/frontend.py``.

This is the layer that turns the tick-based serving stack into a
*timed* one: :class:`FleetFrontend` runs a discrete-event loop over an
injectable :class:`repro_torch.serve.clock.Clock` — real arrival timestamps
(``repro_torch.serve.loadgen`` traces), absolute deadlines, bounded-queue
backpressure — and drives a :class:`repro_torch.serve.fleet.ReplicaFleet`
through its width-class-affinity router.

Two times, one code path:

* **event time** comes from the clock. Under :class:`WallClock` the
  loop sleeps until each event really happens; under
  :class:`VirtualClock` the same loop advances simulated time instantly,
  so a minutes-long bursty trace with deadlines, replica loss and slow
  nodes runs in a fraction of its length and is bit-identical run to run.
* **service time** is a deterministic :class:`ServiceModel` over the
  engine's exact launch bill (``base + grid_steps × per_step``; the
  port bills block products in 16-column tiles, ``repro_torch.plan.cost``,
  and the card's own ``per_step`` is a replayed plan's time over its
  bill).
  Engine compute really runs at dispatch (outputs are real); the
  *latency* a dispatch is charged is the model's, so throughput-vs-p99
  curves are a pure function of (trace, fleet, model), byte for byte,
  while staying proportional to the kernel work the paper's nnz-scaling
  argument is about.

Backpressure: admitted-but-unfinished work is bounded by
``max_pending_cols``; an arrival that would exceed it is REJECTED at
admission (counted, never queued) — the open-loop generator does not
slow down, so overload shows up honestly as rejections + deadline
misses rather than as an unbounded queue.

Fault sites (``repro_torch.testing.faults``), keyed by fleet dispatch
ordinal: ``SITE_REPLICA_LOSS`` (payload ``replica=k``) kills replica k
right before the Nth dispatch — its queued AND in-flight jobs re-route
to the survivors (reason ``"failover"``), so the loss costs latency,
never a dropped request; ``SITE_REPLICA_SLOW`` (payload ``factor=x``)
multiplies the Nth dispatch's service time (a degraded node).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Sequence

from repro_torch.serve.clock import WALL_CLOCK, Clock
from repro_torch.serve.fleet import REASON_FAILOVER, Replica, ReplicaFleet
from repro_torch.serve.loadgen import ArrivalJob
from repro_torch.testing import faults as _faults


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Deterministic service time for one dispatched panel.

    ``base_s`` is the per-dispatch overhead (launch + pad + readback);
    ``per_grid_step_s`` prices each billed block product, so service time
    scales with the *actual* sparse work of the padded panel — wider
    classes and deeper stacks cost proportionally more, exactly the
    hardware-independent accounting the step stats already carry.
    """

    base_s: float = 1e-3
    per_grid_step_s: float = 1e-5

    def service_s(self, stats: dict) -> float:
        return self.base_s + self.per_grid_step_s * float(stats["grid_steps"])


@dataclasses.dataclass(frozen=True)
class CompletedJob:
    """One finished (or gracefully failed) job, with its timings."""

    rid: int
    replica: int
    width_class: int
    cols: int
    arrival: float
    completed: float
    latency: float
    deadline: float | None
    deadline_miss: bool
    failed: bool
    quarantined_cols: int


@dataclasses.dataclass(frozen=True)
class _InFlight:
    job: ArrivalJob
    replica: int
    out: Any
    stats: dict
    dispatched: float
    service: float


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not sorted_vals:
        return 0.0
    rank = max(1, math.ceil(q * len(sorted_vals)))
    return float(sorted_vals[min(rank, len(sorted_vals)) - 1])


class FleetFrontend:
    """Discrete-event front-end: arrivals → admission → router → fleet.

    One frontend instance runs one trace (``run``); construct fresh for
    the next. ``results`` maps job rid → output panel (m, k) for every
    completed job — reference tests compare these against a
    single-engine pass over the same features.
    """

    def __init__(
        self,
        fleet: ReplicaFleet,
        *,
        clock: Clock | None = None,
        service_model: ServiceModel | None = None,
        max_pending_cols: int | None = None,
        fault_injector: Any = None,
    ):
        if max_pending_cols is not None and max_pending_cols < 1:
            raise ValueError(
                f"max_pending_cols must be >= 1, got {max_pending_cols}"
            )
        self.fleet = fleet
        self.clock = clock if clock is not None else WALL_CLOCK
        self.service_model = (
            service_model if service_model is not None else ServiceModel()
        )
        self.max_pending_cols = max_pending_cols
        self.fault_injector = fault_injector
        self.completed: list[CompletedJob] = []
        self.rejected: list[int] = []  # rids bounced at admission
        self.requeues: dict[int, int] = {}  # rid -> failover count
        self.results: dict[int, Any] = {}
        self._events: list[tuple] = []  # (t, seq, kind, payload) heap
        self._seq = 0
        self._pending_cols = 0
        self._dispatches = 0  # fleet dispatch ordinal (fault-site key)
        self._next_token = 0
        self._inflight: dict[int, _InFlight] = {}
        self._replica_token: dict[int, int] = {}
        self._ran = False
        # Trace timestamps are relative to trace time 0; the clock's
        # epoch is arbitrary (time.monotonic). ``run`` anchors trace
        # time 0 to the clock reading at loop start, so the same trace
        # replays identically under WallClock and VirtualClock(start=0).
        self._base = 0.0

    # ------------------------------------------------------------------
    # event loop
    # ------------------------------------------------------------------

    def _push(self, t: float, kind: str, payload: Any) -> None:
        heapq.heappush(self._events, (float(t), self._seq, kind, payload))
        self._seq += 1

    def run(self, jobs: Sequence[ArrivalJob]) -> dict:
        """Serve one open-loop trace to completion; return the stats."""
        if self._ran:
            raise RuntimeError(
                "a FleetFrontend runs one trace; construct a fresh one"
            )
        self._ran = True
        jobs = sorted(jobs, key=lambda j: (j.t, j.rid))
        if not jobs:
            return self.stats()
        self._base = self.clock.now()
        for job in jobs:
            self._push(self._base + job.t, "arrive", job)
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            dt = t - self.clock.now()
            if dt > 0:
                self.clock.sleep(dt)
            if kind == "arrive":
                self._on_arrival(payload)
            else:
                self._on_complete(payload)
            self._pump_all()
        return self.stats(span=max(self.clock.now() - self._base, 1e-9))

    def _on_arrival(self, job: ArrivalJob) -> None:
        if (
            self.max_pending_cols is not None
            and self._pending_cols + job.cols > self.max_pending_cols
        ):
            self.rejected.append(job.rid)
            return
        self._pending_cols += job.cols
        self.fleet.route(job)

    def _on_complete(self, token: int) -> None:
        rec = self._inflight.pop(token, None)
        if rec is None:
            return  # cancelled: the replica died mid-flight, job re-routed
        replica = self.fleet.replicas[rec.replica]
        replica.inflight = None
        self._replica_token.pop(rec.replica, None)
        replica.busy_s += rec.service
        self._finish(rec.job, replica, out=rec.out, stats=rec.stats)

    def _pump_all(self) -> None:
        """Dispatch until no live replica has a free slot and a queue.
        A dispatch can kill a replica and re-route its jobs, so iterate
        to a fixpoint (replica order is deterministic)."""
        progress = True
        while progress:
            progress = False
            for replica in self.fleet.replicas:
                if replica.alive and replica.inflight is None and replica.queue:
                    self._dispatch(replica)
                    progress = True

    def _dispatch(self, replica: Replica) -> None:
        inj = self.fault_injector
        ordinal = self._dispatches
        if inj is not None:
            spec = inj.fires(_faults.SITE_REPLICA_LOSS, ordinal)
            if spec is not None:
                # Fires BEFORE dispatch N; the dispatch itself retries
                # on whoever survives (same ordinal).
                self._handle_loss(int(spec["replica"]), spec)
                return
        job = replica.queue.popleft()
        self._dispatches += 1
        factor = 1.0
        if inj is not None:
            slow = inj.fires(_faults.SITE_REPLICA_SLOW, ordinal)
            if slow is not None:
                factor = float(slow.get("factor", 2.0))
                if factor < 1.0:
                    raise ValueError(
                        f"replica-slow factor must be >= 1, got {factor}"
                    )
        cls = self.fleet.width_class(job.cols)
        replica.engine.submit(job.features)
        out, stats = replica.engine.step(pad_to=cls)
        replica.observe_step(stats)
        if stats.get("failed"):
            # Graceful engine failure: the job is finished-as-failed at
            # dispatch time; the replica slot frees immediately.
            self._finish(job, replica, out=None, stats=stats)
            return
        now = self.clock.now()
        service = self.service_model.service_s(stats) * factor
        token = self._next_token
        self._next_token += 1
        self._inflight[token] = _InFlight(job, replica.index, out, stats, now, service)
        replica.inflight = job
        self._replica_token[replica.index] = token
        self._push(now + service, "complete", token)

    def _handle_loss(self, index: int, spec: dict) -> None:
        token = self._replica_token.pop(index, None)
        if token is not None:
            # Invalidate the in-flight completion; fail_replica hands
            # the job back below and it re-routes like the queued ones.
            self._inflight.pop(token, None)
        orphans = self.fleet.fail_replica(
            index,
            at=self.clock.now() - self._base,
            reason=spec.get("reason", "injected replica loss"),
        )
        for job in orphans:
            self.fleet.route(job, reason=REASON_FAILOVER)
            self.requeues[job.rid] = self.requeues.get(job.rid, 0) + 1

    def _finish(
        self, job: ArrivalJob, replica: Replica, *, out: Any, stats: dict
    ) -> None:
        # Times in the record are trace-relative (subtract the base) so
        # reports read the same under WallClock and VirtualClock.
        now = self.clock.now() - self._base
        failed = bool(stats.get("failed"))
        miss = job.deadline is not None and now > job.deadline
        self._pending_cols -= job.cols
        if not failed:
            self.results[job.rid] = out
        self.completed.append(
            CompletedJob(
                rid=job.rid,
                replica=replica.index,
                width_class=self.fleet.width_class(job.cols),
                cols=job.cols,
                arrival=job.t,
                completed=now,
                latency=now - job.t,
                deadline=job.deadline,
                deadline_miss=miss or failed,
                failed=failed,
                quarantined_cols=len(stats.get("quarantined_request_ids") or ()),
            )
        )

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------

    def stats(self, span: float | None = None) -> dict:
        """Trace-level serving report: latency percentiles, goodput per
        replica, routing + fault accounting. ``span`` is the wall (or
        virtual) seconds from first arrival to loop drain; rates are 0
        when it is unknown (empty trace)."""
        served = [c for c in self.completed if not c.failed]
        lat = sorted(c.latency for c in served)
        on_time = [c for c in served if not c.deadline_miss]
        offered = len(self.completed) + len(self.rejected)
        misses = sum(c.deadline_miss for c in self.completed)
        per_replica_cols: dict[int, int] = {}
        for c in on_time:
            per_replica_cols[c.replica] = (
                per_replica_cols.get(c.replica, 0) + c.cols
            )
        fleet = self.fleet.stats()
        for entry in fleet["per_replica"]:
            cols = per_replica_cols.get(entry["replica"], 0)
            entry["on_time_cols"] = cols
            entry["goodput_cols_per_s"] = cols / span if span else 0.0
        return {
            "offered_jobs": offered,
            "admitted_jobs": len(self.completed),
            "rejected_jobs": len(self.rejected),
            "served_jobs": len(served),
            "failed_jobs": len(self.completed) - len(served),
            "served_cols": sum(c.cols for c in served),
            "quarantined_cols": sum(c.quarantined_cols for c in served),
            "deadline_misses": int(misses),
            # Misses, failures and rejections all break the SLO; the
            # open-loop denominator is everything that arrived.
            "miss_rate": (
                (misses + len(self.rejected)) / offered if offered else 0.0
            ),
            "requeued_jobs": len(self.requeues),
            "latency_p50_s": _percentile(lat, 0.50),
            "latency_p99_s": _percentile(lat, 0.99),
            "latency_max_s": lat[-1] if lat else 0.0,
            "span_s": span if span is not None else 0.0,
            "throughput_cols_per_s": (
                sum(c.cols for c in served) / span if span else 0.0
            ),
            "goodput_cols_per_s": (
                sum(c.cols for c in on_time) / span if span else 0.0
            ),
            "fleet": fleet,
        }


__all__ = ["CompletedJob", "FleetFrontend", "ServiceModel"]
