"""Continuous batching above :class:`repro_torch.serve.SparseDNNEngine` —
counterpart of ``repro/serve/scheduler.py``.

The paper's economics — inference cost ∝ stored nonzeros — survive real
traffic only if the batching layer keeps kernel panels full. This module
serves request *streams*:

* :class:`RequestQueue` — admission, priorities, deadlines, and an aging
  rule that makes starvation impossible;
* :class:`ContinuousBatcher` — each scheduling tick packs pending
  requests into ONE tile-aligned panel (late arrivals join mid-stream up
  to ``batch_size``; completed requests leave their slots at the step
  boundary), dispatches it through the engine's step API, and books
  per-request latency plus the exact launch bill;
* :class:`ServeStats` — pad-slot fraction, grid steps per served row,
  latency distribution, deadline misses, per-width-class plan compiles,
  fault counters and goodput;
* :func:`poissonish_trace` / :func:`serve_trace_static` — a
  deterministic bursty arrival trace (the reference's numpy generator,
  so one seed gives the same trace in both packages) and the static
  aligned-batching baseline.

Scheduling model: discrete ticks; every engine step serves a full
L-layer forward for its panel. With ``width_classes`` a handful of plan
widths serve every panel, and on the card each class's plan is captured
once as a CUDA graph and replayed for every later panel of that class.
Panels are ``torch.stack``-ed from the requests' feature columns and
handed to the engine, which moves them to its device (columns already on
the device are stacked there). Everything is deterministic: same trace +
same knobs → the same packings, the same bill, the same ServeStats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.plan.stack_plan import quantize_width
from repro_torch.serve.clock import WALL_CLOCK
from repro_torch.serve.engine import SparseDNNEngine
from repro_torch.testing import faults as _faults

Array = torch.Tensor


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: admission rejected, caller should
    shed load upstream (or retry later)."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of work: a feature column through the full sparse stack.

    ``priority``: smaller = more urgent (0 is the default class).
    ``deadline``: absolute tick by which the request should complete, or
    None. Deadlines order dispatch *within* a priority class and are
    reported as misses in :class:`ServeStats`; they are not drop-causes.
    """

    rid: int
    features: Array  # (m,) feature column
    arrival: int  # tick the request was admitted
    priority: int = 0
    deadline: int | None = None


class RequestQueue:
    """Pending-request pool with priority + deadline + aging order.

    Dispatch order is by ``(effective_priority, deadline, arrival, rid)``
    where ``effective_priority = priority - waited // age_every``. The
    aging term is the starvation guarantee: every ``age_every`` ticks a
    waiting request climbs one priority class, so any request overtakes
    any finite-priority stream after a bounded wait — there is no
    arrival pattern under which a request waits forever.

    ``max_pending`` bounds the pool: admission past the bound raises
    :class:`QueueFull` (backpressure — an unbounded queue converts
    overload into unbounded latency AND unbounded memory; a bounded one
    converts it into explicit, countable rejections). ``None`` keeps
    the legacy unbounded behaviour.
    """

    def __init__(self, age_every: int = 8, max_pending: int | None = None):
        if age_every < 1:
            raise ValueError("age_every must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (or None)")
        self.age_every = age_every
        self.max_pending = max_pending
        self._pending: list[Request] = []
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> tuple[Request, ...]:
        return tuple(self._pending)

    def submit(
        self,
        features: Array,
        *,
        now: int,
        priority: int = 0,
        deadline: int | None = None,
    ) -> int:
        """Admit one request; returns its id. Raises :class:`QueueFull`
        when a ``max_pending`` bound is set and reached."""
        if features.ndim != 1:
            raise ValueError(
                f"features must be one (m,) column, got {features.shape}"
            )
        if (
            self.max_pending is not None
            and len(self._pending) >= self.max_pending
        ):
            raise QueueFull(
                f"request queue at max_pending={self.max_pending}; "
                "shed load upstream"
            )
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(
            Request(rid, features, now, priority, deadline)
        )
        return rid

    def effective_priority(self, req: Request, now: int) -> int:
        return req.priority - (now - req.arrival) // self.age_every

    def oldest_wait(self, now: int) -> int:
        if not self._pending:
            return 0
        return now - min(r.arrival for r in self._pending)

    def pop_batch(self, k: int, now: int) -> list[Request]:
        """Remove and return the ≤ k most urgent pending requests."""
        if k <= 0 or not self._pending:
            return []
        take = self._dispatch_order(now)[:k]
        taken = {r.rid for r in take}
        self._pending = [r for r in self._pending if r.rid not in taken]
        return take

    def _dispatch_order(self, now: int) -> list[Request]:
        inf = float("inf")
        return sorted(
            self._pending,
            key=lambda r: (
                self.effective_priority(r, now),
                r.deadline if r.deadline is not None else inf,
                r.arrival,
                r.rid,
            ),
        )

    def shed_hopeless(
        self, now: int, batch_size: int
    ) -> tuple[list[Request], list[Request]]:
        """Drop deadlined requests that cannot complete in time; returns
        ``(expired, inadmissible)``.

        A panel dispatched at tick t completes at t+1, so a request at
        dispatch position ``p`` (in the queue's own order) finishes no
        earlier than ``now + 1 + p // batch_size``. ``expired`` requests
        are already past deadline at packing time (``deadline < now``);
        ``inadmissible`` ones are not yet expired but their earliest
        completion overshoots. Both classes would burn kernel grid steps
        to produce an answer nobody is waiting for — shedding them at
        packing time is what keeps *goodput* (useful completions per
        offered request) from collapsing under overload. Positions are
        recomputed as hopeless requests are removed, so a request is
        only shed if it cannot make it even AFTER the queue ahead of it
        is thinned.
        """
        if not self._pending:
            return [], []
        expired: list[Request] = []
        inadmissible: list[Request] = []
        keep: list[Request] = []
        pos = 0
        for r in self._dispatch_order(now):
            if r.deadline is None:
                keep.append(r)
                pos += 1
                continue
            earliest_done = now + 1 + pos // batch_size
            if earliest_done > r.deadline:
                (expired if r.deadline < now else inadmissible).append(r)
            else:
                keep.append(r)
                pos += 1
        if expired or inadmissible:
            kept = {r.rid for r in keep}
            self._pending = [r for r in self._pending if r.rid in kept]
        return expired, inadmissible


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """One engine dispatch as the scheduler saw it."""

    tick: int
    request_ids: tuple[int, ...]
    occupancy: int  # real request columns in the panel
    padded_width: int  # panel width after tile alignment
    grid_steps: int  # exact kernel grid steps billed for the panel
    kernel_launches: int  # launches of the panel's forward (the reference's pallas_calls)
    resident: bool
    width_class: int | None = None  # plan width the panel compiled at
    plan_cache_hit: bool | None = None  # compiled-plan reuse vs build
    retries: int = 0  # transient-failure retries before success
    quarantined: int = 0  # non-finite output columns failed per-request
    plan_level: str | None = None  # degradation level the panel ran at
    degraded: bool = False  # level below the engine's preferred one


@dataclasses.dataclass
class FaultCounters:
    """Serving fault accounting.

    ``offered`` counts every admission attempt, accepted or not — it is
    the goodput denominator. The loss buckets are disjoint: a request
    ends up in exactly one of rejected / shed / quarantined / failed /
    completed (late or on time).
    """

    offered: int = 0  # submit() attempts (accepted + rejected)
    rejected: int = 0  # bounded-queue backpressure rejections
    shed_expired: int = 0  # already past deadline at packing time
    shed_inadmissible: int = 0  # could not finish before deadline
    quarantined: int = 0  # non-finite output, failed individually
    failed: int = 0  # lost to exhausted step retries
    retried_steps: int = 0  # transient-failure retries (step-level)
    failed_steps: int = 0  # panels lost after retry exhaustion
    straggler_ticks: int = 0  # injected/observed slow ticks
    completed_late: int = 0  # served, but past deadline

    @property
    def shed(self) -> int:
        return self.shed_expired + self.shed_inadmissible

    def goodput(self, completed: int) -> float:
        """Useful completions / offered requests. Late completions are
        not useful; a fault-free run scores 1.0 by construction."""
        offered = self.offered if self.offered else completed
        if offered <= 0:
            return 1.0
        return (completed - self.completed_late) / offered

    def as_dict(self) -> dict:
        return {
            "offered": self.offered,
            "rejected": self.rejected,
            "shed_expired": self.shed_expired,
            "shed_inadmissible": self.shed_inadmissible,
            "shed": self.shed,
            "quarantined": self.quarantined,
            "failed": self.failed,
            "retried_steps": self.retried_steps,
            "failed_steps": self.failed_steps,
            "straggler_ticks": self.straggler_ticks,
            "completed_late": self.completed_late,
        }


@dataclasses.dataclass
class ServeStats:
    """Aggregate serving report (the reference's fields).

    ``pad_slot_fraction`` = 1 − rows/padded-slots: the fraction of every
    kernel panel that was alignment padding (idle grid work).
    ``grid_steps_per_row`` is the kernel-step cost of one served request
    — the nnz-proportional rate metric, GraphChallenge-style.
    """

    requests: int
    engine_steps: int
    idle_ticks: int
    rows_served: int
    padded_slots: int
    pad_slot_fraction: float
    grid_steps_total: int
    grid_steps_per_row: float
    latency_mean: float
    latency_p50: float
    latency_max: int
    deadline_misses: int
    latencies: dict[int, int]  # rid → ticks from arrival to completion
    steps: list[StepRecord]
    # Plan accounting (repro_torch.plan): how many engine steps built a
    # plan (on the card: captured its CUDA graph), per width class — with width-class
    # quantization a handful of classes should absorb every panel.
    plan_recompiles_by_class: dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    plan_cache_hit_rate: float = 0.0
    # Fault accounting: loss buckets + goodput =
    # on-time completions / offered requests. Fault-free legacy callers
    # get empty counters and goodput 1.0.
    faults: FaultCounters = dataclasses.field(default_factory=FaultCounters)
    goodput: float = 1.0

    @classmethod
    def from_steps(
        cls,
        steps: Sequence[StepRecord],
        latencies: dict[int, int],
        deadline_misses: int,
        idle_ticks: int,
        faults: FaultCounters | None = None,
    ) -> "ServeStats":
        faults = faults if faults is not None else FaultCounters()
        rows = sum(s.occupancy for s in steps)
        padded = sum(s.padded_width for s in steps)
        lat = sorted(latencies.values())
        recompiles: dict[int, int] = {}
        plan_lookups = plan_hits = 0
        for s in steps:
            if s.plan_cache_hit is None:
                continue
            plan_lookups += 1
            if s.plan_cache_hit:
                plan_hits += 1
            else:
                cls_w = (
                    s.width_class if s.width_class is not None
                    else s.padded_width
                )
                recompiles[cls_w] = recompiles.get(cls_w, 0) + 1
        return cls(
            requests=len(latencies),
            engine_steps=len(steps),
            idle_ticks=idle_ticks,
            rows_served=rows,
            padded_slots=padded,
            pad_slot_fraction=1.0 - rows / padded if padded else 0.0,
            grid_steps_total=sum(s.grid_steps for s in steps),
            grid_steps_per_row=(
                sum(s.grid_steps for s in steps) / rows if rows else 0.0
            ),
            latency_mean=float(np.mean(lat)) if lat else 0.0,
            latency_p50=float(np.median(lat)) if lat else 0.0,
            latency_max=max(lat) if lat else 0,
            deadline_misses=deadline_misses,
            latencies=dict(latencies),
            steps=list(steps),
            plan_recompiles_by_class=recompiles,
            plan_cache_hit_rate=(
                plan_hits / plan_lookups if plan_lookups else 0.0
            ),
            faults=faults,
            goodput=faults.goodput(len(latencies)),
        )

    def summary(self) -> dict:
        """JSON-ready scalars (drops the per-request / per-step detail)."""
        return {
            "requests": self.requests,
            "engine_steps": self.engine_steps,
            "idle_ticks": self.idle_ticks,
            "rows_served": self.rows_served,
            "padded_slots": self.padded_slots,
            "pad_slot_fraction": self.pad_slot_fraction,
            "grid_steps_total": self.grid_steps_total,
            "grid_steps_per_row": self.grid_steps_per_row,
            "latency_mean": self.latency_mean,
            "latency_p50": self.latency_p50,
            "latency_max": self.latency_max,
            "deadline_misses": self.deadline_misses,
            "plan_recompiles_by_class": {
                str(k): v
                for k, v in sorted(self.plan_recompiles_by_class.items())
            },
            "plan_cache_hit_rate": self.plan_cache_hit_rate,
            "goodput": self.goodput,
            "faults": self.faults.as_dict(),
        }


class ContinuousBatcher:
    """Packs the request stream into tile-aligned engine panels.

    Knobs:

    * ``batch_size`` — slot capacity of one panel (requests beyond it
      wait; arrivals join mid-stream as slots free up each step);
    * ``min_fill`` / ``max_wait`` — dispatch holds off while the panel
      would be emptier than ``min_fill · batch_size`` AND no pending
      request has waited ``max_wait`` ticks yet. ``min_fill=0`` serves
      every tick (latency-optimal); raising it trades bounded latency
      (≤ ``max_wait`` + 1 ticks) for fuller, less-padded panels.
    * ``width_classes`` — quantize each panel's width UP to the smallest
      listed class before dispatch (``repro_torch.plan.quantize_width``). A
      few classes absorb every occupancy the trace produces, so the
      engine's :class:`repro_torch.plan.PlanCache` builds (and on the
      card captures) a handful of plans once and replays them — instead
      of one per panel width. The extra pad slots are billed honestly
      (``pad_slot_fraction`` sees them); ``None`` disables quantization
      (pad to the kernel tile only). Per-class recompile counts land in
      :class:`ServeStats`.

    * ``max_pending`` — bounds the request queue; admission past it is
      REJECTED (``submit`` returns None, counted in the fault stats) —
      backpressure instead of unbounded latency. ``None`` = unbounded.
    * ``enforce_deadlines`` — shed deadlined requests that cannot
      complete in time at packing time (``RequestQueue.shed_hopeless``)
      instead of serving them late: shed requests count as deadline
      misses, never as completions. ``False`` restores the record-only
      legacy behaviour.
    * ``fault_injector`` — a ``repro_torch.testing.faults.FaultInjector``
      polled at the tick-keyed sites (straggler); pass the same
      injector to the engine for the dispatch-keyed sites.

    The batcher owns the clock: one ``step()`` = one tick. Completed
    requests' outputs are available via :meth:`result`; requests lost
    to quarantine / shedding / rejection / step failure are in
    :attr:`failures` with a reason string. :meth:`stats` rolls all of
    it into :class:`ServeStats` (fault counters + goodput).
    """

    def __init__(
        self,
        engine: SparseDNNEngine,
        *,
        batch_size: int = 64,
        min_fill: float = 0.0,
        max_wait: int = 4,
        age_every: int = 8,
        width_classes: Sequence[int] | None = None,
        max_pending: int | None = None,
        enforce_deadlines: bool = True,
        fault_injector=None,
        clock=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if not 0.0 <= min_fill <= 1.0:
            raise ValueError("min_fill must be in [0, 1]")
        if engine.staged:
            raise ValueError("engine already has staged columns")
        if width_classes is not None:
            width_classes = tuple(sorted(int(c) for c in width_classes))
            if not width_classes or min(width_classes) < 1:
                raise ValueError("width_classes must be positive ints")
            if max(width_classes) < batch_size:
                raise ValueError(
                    f"largest width class {max(width_classes)} is below "
                    f"batch_size {batch_size}; full panels would spill "
                    "past every class"
                )
        self.engine = engine
        self.batch_size = batch_size
        self.min_fill = min_fill
        self.max_wait = max_wait
        self.width_classes = width_classes
        self.enforce_deadlines = enforce_deadlines
        self.fault_injector = fault_injector
        # Straggler stalls (and any future wall-clock wait) go through
        # the injectable clock (repro_torch.serve.clock) so tests can run
        # faulted traces without real sleeps.
        self.clock = clock if clock is not None else WALL_CLOCK
        self.queue = RequestQueue(age_every=age_every, max_pending=max_pending)
        self._tick = 0
        self._idle_ticks = 0
        self._results: dict[int, Array] = {}
        self._latencies: dict[int, int] = {}
        self._deadline_misses = 0
        self._steps: list[StepRecord] = []
        self._faults = FaultCounters()
        self._failures: dict[int, str] = {}  # rid → failure reason

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def completed(self) -> int:
        return len(self._latencies)

    @property
    def failures(self) -> dict[int, str]:
        """rid → reason, for every admitted request lost to a fault path
        (shed / quarantined / failed step). Rejected submissions never
        got an rid; they are only counted in ``stats().faults``."""
        return dict(self._failures)

    def submit(
        self,
        features: Array,
        *,
        priority: int = 0,
        deadline: int | None = None,
    ) -> int | None:
        """Admit one request at the current tick; returns its id — or
        ``None`` when the bounded queue rejects it (backpressure; the
        rejection is counted in the fault stats)."""
        self._faults.offered += 1
        try:
            return self.queue.submit(
                features, now=self._tick, priority=priority,
                deadline=deadline,
            )
        except QueueFull:
            self._faults.rejected += 1
            return None

    def result(self, rid: int) -> Array:
        """The (m,) output column of a completed request."""
        return self._results[rid]

    def _should_dispatch(self) -> bool:
        pending = len(self.queue)
        if pending == 0:
            return False
        if pending >= self.batch_size:
            return True
        if pending >= self.min_fill * self.batch_size:
            return True
        return self.queue.oldest_wait(self._tick) >= self.max_wait

    def step(self, *, force: bool = False) -> StepRecord | None:
        """Advance one tick; dispatch one panel if the policy says so.

        Packing invariants (``tests/test_torch_scheduler.py``):
        occupancy ≤ ``batch_size``; the panel is padded only to the
        engine's tile (``batch_align``); every slot is tagged with its
        request id; completed requests leave at the step boundary, so a
        request arriving between steps joins the next panel whenever a
        slot is free — never behind a fixed-width batch quota.

        Fault paths: deadlined requests that cannot
        complete in time are shed BEFORE packing; a panel whose retries
        are exhausted fails its member requests individually instead of
        raising; non-finite output columns are quarantined per-request.
        The stream keeps ticking through all three.
        """
        inj = self.fault_injector
        if inj is not None:
            spec = inj.fires(_faults.SITE_STRAGGLER, self._tick)
            if spec is not None:
                self._faults.straggler_ticks += 1
                self.clock.sleep(float(spec.get("seconds", 0.0)))
        if self.enforce_deadlines:
            expired, inadmissible = self.queue.shed_hopeless(
                self._tick, self.batch_size
            )
            self._faults.shed_expired += len(expired)
            self._faults.shed_inadmissible += len(inadmissible)
            for req in expired:
                self._deadline_misses += 1
                self._failures[req.rid] = (
                    f"shed: already past deadline {req.deadline} "
                    f"at tick {self._tick}"
                )
            for req in inadmissible:
                self._deadline_misses += 1
                self._failures[req.rid] = (
                    f"shed: cannot complete by deadline {req.deadline} "
                    f"from tick {self._tick}"
                )
        record = None
        if self._should_dispatch() or (force and len(self.queue)):
            batch = self.queue.pop_batch(self.batch_size, self._tick)
            cols = torch.stack([r.features for r in batch], dim=1)
            self.engine.submit(cols, request_ids=[r.rid for r in batch])
            pad_to = None
            if self.width_classes is not None:
                pad_to = quantize_width(len(batch), self.width_classes)
            out, estats = self.engine.step(pad_to=pad_to)
            self._faults.retried_steps += int(estats.get("retries", 0))
            if out is None or estats.get("failed"):
                # Panel lost after retry exhaustion: fail its requests
                # individually and keep serving — a dead step must not
                # take the stream down with it.
                self._faults.failed_steps += 1
                self._faults.failed += len(batch)
                reason = (
                    f"step failed: {estats.get('error') or 'unknown error'}"
                )
                for req in batch:
                    self._failures[req.rid] = reason
                self._tick += 1
                return None
            quarantined = set(estats.get("quarantined_request_ids") or ())
            done_tick = self._tick + 1  # service completes at tick end
            for j, req in enumerate(batch):
                if req.rid in quarantined:
                    self._faults.quarantined += 1
                    self._failures[req.rid] = (
                        "quarantined: non-finite output column"
                    )
                    continue
                self._results[req.rid] = out[:, j]
                self._latencies[req.rid] = done_tick - req.arrival
                if req.deadline is not None and done_tick > req.deadline:
                    self._deadline_misses += 1
                    self._faults.completed_late += 1
            plan_stats = estats.get("plan") or {}
            record = StepRecord(
                tick=self._tick,
                request_ids=tuple(r.rid for r in batch),
                occupancy=estats["batch"],
                padded_width=estats["padded_batch"],
                grid_steps=estats["grid_steps"],
                kernel_launches=estats["kernel_launches"],
                resident=estats["resident"],
                width_class=plan_stats.get("width_class"),
                plan_cache_hit=plan_stats.get("cache_hit"),
                retries=int(estats.get("retries", 0)),
                quarantined=len(quarantined),
                plan_level=plan_stats.get("level"),
                degraded=bool(plan_stats.get("degraded", False)),
            )
            self._steps.append(record)
        else:
            self._idle_ticks += 1
        self._tick += 1
        return record

    def drain(self) -> list[StepRecord]:
        """Step (forced) until no request is pending."""
        records = []
        while len(self.queue):
            rec = self.step(force=True)
            if rec is not None:
                records.append(rec)
        return records

    def run_trace(self, trace: Sequence[Sequence[Array]]) -> ServeStats:
        """Serve an arrival trace: ``trace[t]`` = feature columns arriving
        at tick t. One scheduler step per tick, then a forced drain."""
        for arrivals in trace:
            for features in arrivals:
                self.submit(features)
            self.step()
        self.drain()
        return self.stats()

    def stats(self) -> ServeStats:
        return ServeStats.from_steps(
            self._steps, self._latencies, self._deadline_misses,
            self._idle_ticks, faults=self._faults,
        )


def poissonish_trace(
    n_requests: int,
    *,
    m: int,
    lam: float = 4.0,
    burst_every: int = 16,
    burst_size: int = 0,
    seed: int = 0,
) -> list[list[Array]]:
    """Deterministic bursty arrival trace: ``trace[t]`` is the list of
    (m,) feature columns arriving at tick t.

    Per-tick counts are Poisson(``lam``) draws from a seeded NumPy
    generator, with an extra ``burst_size`` arrivals every
    ``burst_every`` ticks (the skew that makes static batching pad).
    Same arguments → bit-identical trace, including feature values, in
    both packages (the columns are CPU tensors here).
    """
    if lam <= 0 and not (burst_size and burst_every):
        raise ValueError(
            "lam <= 0 with no bursts can never produce an arrival; "
            "the trace would grow forever"
        )
    rng = np.random.default_rng(seed)
    trace: list[list[Array]] = []
    total = 0
    t = 0
    while total < n_requests:
        count = int(rng.poisson(lam))
        if burst_size and burst_every and t % burst_every == burst_every - 1:
            count += burst_size
        count = min(count, n_requests - total)
        cols = [
            torch.from_numpy(rng.uniform(0.0, 1.0, size=(m,)).astype(np.float32))
            for _ in range(count)
        ]
        trace.append(cols)
        total += count
        t += 1
    return trace


def serve_trace_static(
    engine: SparseDNNEngine, trace: Iterable[Sequence[Array]]
) -> ServeStats:
    """The pre-scheduler baseline: static aligned batching.

    Every tick's arrivals are served immediately through the one-shot
    ``infer`` API — one aligned, right-padded batch per call at the
    engine's ``batch_align`` (construct the engine with ``batch_align =
    batch_size`` for the classic fixed-service-width setup). No
    cross-tick packing: a 3-request tick pays for a full aligned panel,
    which is exactly the pad waste the continuous batcher removes.
    """
    steps: list[StepRecord] = []
    latencies: dict[int, int] = {}
    rid = 0
    for t, arrivals in enumerate(trace):
        if not arrivals:
            continue
        cols = torch.stack(list(arrivals), dim=1)
        out, estats = engine.infer(cols)
        ids = tuple(range(rid, rid + len(arrivals)))
        rid += len(arrivals)
        for r in ids:
            latencies[r] = 1  # served the tick it arrived
        plan_stats = estats.get("plan") or {}
        steps.append(
            StepRecord(
                tick=t,
                request_ids=ids,
                occupancy=estats["batch"],
                padded_width=estats["padded_batch"],
                grid_steps=estats["grid_steps"],
                kernel_launches=estats["kernel_launches"],
                resident=estats["resident"],
                width_class=plan_stats.get("width_class"),
                plan_cache_hit=plan_stats.get("cache_hit"),
            )
        )
    return ServeStats.from_steps(steps, latencies, 0, idle_ticks=0)


def compare_static_continuous(
    make_engine,
    trace: Sequence[Sequence[Array]],
    *,
    batch_size: int = 64,
    tile_align: int = 8,
    min_fill: float = 0.0,
    max_wait: int = 4,
) -> dict:
    """Run the same trace through static aligned batching and the
    continuous batcher; return both :class:`ServeStats` plus the
    head-to-head ratios and per-arm wall-clock (host seconds, indicative
    only).

    ``make_engine(batch_align)`` must build a fresh engine over the same
    weights (fresh, so served/step counters don't leak across arms).
    """
    t0 = time.perf_counter()
    static = serve_trace_static(make_engine(batch_size), trace)
    t_static = time.perf_counter() - t0
    batcher = ContinuousBatcher(
        make_engine(tile_align),
        batch_size=batch_size,
        min_fill=min_fill,
        max_wait=max_wait,
    )
    t0 = time.perf_counter()
    continuous = batcher.run_trace(trace)
    t_continuous = time.perf_counter() - t0
    assert continuous.requests == static.requests, (
        continuous.requests,
        static.requests,
    )
    return {
        "static": static,
        "continuous": continuous,
        "batcher": batcher,
        "pad_fraction_ratio": (
            continuous.pad_slot_fraction / static.pad_slot_fraction
            if static.pad_slot_fraction
            else float("inf")
        ),
        "grid_steps_ratio": (
            continuous.grid_steps_total / static.grid_steps_total
            if static.grid_steps_total
            else float("inf")
        ),
        "wall_time_s": {"static": t_static, "continuous": t_continuous},
    }


__all__ = [
    "Request",
    "RequestQueue",
    "QueueFull",
    "StepRecord",
    "FaultCounters",
    "ServeStats",
    "ContinuousBatcher",
    "poissonish_trace",
    "serve_trace_static",
    "compare_static_continuous",
]
