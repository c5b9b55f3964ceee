"""The port's replica fleet and front end against the reference's.

Every case of the reference's ``tests/test_fleet.py`` runs on both
packages over a ``VirtualClock``, with the same stacks (``jax.random``
ones converted through numpy) and the same traces (the load generator
is bit-identical, ``tests/test_torch_loadgen.py``). Beside the
reference's own assertions, which both sides must pass, the two runs
must give the same routing log (rid, width class, replica, reason),
the same served, rejected and missed counts, and the same
``FleetFrontend.stats()`` byte for byte: the service model charges the
launch bill, and for these panels of at most 16 columns the port's bill
(16-column tiles) equals the reference's. Outputs agree within
``rtol=atol=1e-5``. No test sleeps for real.
"""

import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import FleetFrontend as JFrontend
from repro.serve import LoadProfile as JProfile
from repro.serve import ReplicaFleet as JFleet
from repro.serve import ServiceModel as JService
from repro.serve import SparseDNNEngine as JEngine
from repro.serve import VirtualClock as JVirtualClock
from repro.serve import generate_jobs as jgenerate
from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.testing import faults as jfaults
from repro_torch import convert
from repro_torch.serve import (
    FleetFrontend,
    LoadProfile,
    ReplicaFleet,
    ServiceModel,
    SparseDNNEngine,
    VirtualClock,
    generate_jobs,
)
from repro_torch.serve.fleet import REASON_AFFINITY, REASON_CLAIM, REASON_FAILOVER
from repro_torch.testing import faults

M = 32
CLASSES = (8, 16)
TOL = dict(rtol=1e-5, atol=1e-5)

REF = types.SimpleNamespace(
    name="reference", Engine=JEngine, Fleet=JFleet, Frontend=JFrontend, Service=JService,
    VirtualClock=JVirtualClock, Profile=JProfile, generate=jgenerate, faults=jfaults)
PORT = types.SimpleNamespace(
    name="port", Engine=lambda *a, **k: SparseDNNEngine(*a, device="cpu", **k),
    Fleet=ReplicaFleet, Frontend=FleetFrontend, Service=ServiceModel,
    VirtualClock=VirtualClock, Profile=LoadProfile,
    generate=lambda *a, **k: generate_jobs(*a, device="cpu", **k), faults=faults)


@pytest.fixture(autouse=True)
def _no_real_sleep(monkeypatch):
    def _boom(seconds):
        raise AssertionError(f"real time.sleep({seconds}) in a virtual-clock test")

    monkeypatch.setattr(time, "sleep", _boom)


def _stack(side, seed=0, L=2, m=M, bpr=2, block=16):
    ks = jax.random.split(jax.random.key(seed), L)
    ws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr) for k in ks]
    bs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    if side is REF:
        return ws, bs
    return [convert.layout(w) for w in ws], [convert.bias(b) for b in bs]


def _fleet(side, ws, bs, n=3, **kw):
    engines = [side.Engine(ws, bs, batch_align=8) for _ in range(n)]
    return side.Fleet(engines, width_classes=CLASSES, **kw)


def _trace(side, seed=5, rate=30.0, duration=2.0, deadline_s=None):
    return side.generate(side.Profile.constant(rate), duration, m=M, seed=seed,
                         width_mix=((2, 0.6), (12, 0.4)), deadline_s=deadline_s)


def _run(side, fleet, jobs, **kw):
    fe = side.Frontend(fleet, clock=side.VirtualClock(),
                       service_model=side.Service(base_s=1e-3, per_grid_step_s=1e-4), **kw)
    return fe, fe.run(jobs)


def _log(fleet):
    return [(d.rid, d.width_class, d.replica, d.reason) for d in fleet.decisions]


def _same_runs(j, t):
    """Reference and port runs of one scenario: (fleet, frontend, stats)."""
    (jfleet, jfe, jstats), (fleet, fe, stats) = j, t
    assert _log(fleet) == _log(jfleet)
    assert json.dumps(stats, sort_keys=True) == json.dumps(jstats, sort_keys=True)
    assert fe.rejected == jfe.rejected and fe.requeues == jfe.requeues
    assert [c.__dict__ for c in fe.completed] == [c.__dict__ for c in jfe.completed]
    assert set(fe.results) == set(jfe.results)
    for rid, out in fe.results.items():
        np.testing.assert_allclose(out.numpy(), np.asarray(jfe.results[rid]), **TOL)


def _both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


# ---------------------------------------------------------------------
# construction / isolation
# ---------------------------------------------------------------------


@pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])
def test_replicas_must_not_share_plan_cache(side):
    ws, bs = _stack(side)
    a = side.Engine(ws, bs, batch_align=8)
    b = side.Engine(ws, bs, batch_align=8, plan_cache=a.plan_cache)
    with pytest.raises(ValueError, match="share a plan_cache"):
        side.Fleet([a, b], width_classes=CLASSES)


@pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])
def test_replicas_must_share_one_topology(side):
    ws, bs = _stack(side, 0)
    ws2, bs2 = _stack(side, 1, L=3)
    with pytest.raises(ValueError, match="different topologies"):
        side.Fleet([side.Engine(ws, bs, batch_align=8), side.Engine(ws2, bs2, batch_align=8)],
                   width_classes=CLASSES)


@pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])
def test_per_replica_caches_and_ladders_are_distinct(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    assert len({id(r.engine.plan_cache) for r in fleet.replicas}) == 3
    assert len({id(r.engine.ladder) for r in fleet.replicas}) == 3
    with pytest.raises(ValueError):
        side.Fleet([], width_classes=CLASSES)
    with pytest.raises(ValueError):
        _fleet(side, ws, bs, affinity_slack=-1)


# ---------------------------------------------------------------------
# router: width-class affinity
# ---------------------------------------------------------------------


def _affinity(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    jobs = _trace(side, rate=40.0, duration=2.0)
    assert len(jobs) >= 30
    fe, stats = _run(side, fleet, jobs)
    f = stats["fleet"]
    assert stats["served_jobs"] == len(jobs)
    owners = {int(c): i for c, i in f["owners"].items()}
    assert set(owners) == {8, 16} and len(set(owners.values())) == 2
    per = {r["replica"]: r for r in f["per_replica"]}
    for cls, owner in owners.items():
        assert per[owner]["compiled_classes"] == [cls]
        assert per[owner]["compiles"] == 1
    idle = (set(per) - set(owners.values())).pop()
    assert per[idle]["compiles"] == 0
    assert f["cross_replica_compiles"] == 0
    assert f["plan_hit_rate"] >= 0.9
    reasons = {d.reason for d in fleet.decisions}
    assert REASON_CLAIM in reasons and REASON_AFFINITY in reasons
    return fleet, fe, stats


def test_affinity_one_compile_per_owned_class_and_high_hit_rate():
    _same_runs(*_both(_affinity))


def _single_engine_reference(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    jobs = _trace(side, seed=9, rate=25.0, duration=1.5)
    fe, stats = _run(side, fleet, jobs)
    ref = side.Engine(ws, bs, batch_align=8)
    assert set(fe.results) == {j.rid for j in jobs}
    for job in jobs:
        expect, _ = ref.infer(job.features)
        got = fe.results[job.rid]
        assert tuple(got.shape) == tuple(job.features.shape)
        np.testing.assert_allclose(np.asarray(got), np.asarray(expect), **TOL)
    return fleet, fe, stats


def test_fleet_outputs_match_single_engine_reference():
    _same_runs(*_both(_single_engine_reference))


def _spill(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs, affinity_slack=0)
    jobs = side.generate(side.Profile.constant(200.0), 0.5, m=M, seed=2, width_mix=((2, 1.0),))
    fe, stats = _run(side, fleet, jobs)
    dispatched = [r["dispatches"] for r in stats["fleet"]["per_replica"]]
    assert sum(dispatched) == len(jobs)
    assert sum(1 for d in dispatched if d > 0) >= 2
    assert stats["fleet"]["routing"].get("spill", 0) > 0
    return fleet, fe, stats


def test_router_spills_off_a_backed_up_owner():
    _same_runs(*_both(_spill))


# ---------------------------------------------------------------------
# replica loss: failover without drops
# ---------------------------------------------------------------------


def _replica_loss(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    jobs = _trace(side, seed=13, rate=60.0, duration=1.5)
    inj = side.faults.FaultInjector()
    inj.schedule(side.faults.SITE_REPLICA_LOSS, 8, replica=0)
    fe, stats = _run(side, fleet, jobs, fault_injector=inj)
    assert inj.pending() == 0
    f = stats["fleet"]
    assert f["alive"] == 2 and not fleet.replicas[0].alive
    assert stats["offered_jobs"] == stats["served_jobs"] == len(jobs)
    assert stats["failed_jobs"] == stats["rejected_jobs"] == 0
    assert stats["requeued_jobs"] >= 1
    [event] = f["events"]
    assert event["event"] == "replica-loss" and event["replica"] == 0
    assert event["requeued_jobs"] == stats["requeued_jobs"]
    assert any(d.reason == REASON_FAILOVER for d in fleet.decisions)
    assert set(f["owners"].values()) <= {1, 2}
    ref = side.Engine(ws, bs, batch_align=8)
    for job in jobs[:5]:
        expect, _ = ref.infer(job.features)
        np.testing.assert_allclose(np.asarray(fe.results[job.rid]), np.asarray(expect), **TOL)
    return fleet, fe, stats


def test_replica_loss_mid_trace_drops_nothing():
    _same_runs(*_both(_replica_loss))


def _slow_replica(side):
    ws, bs = _stack(side)
    jobs = _trace(side, seed=4, rate=20.0, duration=1.0)
    base_fleet = _fleet(side, ws, bs)
    _, base = _run(side, base_fleet, jobs)
    inj = side.faults.FaultInjector()
    inj.schedule(side.faults.SITE_REPLICA_SLOW, 0, factor=100.0)
    fleet = _fleet(side, ws, bs)
    fe, slow = _run(side, fleet, jobs, fault_injector=inj)
    assert inj.pending() == 0
    assert slow["served_jobs"] == base["served_jobs"] == len(jobs)
    assert slow["latency_max_s"] > 10 * base["latency_max_s"]
    return fleet, fe, slow


def test_slow_replica_inflates_latency_not_correctness():
    _same_runs(*_both(_slow_replica))


# ---------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------


def _overload(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    jobs = side.generate(side.Profile.bursty(10.0, 400.0, 1.0, 0.5), 1.0, m=M, seed=6,
                         width_mix=((12, 1.0),))
    fe, stats = _run(side, fleet, jobs, max_pending_cols=36)
    assert stats["rejected_jobs"] > 0
    assert stats["admitted_jobs"] + stats["rejected_jobs"] == len(jobs)
    assert stats["served_jobs"] == stats["admitted_jobs"]
    assert set(fe.rejected).isdisjoint(fe.results)
    assert stats["miss_rate"] >= stats["rejected_jobs"] / len(jobs)
    return fleet, fe, stats


def test_bounded_admission_rejects_overload():
    _same_runs(*_both(_overload))


def _deadlines(side):
    ws, bs = _stack(side)
    fleet = _fleet(side, ws, bs)
    jobs = _trace(side, seed=8, rate=120.0, duration=0.5, deadline_s=0.0005)
    fe, stats = _run(side, fleet, jobs)
    assert stats["served_jobs"] == len(jobs)
    assert stats["deadline_misses"] > 0 and stats["miss_rate"] > 0
    assert stats["goodput_cols_per_s"] < stats["throughput_cols_per_s"]
    return fleet, fe, stats


def test_deadline_misses_counted_against_goodput():
    _same_runs(*_both(_deadlines))


# ---------------------------------------------------------------------
# determinism / lifecycle
# ---------------------------------------------------------------------


def _faulted(side):
    ws, bs = _stack(side)
    jobs = _trace(side, seed=21, rate=50.0, duration=1.0, deadline_s=0.05)

    def inj():
        i = side.faults.FaultInjector()
        i.schedule(side.faults.SITE_REPLICA_LOSS, 5, replica=1)
        i.schedule(side.faults.SITE_REPLICA_SLOW, 9, factor=7.0)
        return i

    _, a = _run(side, _fleet(side, ws, bs), jobs, fault_injector=inj())
    fleet = _fleet(side, ws, bs)
    fe, b = _run(side, fleet, jobs, fault_injector=inj())
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    return fleet, fe, b


def test_frontend_is_bit_deterministic():
    _same_runs(*_both(_faulted))


@pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])
def test_frontend_runs_once_and_handles_empty_trace(side):
    ws, bs = _stack(side)
    fe = side.Frontend(_fleet(side, ws, bs), clock=side.VirtualClock())
    stats = fe.run([])
    assert stats["offered_jobs"] == 0
    assert stats["throughput_cols_per_s"] == 0.0
    with pytest.raises(RuntimeError, match="one trace"):
        fe.run([])


def test_fleet_of_mesh_engines():
    """Replicas that each serve sharded: the same routing and outputs as a
    fleet of unsharded replicas (the bills, hence the service times, are
    the same: the per-shard bills sum to the unsharded bill)."""
    from repro_torch.launch.mesh import make_row_blocks_mesh

    jws, _ = _stack(REF)
    ws = [convert.layout(JBCSR.from_bsr(w)) for w in jws]
    _, bs = _stack(PORT)
    jobs = _trace(PORT, seed=5, rate=30.0, duration=1.0)
    runs = []
    for mesh in (None, make_row_blocks_mesh(2, device="cpu")):
        engines = [SparseDNNEngine(ws, bs, batch_align=8, device="cpu", mesh=mesh,
                                   use_resident=False) for _ in range(2)]
        fleet = ReplicaFleet(engines, width_classes=CLASSES)
        runs.append((fleet, *_run(PORT, fleet, jobs)))
    (f0, fe0, s0), (f1, fe1, s1) = runs
    routes = {p.route for r in f1.replicas for p in r.engine.plan_cache.plans()}
    assert routes == {"sharded"}
    assert _log(f1) == _log(f0)
    assert s1["served_jobs"] == s0["served_jobs"] == len(jobs)
    assert s1["latency_p99_s"] == s0["latency_p99_s"]
    for rid, out in fe1.results.items():
        torch.testing.assert_close(out, fe0.results[rid], **TOL)
