"""The port's fault injection and graceful degradation against the reference.

The engine and batcher cases of the reference's ``tests/test_faults.py``
(all but the shard-failure one: sharded serving is not ported) run on
both packages with the same schedules, seeds and inputs (the reference's
``jax.random`` stacks and panels, converted through numpy). Both must
pass the reference's assertions, and the port must quarantine, retry
and fail the same request ids, record the same ladder events and serve
the same outputs within ``rtol=1e-5, atol=1e-5``. The injector's numpy
generator is the reference's, so one seed poisons the same columns.
Then the port's own paths: backoff on a ``VirtualClock``, and a CUDA
graph capture that fails demoting its level like a compile failure.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import testing as jtesting
from repro.plan import LEVEL_LAYERED as J_LAYERED
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import RequestQueue as JQueue
from repro.serve import SparseDNNEngine as JEngine
from repro.sparse import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch import testing as T
from repro_torch.plan import LEVEL_LAYERED, LEVEL_RESIDENT, PlanCaptureError, StackPlan
from repro_torch.serve import (
    ContinuousBatcher,
    QueueFull,
    RequestQueue,
    SparseDNNEngine,
    VirtualClock,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jpanel(seed, m, k):
    return jax.random.uniform(jax.random.PRNGKey(seed), (m, k), jnp.float32)


def _jcol(seed, m):
    return jax.random.uniform(jax.random.PRNGKey(seed), (m,), jnp.float32)


REF = types.SimpleNamespace(
    Engine=JEngine, Batcher=JBatcher, Queue=JQueue, faults=jtesting, panel=_jpanel,
    col=_jcol, np=np.asarray)
PORT = types.SimpleNamespace(
    Engine=lambda *a, **k: SparseDNNEngine(*a, device="cpu", **k), Batcher=ContinuousBatcher,
    Queue=RequestQueue, faults=T,
    panel=lambda seed, m, k: torch.from_numpy(np.array(_jpanel(seed, m, k))),
    col=lambda seed, m: torch.from_numpy(np.array(_jcol(seed, m))), np=lambda t: t.numpy())


def _bsr_stack(side, seed, L, m, bpr=2, block=16):
    ks = jax.random.split(jax.random.PRNGKey(seed), L)
    ws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr) for k in ks]
    bs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    if side is REF:
        return ws, bs
    return [convert.layout(w) for w in ws], [convert.bias(b) for b in bs]


def _both(scenario):
    return scenario(REF), scenario(PORT)


def _same_out(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _same_stats(tstats, jstats):
    """Engine step stats equal, but for the port's launch field name."""
    t, j = dict(tstats), dict(jstats)
    assert t.pop("kernel_launches") == j.pop("pallas_calls")
    t.pop("grid_steps"), j.pop("grid_steps")  # billed at each package's tile
    assert t == j


# ---------------------------------------------------------------------
# FaultInjector mechanics
# ---------------------------------------------------------------------


def test_injector_scheduled_pop_and_log():
    for F in (T, jtesting):
        inj = F.FaultInjector(seed=3)
        inj.schedule(F.SITE_PANEL_NANS, 2, count=1)
        inj.schedule(F.SITE_PANEL_NANS, 2, count=2)
        assert inj.pending() == 2
        assert inj.fires(F.SITE_PANEL_NANS, 0) is None
        assert inj.fires(F.SITE_STEP_TRANSIENT, 2) is None
        assert inj.fires(F.SITE_PANEL_NANS, 2) == {"count": 1}
        assert inj.fires(F.SITE_PANEL_NANS, 2) == {"count": 2}
        assert inj.fires(F.SITE_PANEL_NANS, 2) is None
        assert inj.pending() == 0
        assert [e.payload for e in inj.fired_at(F.SITE_PANEL_NANS)] == [{"count": 1},
                                                                         {"count": 2}]
    assert T.ALL_SITES == jtesting.faults.ALL_SITES


def test_injector_rejects_unknown_site_and_negative_when():
    inj = T.FaultInjector()
    with pytest.raises(ValueError, match="unknown fault site"):
        inj.schedule("not-a-site", 0)
    with pytest.raises(ValueError, match="when"):
        inj.schedule(T.SITE_PANEL_NANS, -1)


def test_injector_rng_is_seeded_like_the_reference():
    a = T.FaultInjector(seed=7).rng.integers(0, 1 << 30, size=8)
    b = T.FaultInjector(seed=7).rng.integers(0, 1 << 30, size=8)
    c = jtesting.FaultInjector(seed=7).rng.integers(0, 1 << 30, size=8)
    assert np.array_equal(a, b) and np.array_equal(a, c)


def test_poison_panel_columns_and_limit():
    jp = _jpanel(0, 8, 6)
    panel = torch.from_numpy(np.array(jp))
    poisoned, cols = T.poison_panel(panel, columns=[1, 4])
    assert cols == (1, 4)
    assert not bool(torch.isfinite(poisoned[:, [1, 4]]).any())
    assert torch.equal(poisoned[:, [0, 2, 3, 5]], panel[:, [0, 2, 3, 5]])
    assert bool(torch.isfinite(panel).all())  # the caller's panel is not written
    _, cols = T.poison_panel(panel, count=3, limit=4, rng=np.random.default_rng(0))
    _, jcols = jtesting.poison_panel(jp, count=3, limit=4, rng=np.random.default_rng(0))
    assert cols == jcols and len(cols) == 3 and all(c < 4 for c in cols)
    inf, _ = T.poison_panel(panel, columns=[2], mode="inf")
    assert bool(torch.isinf(inf[:, 2]).all())
    with pytest.raises(ValueError, match="out of range"):
        T.poison_panel(panel, columns=[5], limit=4)
    with pytest.raises(ValueError, match="mode"):
        T.poison_panel(panel, mode="zero")


# ---------------------------------------------------------------------
# engine: quarantine / retry / graceful failure / eviction
# ---------------------------------------------------------------------


def test_engine_quarantines_only_poisoned_requests():
    def scenario(side):
        m, k = 32, 6
        ws, bs = _bsr_stack(side, 1, 3, m)
        ref, _ = side.Engine(ws, bs, batch_align=8).infer(side.panel(1, m, k))
        inj = side.faults.FaultInjector(seed=0)
        inj.schedule(side.faults.SITE_PANEL_NANS, 0, columns=[1, 4])
        out, stats = side.Engine(ws, bs, batch_align=8, fault_injector=inj).infer(
            side.panel(1, m, k))
        assert stats["failed"] is False and stats["quarantined_request_ids"] == [1, 4]
        for j in (0, 2, 3, 5):
            assert np.array_equal(side.np(out[:, j]), side.np(ref[:, j]))
        assert not np.isfinite(side.np(out[:, 1])).any()
        return out, stats

    (jout, jstats), (out, stats) = _both(scenario)
    _same_stats(stats, jstats)
    _same_out(out[:, [0, 2, 3, 5]], np.asarray(jout)[:, [0, 2, 3, 5]])


def test_engine_quarantines_randomly_chosen_columns_like_the_reference():
    def scenario(side):
        ws, bs = _bsr_stack(side, 1, 2, 32)
        inj = side.faults.FaultInjector(seed=5)
        inj.schedule(side.faults.SITE_PANEL_NANS, 0, count=2)
        return side.Engine(ws, bs, batch_align=8, fault_injector=inj).infer(
            side.panel(2, 32, 7))[1]

    jstats, stats = _both(scenario)
    assert len(stats["quarantined_request_ids"]) == 2
    _same_stats(stats, jstats)


def test_engine_retries_transient_then_succeeds():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 2, 2, m)
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_STEP_TRANSIENT, 0, failures=2)
        eng = side.Engine(ws, bs, batch_align=8, fault_injector=inj, max_step_retries=2)
        out, stats = eng.infer(side.panel(3, m, 4))
        ref, _ = side.Engine(ws, bs, batch_align=8).infer(side.panel(3, m, 4))
        assert stats["failed"] is False and stats["retries"] == 2
        assert np.array_equal(side.np(out), side.np(ref))
        return out, stats

    (jout, jstats), (out, stats) = _both(scenario)
    _same_stats(stats, jstats)
    _same_out(out, jout)


def test_engine_fails_gracefully_after_retry_exhaustion():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 2, 2, m)
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_STEP_TRANSIENT, 0, failures=10)
        eng = side.Engine(ws, bs, batch_align=8, fault_injector=inj, max_step_retries=2)
        out, stats = eng.infer(side.panel(4, m, 4))
        assert out is None and stats["failed"] is True and stats["retries"] == 2
        assert stats["request_ids"] == [0, 1, 2, 3] and "TransientFault" in stats["error"]
        out2, stats2 = eng.infer(side.panel(5, m, 4))
        assert stats2["failed"] is False and np.isfinite(side.np(out2)).all()
        return stats, stats2, out2

    (j1, j2, jout), (t1, t2, out) = _both(scenario)
    _same_stats(t1, j1)
    _same_stats(t2, j2)
    _same_out(out, jout)


def test_engine_cache_eviction_storm_recompiles():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 3, 2, m)
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_CACHE_EVICTION, 2)
        eng = side.Engine(ws, bs, batch_align=8, fault_injector=inj)
        hits = [eng.infer(side.panel(i, m, 4))[1]["plan"]["cache_hit"] for i in range(4)]
        assert hits == [False, True, False, True]
        return [eng.plan_cache.stats()[k] for k in ("builds", "hits", "misses")]

    j, t = _both(scenario)
    assert t == j


# ---------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------


def test_compile_failure_demotes_resident_to_layered():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 4, 2, m)
        ref, _ = side.Engine(ws, bs, batch_align=8, use_resident=False).infer(
            side.panel(6, m, 4))
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_PLAN_COMPILE, 0)
        eng = side.Engine(ws, bs, batch_align=8, fault_injector=inj)
        assert eng.ladder.preferred_level == "resident"
        out, stats = eng.infer(side.panel(6, m, 4))
        assert stats["failed"] is False and stats["plan"]["level"] == "layered"
        assert stats["plan"]["degraded"] is True
        assert np.array_equal(side.np(out), side.np(ref))
        assert not eng.ladder.is_healthy("resident")
        ev = eng.ladder.events
        assert len(ev) == 1 and ev[0].healthy is False
        levels = [eng.infer(side.panel(7, m, 4))[1]["plan"]["level"]]
        eng.ladder.restore("resident")
        _, s3 = eng.infer(side.panel(8, m, 4))
        levels.append(s3["plan"]["level"])
        assert levels == ["layered", "resident"] and s3["plan"]["degraded"] is False
        return [(e.step, e.level, e.healthy, e.reason) for e in eng.ladder.events], out

    (jev, jout), (ev, out) = _both(scenario)
    assert ev == jev
    _same_out(out, jout)


def test_restore_reverses_demotion_and_logs_up_transition():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 9, 2, m)
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_PLAN_COMPILE, 0)
        eng = side.Engine(ws, bs, batch_align=8, fault_injector=inj)
        _, s0 = eng.infer(side.panel(20, m, 4))
        assert s0["plan"]["level"] == "layered"
        eng.ladder.restore("resident", reason="node re-slotted", step=7)
        assert [(e.level, e.healthy) for e in eng.ladder.events] == [
            ("resident", False), ("resident", True)]
        up = eng.ladder.events[-1]
        assert up.reason == "node re-slotted" and up.step == 7
        assert eng.ladder.is_healthy("resident") and not eng.ladder.degraded
        eng.ladder.restore("resident")
        assert len(eng.ladder.events) == 2
        with pytest.raises(ValueError, match="health"):
            eng.ladder.restore("layered")
        p = side.panel(21, m, 4)
        out, s1 = eng.infer(p)
        ref, _ = side.Engine(ws, bs, batch_align=8).infer(p)
        assert s1["plan"]["level"] == "resident" and s1["plan"]["degraded"] is False
        assert np.array_equal(side.np(out), side.np(ref))
        d = eng.ladder.describe()
        assert d["current"] == d["preferred"] == "resident"
        assert [e["healthy"] for e in d["events"]] == [False, True]
        d.pop("health")  # the reference also tracks its sharded level
        return d

    j, t = _both(scenario)
    assert t == j


# ---------------------------------------------------------------------
# batcher: backpressure / shedding / stragglers / goodput
# ---------------------------------------------------------------------


def test_bounded_queue_backpressure():
    q = RequestQueue(max_pending=2)
    q.submit(PORT.col(0, 8), now=0)
    q.submit(PORT.col(1, 8), now=0)
    with pytest.raises(QueueFull):
        q.submit(PORT.col(2, 8), now=0)

    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 6, 2, m)
        b = side.Batcher(side.Engine(ws, bs, batch_align=4), batch_size=4, max_pending=2)
        assert b.submit(side.col(0, m)) is not None
        assert b.submit(side.col(1, m)) is not None
        assert b.submit(side.col(2, m)) is None
        b.drain()
        s = b.stats()
        assert s.faults.offered == 3 and s.faults.rejected == 1 and s.requests == 2
        assert s.goodput == pytest.approx(2 / 3)
        return s.summary()

    j, t = _both(scenario)
    assert t.pop("grid_steps_total") == j.pop("grid_steps_total")  # widths of 4
    assert t == j


def test_batcher_straggler_tick_and_failed_step_accounting():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 7, 2, m)
        inj = side.faults.FaultInjector()
        inj.schedule(side.faults.SITE_STRAGGLER, 0, seconds=0.0)
        inj.schedule(side.faults.SITE_STEP_TRANSIENT, 0, failures=10)
        eng = side.Engine(ws, bs, batch_align=4, fault_injector=inj, max_step_retries=1)
        b = side.Batcher(eng, batch_size=4, fault_injector=inj)
        r0 = b.submit(side.col(0, m))
        b.step()
        r1 = b.submit(side.col(1, m))
        b.drain()
        s = b.stats()
        assert s.faults.straggler_ticks == 1 and s.faults.failed_steps == 1
        assert s.faults.failed == 1 and s.faults.retried_steps == 1
        assert "step failed" in b.failures[r0] and r1 in s.latencies
        assert s.goodput == pytest.approx(1 / 2)
        return s.summary(), b.failures

    (js, jf), (ts, tf) = _both(scenario)
    assert ts == js and tf == jf


def test_injected_trace_completes_with_goodput():
    def scenario(side):
        m = 32
        ws, bs = _bsr_stack(side, 8, 3, m)
        F = side.faults
        inj = F.FaultInjector(seed=1)
        inj.schedule(F.SITE_PANEL_NANS, 1, count=1)
        inj.schedule(F.SITE_STEP_TRANSIENT, 2, failures=1)
        inj.schedule(F.SITE_CACHE_EVICTION, 3)
        inj.schedule(F.SITE_STRAGGLER, 2, seconds=0.0)
        eng = side.Engine(ws, bs, batch_align=4, fault_injector=inj)
        b = side.Batcher(eng, batch_size=4, fault_injector=inj)
        n = 24
        for i in range(n):
            b.submit(side.col(100 + i, m))
            if i % 2:
                b.step()
        b.drain()
        s = b.stats()
        assert s.faults.quarantined == 1 and s.faults.retried_steps == 1
        assert s.faults.straggler_ticks == 1 and s.faults.failed == 0
        assert s.requests == n - 1 and s.goodput == pytest.approx((n - 1) / n)
        assert inj.pending() == 0
        quarantined = [r for r, why in b.failures.items() if "quarantine" in why]
        assert len(quarantined) == 1
        for rid in s.latencies:
            assert np.isfinite(side.np(b.result(rid))).all()
        return b

    jb, tb = _both(scenario)
    js, ts = jb.stats(), tb.stats()
    assert ts.summary() == js.summary()  # every panel 4 wide: the same bill
    assert tb.failures == jb.failures
    for rid in js.latencies:
        _same_out(tb.result(rid), jb.result(rid))


# ---------------------------------------------------------------------
# the port's own paths
# ---------------------------------------------------------------------


def test_retry_backoff_sleeps_on_the_injected_clock():
    ws, bs = _bsr_stack(PORT, 2, 2, 32)
    inj = T.FaultInjector()
    inj.schedule(T.SITE_STEP_TRANSIENT, 0, failures=2)
    clock = VirtualClock()
    eng = SparseDNNEngine(ws, bs, batch_align=8, device="cpu", fault_injector=inj,
                          retry_backoff_s=0.5, clock=clock)
    _, stats = eng.infer(PORT.panel(3, 32, 4))
    assert stats["retries"] == 2 and clock.sleeps == [0.5, 1.0] and clock.now() == 1.5
    with pytest.raises(ValueError, match="backwards"):
        clock.advance_to(1.0)


def test_a_failed_capture_demotes_its_level_like_a_compile_failure(monkeypatch):
    """A resident plan whose CUDA graph capture fails (simulated here: the
    CPU captures nothing) is a plan-compile failure: the ladder records
    the demotion and the panel is served by the layered plan."""
    forward = StackPlan.forward

    def failing(self, y0):
        if self.is_fused_route:
            raise PlanCaptureError("capturing the fused plan failed: simulated")
        return forward(self, y0)

    ws, bs = _bsr_stack(PORT, 4, 2, 32)
    want, _ = SparseDNNEngine(ws, bs, batch_align=8, device="cpu", use_resident=False).infer(
        PORT.panel(6, 32, 4))
    monkeypatch.setattr(StackPlan, "forward", failing)
    eng = SparseDNNEngine(ws, bs, batch_align=8, device="cpu")
    out, stats = eng.infer(PORT.panel(6, 32, 4))
    assert stats["failed"] is False and stats["plan"]["level"] == LEVEL_LAYERED
    assert torch.equal(out, want)
    (ev,) = eng.ladder.events
    assert (ev.level, ev.healthy, ev.step) == (LEVEL_RESIDENT, False, 0)
    assert "PlanCaptureError" in ev.reason
    # a failing floor is a failed panel, not a raised error
    monkeypatch.setattr(StackPlan, "forward", lambda self, y0: (_ for _ in ()).throw(
        PlanCaptureError("simulated")))
    out, stats = eng.infer(PORT.panel(7, 32, 4))
    assert out is None and stats["failed"] and "PlanCaptureError" in stats["error"]
    assert J_LAYERED == LEVEL_LAYERED
