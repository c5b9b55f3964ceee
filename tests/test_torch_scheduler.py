"""The port's continuous batcher against the reference's, case by case.

Every case of the reference's ``tests/test_scheduler.py`` runs on both
packages with the same inputs: the reference's ``jax.random`` stacks and
columns, converted through numpy. The port serves on ``device="cpu"``
(the kernels' plain versions), the reference runs its Pallas kernels in
interpret mode. Beside the reference's own assertions, which both sides
must pass, the two runs must give the same step records (tick, request
ids, occupancy, padded width, width class, cache hit, level, retries,
quarantined), the same ``ServeStats.summary()``, the same latencies and
failures, and outputs within ``rtol=1e-5, atol=1e-5`` (the reference
tests' own tolerance for 2–3-layer stacks).

The launch bill (``grid_steps``) is the reference's cost model at the
port's 16-column tile (``DEFAULT_BLOCK_N``, ROADMAP Queue 3): equal to
the reference's own bill for panels of at most 16 columns.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import RequestQueue as JQueue
from repro.serve import SparseDNNEngine as JEngine
from repro.serve import poissonish_trace as jtrace
from repro.serve import serve_trace_static as jstatic
from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.core import dnn
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.serve import (
    ContinuousBatcher,
    RequestQueue,
    SparseDNNEngine,
    compare_static_continuous,
    poissonish_trace,
    serve_trace_static,
)
from repro_torch.sparse import BlockCSRMatrix

TOL = dict(rtol=1e-5, atol=1e-5)


def _jcol(seed, m):
    return jax.random.uniform(jax.random.PRNGKey(seed), (m,), jnp.float32)


REF = types.SimpleNamespace(
    name="reference", Engine=JEngine, Batcher=JBatcher, Queue=JQueue, trace=jtrace,
    static=jstatic, col=_jcol, forward=lambda ws, bs, y: jdnn.dnn_forward(ws, bs, y, fused=True),
    csr=JBCSR.from_bsr, np=np.asarray)
PORT = types.SimpleNamespace(
    name="port", Engine=lambda *a, **k: SparseDNNEngine(*a, device="cpu", **k),
    Batcher=ContinuousBatcher, Queue=RequestQueue, trace=poissonish_trace,
    static=serve_trace_static, col=lambda seed, m: torch.from_numpy(np.array(_jcol(seed, m))),
    forward=lambda ws, bs, y: dnn.dnn_forward(ws, bs, y, fused=True),
    csr=BlockCSRMatrix.from_bsr, np=lambda t: t.numpy())


def _stack(side, seed, L, m, bpr=2, block=16):
    """The reference tests' ``_stack(PRNGKey(seed), ...)``, on ``side``."""
    ks = jax.random.split(jax.random.PRNGKey(seed), L)
    ws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr) for k in ks]
    bs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    if side is REF:
        return ws, bs
    return [convert.layout(w) for w in ws], [convert.bias(b) for b in bs]


def _both(scenario, *args):
    """``scenario(side, *args)`` on the reference, then on the port."""
    return scenario(REF, *args), scenario(PORT, *args)


def _bill(engine, width):
    """The reference's bill for a ``width``-wide panel of the plan it
    served, at the port's tile."""
    plan = [p for p in engine.plan_cache._entries.values() if p.width == width][-1]
    return jdnn.dnn_grid_steps(plan.weights, width, block_n=DEFAULT_BLOCK_N)


def _record(rec):
    d = dataclasses.asdict(rec)
    d["launches"] = d.pop("pallas_calls") if "pallas_calls" in d else d.pop("kernel_launches")
    d.pop("grid_steps")
    return d


def _same_stats(jstats, tstats, jengine):
    """Step records, summaries and latencies equal; the port's bill is the
    reference's cost model at the port's tile."""
    assert [_record(r) for r in tstats.steps] == [_record(r) for r in jstats.steps]
    bills = [_bill(jengine, r.padded_width) for r in jstats.steps]
    assert [r.grid_steps for r in tstats.steps] == bills
    js, ts = jstats.summary(), tstats.summary()
    for key in ("grid_steps_total", "grid_steps_per_row"):
        js.pop(key), ts.pop(key)
    assert ts == js
    assert tstats.grid_steps_total == sum(bills)
    assert tstats.latencies == jstats.latencies


def _same_results(jb, tb):
    assert tb.failures == jb.failures
    for rid in jb.stats().latencies:
        torch.testing.assert_close(tb.result(rid), torch.from_numpy(np.array(jb.result(rid))),
                                   **TOL)


def _same_batchers(j, t):
    (jb, jeng), (tb, teng) = j, t
    _same_stats(jb.stats(), tb.stats(), jeng)
    _same_results(jb, tb)


# ---------------------------------------------------------------------
# RequestQueue
# ---------------------------------------------------------------------


def test_queue_fifo_within_priority():
    def scenario(side):
        q = side.Queue()
        ids = [q.submit(side.col(i, 8), now=0) for i in range(5)]
        got = [r.rid for r in q.pop_batch(3, now=0)]
        assert got == ids[:3] and len(q) == 2
        return got

    j, t = _both(scenario)
    assert t == j


def test_queue_priority_and_deadline_order():
    def scenario(side):
        q = side.Queue()
        r_low = q.submit(side.col(0, 8), now=0, priority=5)
        r_dead_late = q.submit(side.col(1, 8), now=0, priority=1, deadline=90)
        r_dead_soon = q.submit(side.col(2, 8), now=0, priority=1, deadline=10)
        r_urgent = q.submit(side.col(3, 8), now=0, priority=0)
        got = [r.rid for r in q.pop_batch(4, now=0)]
        assert got == [r_urgent, r_dead_soon, r_dead_late, r_low]
        return got

    j, t = _both(scenario)
    assert t == j


def test_queue_aging_prevents_starvation():
    def scenario(side):
        q = side.Queue(age_every=4)
        old = q.submit(side.col(0, 8), now=0, priority=3)
        fresh = q.submit(side.col(1, 8), now=12, priority=0)
        got = [r.rid for r in q.pop_batch(1, now=12)]
        assert got == [old] != [fresh]
        return got, q.effective_priority(q.pending[0], 12), q.oldest_wait(20)

    j, t = _both(scenario)
    assert t == j


# ---------------------------------------------------------------------
# packing invariants
# ---------------------------------------------------------------------


def test_batcher_packing_invariants():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 0, 2, m)
        eng = side.Engine(ws, bs, batch_align=8)
        b = side.Batcher(eng, batch_size=4, min_fill=0.0, max_wait=0)
        rids = [b.submit(side.col(10 + i, m)) for i in range(11)]
        while b.completed < 11:
            b.step(force=True)
        stats = b.stats()
        assert stats.requests == 11
        served = []
        for rec in stats.steps:
            assert 0 < rec.occupancy <= 4
            assert rec.padded_width == -(-rec.occupancy // 8) * 8
            assert len(rec.request_ids) == rec.occupancy
            served.extend(rec.request_ids)
        assert served == rids and stats.engine_steps >= 3
        return b, eng

    _same_batchers(*_both(scenario))


def test_batcher_no_starvation_under_load():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 1, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=2, min_fill=0.0, age_every=3)
        victim = b.submit(side.col(0, m), priority=9)
        for t in range(40):
            b.submit(side.col(100 + t, m), priority=0)
            b.submit(side.col(200 + t, m), priority=0)
            b.step()
            if victim in b.stats().latencies:
                break
        assert victim in b.stats().latencies, "aged request never served"
        return b, eng

    _same_batchers(*_both(scenario))


def test_batcher_mid_flight_join_and_eviction():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 2, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=8, min_fill=0.0, max_wait=0)
        first = b.submit(side.col(1, m))
        b.step()
        assert b.completed == 1
        late = b.submit(side.col(2, m))
        rec = b.step()
        assert rec.request_ids == (late,)
        want = side.forward(ws, bs, side.col(1, m)[:, None])[:, 0]
        np.testing.assert_allclose(side.np(b.result(first)), side.np(want), **TOL)
        return b, eng

    _same_batchers(*_both(scenario))


def test_min_fill_holds_then_max_wait_forces():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 3, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=8, min_fill=0.5, max_wait=3)
        b.submit(side.col(1, m))
        assert b.step() is None and b.step() is None and b.step() is None
        rec = b.step()
        assert rec is not None and rec.occupancy == 1
        assert b.stats().latency_max == 4
        return b, eng

    _same_batchers(*_both(scenario))


# ---------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------


def test_poissonish_trace_deterministic():
    kw = dict(m=16, lam=2.5, burst_every=8, burst_size=6)
    t1 = poissonish_trace(50, seed=3, **kw)
    t2 = poissonish_trace(50, seed=3, **kw)
    ref = jtrace(50, seed=3, **kw)
    assert [len(a) for a in t1] == [len(a) for a in t2] == [len(a) for a in ref]
    assert sum(len(a) for a in t1) == 50
    for a1, a2, ar in zip(t1, t2, ref):
        for c1, c2, cr in zip(a1, a2, ar):
            assert torch.equal(c1, c2)
            np.testing.assert_array_equal(c1.numpy(), np.asarray(cr))  # bit for bit
    t3 = poissonish_trace(50, seed=4, **kw)
    assert [len(a) for a in t1] != [len(a) for a in t3]


def test_trace_rejects_arrival_free_parameters():
    for trace in (poissonish_trace, jtrace):
        with pytest.raises(ValueError):
            trace(10, m=8, lam=0.0)
        with pytest.raises(ValueError):
            trace(10, m=8, lam=0.0, burst_every=0, burst_size=5)


def test_trace_bursts_land_on_schedule():
    trace = poissonish_trace(60, m=8, lam=0.0, burst_every=4, burst_size=5, seed=0)
    counts = [len(a) for a in trace]
    assert all(c == 0 for i, c in enumerate(counts) if i % 4 != 3)
    assert all(c == 5 for i, c in enumerate(counts) if i % 4 == 3)
    assert counts == [len(a) for a in jtrace(60, m=8, lam=0.0, burst_every=4, burst_size=5,
                                             seed=0)]


# ---------------------------------------------------------------------
# ServeStats accounting vs hand-computed values
# ---------------------------------------------------------------------


def test_servestats_hand_computed():
    def scenario(side):
        m, L, bpr = 32, 2, 2
        ws, bs = _stack(side, 4, L, m, bpr=bpr)
        eng = side.Engine(ws, bs, batch_align=8)
        b = side.Batcher(eng, batch_size=4, min_fill=1.0, max_wait=10)
        for i in range(3):
            b.submit(side.col(i, m))
        b.step()
        b.submit(side.col(9, m))
        rec = b.step()
        assert rec.occupancy == 4 and rec.padded_width == 8
        s = b.stats()
        assert (s.rows_served, s.padded_slots) == (4, 8)
        assert s.pad_slot_fraction == pytest.approx(0.5)
        expect = L * (m // 16) * bpr * 1  # one 8-wide tile: the same bill in both
        assert rec.grid_steps == expect == s.grid_steps_total
        assert s.grid_steps_per_row == pytest.approx(expect / 4)
        assert sorted(s.latencies.values()) == [1, 2, 2, 2]
        assert s.latency_mean == pytest.approx(7 / 4) and s.latency_max == 2
        assert s.idle_ticks == 1
        return b, eng

    (jb, jeng), (tb, teng) = _both(scenario)
    _same_batchers((jb, jeng), (tb, teng))
    assert tb.stats().summary() == jb.stats().summary()  # bills included, at width 8


def test_deadline_miss_accounting():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 5, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=4, min_fill=1.0, max_wait=5)
        rid0 = b.submit(side.col(0, m), deadline=1)
        b.submit(side.col(1, m), deadline=50)
        for _ in range(6):
            b.step()
        s = b.stats()
        assert s.requests == 1 and s.deadline_misses == 1
        assert s.faults.shed_inadmissible == 1 and s.faults.shed_expired == 0
        assert s.goodput == pytest.approx(0.5)
        assert "shed" in b.failures[rid0] and rid0 not in s.latencies
        return b, eng

    _same_batchers(*_both(scenario))


def test_deadline_enforcement_off_serves_late():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 5, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=4, min_fill=1.0, max_wait=5, enforce_deadlines=False)
        b.submit(side.col(0, m), deadline=1)
        b.submit(side.col(1, m), deadline=50)
        for _ in range(6):
            b.step()
        s = b.stats()
        assert s.requests == 2 and s.deadline_misses == 1
        assert s.faults.shed == 0 and s.faults.completed_late == 1
        assert s.goodput == pytest.approx(0.5)
        return b, eng

    _same_batchers(*_both(scenario))


def test_static_baseline_accounting():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 6, 2, m)
        eng = side.Engine(ws, bs, batch_align=16)
        trace = [[side.col(1, m)], [], [side.col(2, m), side.col(3, m)]]
        s = side.static(eng, trace)
        assert s.engine_steps == 2 and s.rows_served == 3 and s.padded_slots == 32
        assert s.pad_slot_fraction == pytest.approx(1 - 3 / 32)
        assert all(v == 1 for v in s.latencies.values())
        return s, eng

    (js, jeng), (ts, teng) = _both(scenario)
    _same_stats(js, ts, jeng)


def test_continuous_beats_static_on_bursty_trace():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 7, 2, m)
        trace = side.trace(40, m=m, lam=2.0, burst_every=6, burst_size=8, seed=11)
        static_eng = side.Engine(ws, bs, batch_align=32)
        static = side.static(static_eng, trace)
        eng = side.Engine(ws, bs, batch_align=8)
        b = side.Batcher(eng, batch_size=32, min_fill=0.25, max_wait=3)
        cont = b.run_trace(trace)
        assert cont.requests == static.requests == 40
        assert cont.pad_slot_fraction < static.pad_slot_fraction
        assert cont.grid_steps_total < static.grid_steps_total
        return (static, static_eng), (b, eng)

    (jstat, jb), (tstat, tb) = _both(scenario)
    _same_stats(jstat[0], tstat[0], jstat[1])
    _same_batchers(jb, tb)


def test_compare_static_continuous_matches_reference():
    from repro.serve import compare_static_continuous as jcompare

    trace_kw = dict(m=32, lam=2.0, burst_every=6, burst_size=8, seed=11)
    ws, bs = _stack(PORT, 7, 2, 32)
    jws, jbs = _stack(REF, 7, 2, 32)
    got = compare_static_continuous(lambda a: SparseDNNEngine(ws, bs, batch_align=a,
                                                              device="cpu"),
                                    poissonish_trace(40, **trace_kw), batch_size=32)
    want = jcompare(lambda a: JEngine(jws, jbs, batch_align=a), jtrace(40, **trace_kw),
                    batch_size=32)
    for arm in ("static", "continuous"):
        assert [_record(r) for r in got[arm].steps] == [_record(r) for r in want[arm].steps]
    assert got["pad_fraction_ratio"] == want["pad_fraction_ratio"] < 1
    assert got["grid_steps_ratio"] < 1 and set(got["wall_time_s"]) == {"static", "continuous"}


# ---------------------------------------------------------------------
# engine routing through the batcher
# ---------------------------------------------------------------------


def test_batcher_routes_resident_path_when_eligible():
    def scenario(side):
        m = 64
        ws, bs = _stack(side, 8, 3, m)
        eng = side.Engine(ws, bs, batch_align=8)
        b = side.Batcher(eng, batch_size=8)
        b.submit(side.col(0, m))
        rec = b.step(force=True)
        assert rec.resident is True
        assert (rec.pallas_calls if side is REF else rec.kernel_launches) == 1
        return b, eng

    _same_batchers(*_both(scenario))


def test_batcher_layered_path_on_mixed_layout():
    def scenario(side):
        m = 64
        ws, bs = _stack(side, 9, 2, m)
        mixed = [side.csr(ws[0]), ws[1]]
        eng = side.Engine(mixed, bs, batch_align=8)
        b = side.Batcher(eng, batch_size=8)
        b.submit(side.col(0, m))
        rec = b.step(force=True)
        assert rec.resident is False
        assert (rec.pallas_calls if side is REF else rec.kernel_launches) == 2
        return b, eng

    _same_batchers(*_both(scenario))


def test_batcher_differentiable_engine():
    def scenario(side):
        m = 64
        ws, bs = _stack(side, 10, 2, m)
        eng = side.Engine(ws, bs, batch_align=8, differentiable=True)
        b = side.Batcher(eng, batch_size=8)
        rid = b.submit(side.col(3, m))
        rec = b.step(force=True)
        assert rec.resident is False
        want = side.forward(ws, bs, side.col(3, m)[:, None])[:, 0]
        np.testing.assert_allclose(side.np(b.result(rid)), side.np(want), **TOL)
        return b, eng

    _same_batchers(*_both(scenario))


def test_batcher_outputs_match_reference_across_panels():
    def scenario(side):
        m = 32
        ws, bs = _stack(side, 11, 2, m)
        eng = side.Engine(ws, bs, batch_align=4)
        b = side.Batcher(eng, batch_size=3, min_fill=0.0)
        cols = {b.submit(side.col(40 + i, m)): side.col(40 + i, m) for i in range(7)}
        b.drain()
        for rid, col in cols.items():
            want = side.forward(ws, bs, col[:, None])[:, 0]
            np.testing.assert_allclose(side.np(b.result(rid)), side.np(want), **TOL)
        return b, eng

    _same_batchers(*_both(scenario))
