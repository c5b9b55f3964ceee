"""The port's clocks and open-loop load generator against the reference's.

Every case of the reference's ``tests/test_loadgen.py`` runs on both
packages: the same profiles, the same traces bit for bit (the same numpy
generator and draws; timestamps, widths, deadlines and feature panels
equal), and the same clock-routed backoff and straggler stalls on a
``VirtualClock`` — with the reference's guard that no test sleeps for
real.
"""

import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import LoadProfile as JProfile
from repro.serve import SparseDNNEngine as JEngine
from repro.serve import VirtualClock as JVirtualClock
from repro.serve import WallClock as JWallClock
from repro.serve import generate_jobs as jgenerate
from repro.serve.clock import Clock as JClock
from repro.sparse import BlockSparseMatrix as JBSR
from repro.testing import faults as jfaults
from repro_torch import convert
from repro_torch.serve import (
    Clock,
    ContinuousBatcher,
    LoadProfile,
    SparseDNNEngine,
    VirtualClock,
    WallClock,
    generate_jobs,
)
from repro_torch.testing import faults

REF = types.SimpleNamespace(
    Profile=JProfile, generate=jgenerate, Engine=JEngine, Batcher=JBatcher,
    VirtualClock=JVirtualClock, WallClock=JWallClock, Clock=JClock, faults=jfaults,
    uniform=lambda seed, shape: jax.random.uniform(jax.random.key(seed), shape))
PORT = types.SimpleNamespace(
    Profile=LoadProfile, Engine=lambda *a, **k: SparseDNNEngine(*a, device="cpu", **k),
    generate=lambda *a, **k: generate_jobs(*a, device="cpu", **k), Batcher=ContinuousBatcher,
    VirtualClock=VirtualClock, WallClock=WallClock, Clock=Clock, faults=faults,
    uniform=lambda seed, shape: torch.from_numpy(
        np.array(jax.random.uniform(jax.random.key(seed), shape))))
SIDES = pytest.mark.parametrize("side", [REF, PORT], ids=["reference", "port"])


@pytest.fixture(autouse=True)
def _no_real_sleep(monkeypatch):
    def _boom(seconds):
        raise AssertionError(f"real time.sleep({seconds}) in a virtual-clock test")

    monkeypatch.setattr(time, "sleep", _boom)


def _bsr_stack(side, seed, L, m, bpr=2, block=16):
    ks = jax.random.split(jax.random.key(seed), L)
    ws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr) for k in ks]
    bs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    if side is REF:
        return ws, bs
    return [convert.layout(w) for w in ws], [convert.bias(b) for b in bs]


def _same_jobs(a, b):
    """Two traces (reference, port) are the same bit for bit."""
    assert [(j.rid, j.t, j.cols, j.deadline) for j in a] == [
        (j.rid, j.t, j.cols, j.deadline) for j in b]
    for ja, jb in zip(a, b):
        assert isinstance(jb.features, torch.Tensor) and jb.features.dtype == torch.float32
        np.testing.assert_array_equal(jb.features.numpy(), np.asarray(ja.features))


# ---------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------


@SIDES
def test_virtual_clock_advances_and_records(side):
    c = side.VirtualClock(start=5.0)
    assert c.now() == 5.0
    c.sleep(1.5)
    c.sleep(0.0)
    assert c.now() == 6.5
    assert c.sleeps == [1.5, 0.0]
    assert c.slept_total == 1.5
    c.advance_to(10.0)
    assert c.now() == 10.0


@SIDES
def test_virtual_clock_is_monotonic(side):
    c = side.VirtualClock()
    c.advance_to(2.0)
    with pytest.raises(ValueError):
        c.advance_to(1.0)
    with pytest.raises(ValueError):
        c.sleep(-0.1)


@SIDES
def test_clock_protocol_covers_both_implementations(side):
    assert isinstance(side.WallClock(), side.Clock)
    assert isinstance(side.VirtualClock(), side.Clock)


# ---------------------------------------------------------------------
# load profiles
# ---------------------------------------------------------------------


@SIDES
def test_constant_profile(side):
    p = side.Profile.constant(12.0)
    assert p.rate(0.0) == p.rate(99.0) == 12.0
    assert p.peak == 12.0 and p.name == "constant"
    with pytest.raises(ValueError):
        side.Profile.constant(0.0)


@SIDES
def test_diurnal_profile_trough_and_peak(side):
    p = side.Profile.diurnal(base=10.0, amplitude=20.0, period=4.0)
    assert p.peak == 30.0
    assert p.rate(1.0) == pytest.approx(30.0)
    assert p.rate(3.0) == pytest.approx(10.0)
    assert min(p.rate(t / 10) for t in range(100)) >= 10.0 - 1e-9
    assert max(p.rate(t / 10) for t in range(100)) <= 30.0 + 1e-9
    ref = JProfile.diurnal(base=10.0, amplitude=20.0, period=4.0)
    assert [p.rate(t / 7) for t in range(60)] == [ref.rate(t / 7) for t in range(60)]


@SIDES
def test_bursty_profile_windows(side):
    p = side.Profile.bursty(base=5.0, burst_rate=50.0, burst_every=10.0, burst_len=2.0)
    assert p.peak == 50.0
    assert p.rate(0.5) == 50.0
    assert p.rate(3.0) == 5.0
    assert p.rate(11.9) == 50.0
    with pytest.raises(ValueError):
        side.Profile.bursty(5.0, 4.0, 10.0, 2.0)
    with pytest.raises(ValueError):
        side.Profile.bursty(5.0, 50.0, 2.0, 10.0)


@SIDES
def test_scaled_profile(side):
    p = side.Profile.bursty(5.0, 50.0, 10.0, 2.0).scaled(2.0)
    assert p.rate(0.5) == 100.0
    assert p.rate(3.0) == 10.0
    assert p.peak == 100.0 and p.name == "burstyx2"
    with pytest.raises(ValueError):
        p.scaled(0.0)


# ---------------------------------------------------------------------
# trace generation: the same jobs as the reference, bit for bit
# ---------------------------------------------------------------------


def test_generate_jobs_deterministic():
    kw = dict(m=32, seed=11, width_mix=((2, 0.5), (8, 0.5)), deadline_s=0.25)
    a = PORT.generate(LoadProfile.constant(40.0), 2.0, **kw)
    b = PORT.generate(LoadProfile.constant(40.0), 2.0, **kw)
    assert [j.t for j in a] == [j.t for j in b]
    for ja, jb in zip(a, b):
        assert torch.equal(ja.features, jb.features)
    c = PORT.generate(LoadProfile.constant(40.0), 2.0, **{**kw, "seed": 12})
    assert [j.t for j in a] != [j.t for j in c]
    _same_jobs(jgenerate(JProfile.constant(40.0), 2.0, **kw), a)


def test_generate_jobs_shapes_and_deadlines():
    kw = dict(m=16, seed=0, width_mix=((1, 0.7), (4, 0.3)), deadline_s=0.5)
    jobs = PORT.generate(LoadProfile.constant(30.0), 3.0, **kw)
    assert jobs
    assert [j.rid for j in jobs] == list(range(len(jobs)))
    assert all(0.0 < j.t < 3.0 for j in jobs)
    assert [j.t for j in jobs] == sorted(j.t for j in jobs)
    assert {j.cols for j in jobs} <= {1, 4}
    for j in jobs:
        assert tuple(j.features.shape) == (16, j.cols)
        assert j.deadline == pytest.approx(j.t + 0.5)
    _same_jobs(jgenerate(JProfile.constant(30.0), 3.0, **kw), jobs)
    nodeadline = PORT.generate(LoadProfile.constant(30.0), 1.0, m=16, seed=0)
    assert all(j.deadline is None for j in nodeadline)
    _same_jobs(jgenerate(JProfile.constant(30.0), 1.0, m=16, seed=0), nodeadline)


@pytest.mark.parametrize("profile", ["bursty", "diurnal-scaled"])
def test_thinning_concentrates_arrivals_in_bursts(profile):
    def make(P):
        if profile == "bursty":
            return P.bursty(base=2.0, burst_rate=60.0, burst_every=5.0, burst_len=1.0)
        return P.diurnal(base=4.0, amplitude=30.0, period=3.0).scaled(1.5)

    jobs = PORT.generate(make(LoadProfile), 20.0, m=8, seed=3)
    _same_jobs(jgenerate(make(JProfile), 20.0, m=8, seed=3), jobs)
    if profile == "bursty":
        in_burst = sum(1 for j in jobs if (j.t % 5.0) < 1.0)
        assert in_burst > 3 * (len(jobs) - in_burst)


@SIDES
def test_generate_jobs_validation(side):
    with pytest.raises(ValueError):
        side.generate(side.Profile.constant(1.0), 0.0, m=8, seed=0)
    with pytest.raises(ValueError):
        side.generate(side.Profile.constant(1.0), 1.0, m=8, seed=0, width_mix=((0, 1.0),))


def test_generate_jobs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_jobs(LoadProfile.constant(5.0), 1.0, m=8, seed=0)


# ---------------------------------------------------------------------
# clock-routed stalls: backoff and stragglers under virtual time
# ---------------------------------------------------------------------


def _retry_backoff(side):
    ws, bs = _bsr_stack(side, 0, 2, 32)
    inj = side.faults.FaultInjector()
    inj.schedule(side.faults.SITE_STEP_TRANSIENT, 0, failures=2)
    clock = side.VirtualClock()
    eng = side.Engine(ws, bs, batch_align=4, fault_injector=inj, max_step_retries=2,
                      retry_backoff_s=0.1, clock=clock)
    eng.submit(side.uniform(1, (32, 2)))
    out, stats = eng.step()
    assert out is not None and not stats["failed"]
    assert stats["retries"] == 2
    assert clock.sleeps == pytest.approx([0.1, 0.2])
    return np.asarray(out), clock.sleeps


def test_engine_retry_backoff_through_virtual_clock():
    (jout, jsleeps), (out, sleeps) = _retry_backoff(REF), _retry_backoff(PORT)
    assert sleeps == jsleeps
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)


def _straggler(side):
    ws, bs = _bsr_stack(side, 1, 2, 32)
    inj = side.faults.FaultInjector()
    inj.schedule(side.faults.SITE_STRAGGLER, 0, seconds=1.25)
    clock = side.VirtualClock()
    eng = side.Engine(ws, bs, batch_align=4)
    b = side.Batcher(eng, batch_size=4, fault_injector=inj, clock=clock)
    rid = b.submit(side.uniform(2, (32,)))
    b.drain()
    s = b.stats()
    assert s.faults.straggler_ticks == 1
    assert clock.slept_total == pytest.approx(1.25)
    return np.asarray(b.result(rid)), clock.sleeps


def test_batcher_straggler_through_virtual_clock():
    (jout, jsleeps), (out, sleeps) = _straggler(REF), _straggler(PORT)
    assert sleeps == jsleeps
    np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-5)
