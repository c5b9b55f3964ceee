"""The port's mesh-sharded sparse stack against the reference's.

The reference's ``tests/test_sharded.py`` cases run on both packages with
its stacks (``jax.random`` ones, converted through numpy). The port runs
every shard from one process on one device (``make_row_blocks_mesh(S,
device="cpu")`` here, the kernels' plain versions); the reference's
in-process cases run on its one CPU device (a 1-shard mesh).

* In process: the 1-shard plan against the reference's 1-shard plan; the
  port's 8-shard plan against the reference's unsharded ``dnn_forward``
  and the dense oracle; the rule table; ``PlanKey`` carrying the mesh;
  the donor sharing the partition; one partition per distinct layer
  object; the refusals; the engine's shard stats and its ladder level,
  demoted by ``SITE_SHARD_FAILURE`` with the outputs unchanged.
* Gradients and training: the port's 8-shard gradients and 4 SGD losses
  against the reference's UNSHARDED ``dnn_value_and_grad`` and train
  step — the comparison the reference's own 8-device test makes, whose
  sharded gradient step fails in its JAX version (a ``jax.set_mesh``
  error), so the reference's sharded gradients are not a reference here.
* One subprocess with 8 host devices (``XLA_FLAGS`` set before JAX
  loads) runs the reference's ``forward8``, ``degenerate8`` and
  ``serve8`` checks on inputs this process writes to an ``.npz`` and
  writes their outputs, per-shard nnz and bills back; the port's 8-shard
  results are held to them.

Tolerances are the reference tests' own: ``rtol=atol=1e-5`` for
forwards, 1e-4 for gradients, 1e-5 for losses; integers exactly.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JPL
from repro.core import dnn as jdnn
from repro.distribution.sharding import ShardingRules as JRules
from repro.distribution.sharding import mesh_shard_count as jmesh_shard_count
from repro.distribution.sharding import row_block_axes as jrow_block_axes
from repro.launch.mesh import make_row_blocks_mesh as jmake_mesh
from repro.serve import SparseDNNEngine as JEngine
from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.sparse import partition_block_csr as jpartition
from repro.testing.faults import FaultInjector as JInjector
from repro.train.optimizer import sgd as jsgd
from repro.train.sparse import init_sparse_mlp_state as jinit_state
from repro.train.sparse import make_sparse_train_step as jmake_step
from repro_torch import convert
from repro_torch import plan as PL
from repro_torch.core import dnn
from repro_torch.data import radixnet as rx
from repro_torch.distribution.sharding import ShardingRules, mesh_shard_count, row_block_axes
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import Mesh, make_row_blocks_mesh
from repro_torch.serve import ContinuousBatcher, SparseDNNEngine
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix
from repro_torch.testing.faults import SITE_SHARD_FAILURE, FaultInjector
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import sgd
from repro_torch.train.sparse import init_sparse_mlp_state, make_sparse_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(shards):
    return make_row_blocks_mesh(shards, device="cpu")


def _jcsr_stack(seed, L, m, bpr=4, block=16):
    """The reference tests' ``_csr_stack``."""
    ks = jax.random.split(jax.random.PRNGKey(seed), L)
    ws = []
    for k in ks:
        w = JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr, minval=-0.5, maxval=0.5)
        ws.append(JBCSR.from_bsr(w.map_blocks(lambda x: x / (bpr * block) ** 0.5)))
    bs = [jnp.full((m,), 0.01 * i, jnp.float32) for i in range(L)]
    return ws, bs


def _stack(seed, L, m, **kw):
    """(reference stack, the port's conversion of it)."""
    jws, jbs = _jcsr_stack(seed, L, m, **kw)
    return (jws, jbs), ([convert.layout(w) for w in jws], [convert.bias(b) for b in jbs])


def _uniform(seed, shape):
    j = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32)
    return j, torch.from_numpy(np.array(j))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def _dense_forward(ws, bs, y):
    for w, b in zip(ws, bs):
        y = torch.relu(w.to_dense() @ y + b[:, None])
    return y


# ---------------------------------------------------------------------
# mesh and rule table
# ---------------------------------------------------------------------


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


@pytest.mark.parametrize("shape, rules, axes, count", [
    ({"row_blocks": 8}, None, ("row_blocks",), 8),
    ({"data": 4, "model": 2}, None, ("data", "model"), 8),
    ({"pod": 2}, None, (), 1),
    ({"data": 4, "model": 2}, {"tp_axis": None}, ("data",), 4),
])
def test_row_block_axes_match_reference(shape, rules, axes, count):
    mesh = _FakeMesh(shape)
    prules, jrules = (None, None) if rules is None else (ShardingRules(**rules), JRules(**rules))
    assert row_block_axes(mesh, prules) == jrow_block_axes(mesh, jrules) == axes
    assert mesh_shard_count(mesh, prules) == jmesh_shard_count(mesh, jrules) == count


def test_mesh_shape_and_refusals():
    mesh = _mesh(4)
    assert mesh.shape == {"row_blocks": 4} and mesh.size == 4
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="Queue 1 item 5"):
        Mesh(("row_blocks",), (2,), (torch.device("cpu"), torch.device("meta")))
    with pytest.raises(ValueError, match="shards"):
        make_row_blocks_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        Mesh(("row_blocks",), (3,), (torch.device("cpu"),) * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_row_blocks_mesh(2)  # entry points default to the card


# ---------------------------------------------------------------------
# plan-cache keying, donors, one partition per distinct layer
# ---------------------------------------------------------------------


def test_plan_key_carries_mesh_fingerprint():
    mesh = _mesh(1)
    fp = PL.mesh_fingerprint(mesh)
    assert fp == "row_blocks[row_blocks=1]@devices[cpu]"
    assert JPL.mesh_fingerprint(jmake_mesh(1)).startswith("row_blocks[row_blocks=1]@devices[")
    _, (ws, bs) = _stack(5, 2, 64)
    cache = PL.PlanCache(max_size=8)
    unsharded = cache.get(ws, bs, 8)
    sharded = cache.get(ws, bs, 8, mesh=mesh)
    assert unsharded is not sharded
    assert unsharded.key.mesh is None and sharded.key.mesh == fp
    assert cache.stats()["builds"] == 2
    assert cache.get(ws, bs, 8, mesh=mesh) is sharded
    assert cache.get(ws, bs, 8) is unsharded
    assert cache.stats()["hits"] == 2
    # a mesh of another shard count is another plan
    assert cache.get(ws, bs, 8, mesh=_mesh(2)) is not sharded


def test_default_cache_reset_helper():
    PL.reset_default_cache()
    cache = PL.default_cache()
    _, (ws, bs) = _stack(6, 1, 64)
    cache.get(ws, bs, 8, mesh=_mesh(2))
    assert cache.stats()["builds"] == 1
    PL.reset_default_cache()
    fresh = PL.default_cache()
    assert fresh is not cache
    assert fresh.stats() == {
        "size": 0, "max_size": 4, "lookups": 0, "hits": 0, "misses": 0,
        "builds": 0, "evictions": 0, "hit_rate": 0.0,
    }


def test_sharded_plan_donor_shares_partition_across_widths():
    (jws, _), (ws, bs) = _stack(7, 2, 64)
    cache = PL.PlanCache(max_size=8)
    p8 = cache.get(ws, bs, 8, mesh=_mesh(4), differentiable=True)
    p16 = cache.get(ws, bs, 16, mesh=_mesh(4), differentiable=True)
    assert p16.layers[0].sharded is p8.layers[0].sharded
    assert p16.layers[0].transpose is p8.layers[0].transpose
    assert p16.layers[0].shards is p8.layers[0].shards
    assert p16.grid_steps == dnn.dnn_grid_steps(ws, 16) == jdnn.dnn_grid_steps(
        jws, 16, block_n=DEFAULT_BLOCK_N)


def test_one_partition_per_distinct_layer_object(monkeypatch):
    """RadiX-net's layers share a matrix per phase: the sharded plan
    partitions each distinct matrix once and shares it across layers."""
    from repro_torch.plan import sharded as sharded_mod

    calls = []
    real = sharded_mod.partition_block_csr
    monkeypatch.setattr(sharded_mod, "partition_block_csr",
                        lambda a, n: calls.append(id(a)) or real(a, n))
    spec = rx.RadixNetSpec(1024, 8)  # two phases
    ws, bs = rx.radixnet_weights(spec, device="cpu")
    assert len({id(w) for w in ws}) == 2
    plan = PL.build_sharded_plan(ws, bs, 16, _mesh(4))
    assert len(calls) == 2
    assert plan.layers[0].sharded is plan.layers[2].sharded
    assert plan.layers[1].sharded is plan.layers[3].sharded
    assert plan.layers[0].sharded is not plan.layers[1].sharded
    assert plan.layers[0].source_layout == "ell" and plan.layers[0].kind == "bcsr"
    y = torch.from_numpy(rx.radixnet_input_panel(1024, 16, density=0.3, seed=0))
    ref_y, ref_cats = rx.radixnet_reference(spec, y.numpy())
    out = plan.forward(y)
    np.testing.assert_allclose(out.numpy(), ref_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.flatnonzero(out.numpy().max(axis=0) > 0), ref_cats)


# ---------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------


def test_sharded_plan_forward_matches_reference_one_shard():
    (jws, jbs), (ws, bs) = _stack(8, 3, 64)
    jplan = JPL.build_sharded_plan(jws, jbs, 8, jmake_mesh(1))
    plan = PL.build_sharded_plan(ws, bs, 8, _mesh(1))
    assert plan.route == PL.ROUTE_SHARDED == jplan.route
    assert plan.grid_steps == dnn.dnn_grid_steps(ws, 8) == jplan.grid_steps
    assert sum(plan.grid_steps_per_shard) == plan.grid_steps
    assert plan.kernel_launches_per_shard == jplan.pallas_calls == 3
    assert plan.kernel_launches == 3
    jy, y = _uniform(9, (64, 5))
    out = plan.forward(y)
    _close(out, jplan.forward(jy))
    _close(out, jdnn.dnn_forward(jws, jbs, jy, fused=True))
    assert plan.compile_count == 1
    plan.forward(y)
    assert plan.compile_count == 1
    with pytest.raises(ValueError, match="width"):
        plan.forward(torch.zeros((64, 9)))
    desc = plan.describe()
    assert "pallas_calls" not in desc and desc["kernel_launches_per_shard"] == 3
    assert desc["executable"] == "eager" and desc["shards"] == 1


def test_sharded_plan_8_shards_matches_unsharded_reference():
    """nnz = 16 blocks a layer, 8 | 16: the port's per-shard bills are the
    reference's (its 8-device bills, ``forward8``) and sum to the
    unsharded bill; the forward is the reference's unsharded forward and
    the dense oracle's."""
    (jws, jbs), (ws, bs) = _stack(0, 3, 64)
    plan = PL.build_sharded_plan(ws, bs, 8, _mesh(8))
    assert plan.n_shards == 8 and plan.imbalance() <= 1.10
    assert plan.shard_pad_blocks() == 0
    assert plan.kernel_launches == 24
    jy, y = _uniform(99, (64, 8))
    out = plan.forward(y)
    _close(out, jdnn.dnn_forward(jws, jbs, jy, fused=True))
    _close(out, _dense_forward(ws, bs, y).numpy(), rtol=1e-4, atol=1e-5)
    assert sum(plan.grid_steps_per_shard) == jdnn.dnn_grid_steps(jws, 8)
    ref_bills = [sum(JPL.layer_grid_steps(jpartition(w, 8).shard(s), 8) for w in jws)
                 for s in range(8)]
    assert list(plan.grid_steps_per_shard) == ref_bills


def test_rectangular_stack_gives_each_launch_its_own_rows_bias(monkeypatch):
    """Layers whose rows differ from the input's (the tune arm's skewed
    shapes): every shard launch gets a bias of its own output rows, as the
    CUDA wrapper requires, and the forward is the reference's unsharded one."""
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    jws = [JBCSR.from_bsr(JBSR.random(k, shape, (16, 16), blocks_per_row=4, minval=-0.5,
                                      maxval=0.5))
           for k, shape in zip(keys, ((128, 256), (128, 128), (64, 128)))]
    jbs = [jnp.full((w.shape[0],), 0.01 * i, jnp.float32) for i, w in enumerate(jws)]
    ws, bs = [convert.layout(w) for w in jws], [convert.bias(b) for b in jbs]
    seen = []
    real = kernel_ops.bcsr_spmm
    monkeypatch.setattr(kernel_ops, "bcsr_spmm", lambda a, y, bias=None, *args, **kw: (
        seen.append((a.shape[0], None if bias is None else tuple(bias.shape)))
        or real(a, y, bias, *args, **kw)))
    plan = PL.build_sharded_plan(ws, bs, 8, _mesh(4))
    jy, y = _uniform(5, (256, 8))
    _close(plan.forward(y), jdnn.dnn_forward(jws, jbs, jy, fused=True))
    assert len(seen) == plan.kernel_launches == 12
    assert all(bias == (rows,) for rows, bias in seen)


@pytest.mark.parametrize("shards", [3, 5])
def test_bills_when_shards_do_not_divide_nnz(shards):
    """S ∤ nnz: the reference bills every shard its padded length Tp, so
    its bills exceed the unsharded bill by the pad slots; the port bills
    valid blocks, so its bills always sum to the unsharded bill."""
    (jws, jbs), (ws, bs) = _stack(3, 2, 64)
    plan = PL.build_sharded_plan(ws, bs, 16, _mesh(shards))
    unsharded = jdnn.dnn_grid_steps(jws, 16, block_n=DEFAULT_BLOCK_N)
    assert plan.grid_steps == unsharded == dnn.dnn_grid_steps(ws, 16)
    ref = sum(JPL.layer_grid_steps(jpartition(w, shards).shard(s), 16, block_n=DEFAULT_BLOCK_N)
              for w in jws for s in range(shards))
    assert plan.shard_pad_blocks() > 0
    assert ref == unsharded + plan.shard_pad_blocks()  # one 16-column tile
    nnz = [sum(int(n) for n in jpartition(w, shards).nnz_per_shard()) for w in jws]
    assert sum(plan.nnz_per_shard()) == sum(nnz)


def test_dnn_forward_mesh_and_grid_steps():
    (jws, jbs), (ws, bs) = _stack(4, 3, 64)
    jy, y = _uniform(10, (64, 7))
    PL.reset_default_cache()
    want = jdnn.dnn_forward(jws, jbs, jy, fused=True)
    _close(dnn.dnn_forward(ws, bs, y, mesh=_mesh(4)), want)
    _close(dnn.dnn_forward_resident(ws, bs, y, mesh=_mesh(4)), want)
    (plan,) = PL.default_cache().plans()  # one mesh, one width: one plan
    assert plan.route == PL.ROUTE_SHARDED and plan.calls == 2
    assert dnn.dnn_grid_steps(ws, 7) == jdnn.dnn_grid_steps(jws, 7, block_n=DEFAULT_BLOCK_N)
    PL.reset_default_cache()


def test_sharded_plan_rejects_resident_and_ell_differentiable():
    _, (ws, bs) = _stack(10, 1, 64)
    with pytest.raises(ValueError, match="use_resident"):
        PL.build_sharded_plan(ws, bs, 8, _mesh(1), use_resident=True)
    jell = JBSR.random(jax.random.PRNGKey(0), (64, 64), (16, 16), blocks_per_row=2)
    ell = [convert.layout(jell)]
    with pytest.raises(ValueError, match="block-CSR"):
        PL.build_sharded_plan(ell, bs, 8, _mesh(1), differentiable=True)
    plan = PL.build_sharded_plan(ell, bs, 8, _mesh(2))
    assert plan.layers[0].source_layout == "ell" and plan.layers[0].kind == "bcsr"
    jy, y = _uniform(1, (64, 8))
    _close(plan.forward(y), jdnn.dnn_forward([jell], [jnp.asarray(bs[0].numpy())], jy))
    with pytest.raises(ValueError, match="single-device"):
        PL.PlanCache().get(ws, bs, 8, mesh=_mesh(2), tuned=object())
    on_meta = [convert.layout(JBCSR.from_bsr(jell), device="meta")]
    with pytest.raises(ValueError, match="mesh"):
        PL.build_sharded_plan(on_meta, bs, 8, _mesh(2))


def test_dense_layer_runs_once_and_bills_once():
    """A dense layer in a sharded stack is computed once (not per shard)
    and billed once, on the first shard."""
    (jws, jbs), (ws, bs) = _stack(2, 2, 64)
    jdense = jws[1].to_dense()
    dws = [ws[0], torch.from_numpy(np.array(jdense))]
    plan = PL.build_sharded_plan(dws, bs, 8, _mesh(4))
    assert [lp.kind for lp in plan.layers] == ["bcsr", "dense"]
    assert plan.kernel_launches == 4 + 1
    dense_bill = dnn.dnn_grid_steps(dws[1:], 8)
    assert plan.layers[1].grid_steps_per_shard == (dense_bill, 0, 0, 0)
    assert plan.grid_steps == dnn.dnn_grid_steps(dws, 8)
    jy, y = _uniform(3, (64, 8))
    _close(plan.forward(y), jdnn.dnn_forward([jws[0], jdense], jbs, jy, fused=True))


# ---------------------------------------------------------------------
# serving: engine, batcher, ladder
# ---------------------------------------------------------------------


def test_engine_mesh_rejects_resident_and_reports_shards():
    (jws, jbs), (ws, bs) = _stack(11, 2, 64)
    with pytest.raises(ValueError, match="mesh"):
        SparseDNNEngine(ws, bs, use_resident=True, mesh=_mesh(1))
    with pytest.raises(ValueError, match="mesh"):
        SparseDNNEngine(ws, bs, mesh=_mesh(1), device="meta")
    jy, y = _uniform(12, (64, 5))
    ref = JEngine(jws, jbs, batch_align=8).infer(jy)[0]
    jout, jstats = JEngine(jws, jbs, batch_align=8, mesh=jmake_mesh(1)).infer(jy)
    for shards in (1, 8):
        eng = SparseDNNEngine(ws, bs, batch_align=8, mesh=_mesh(shards))
        assert eng.device == torch.device("cpu")
        out, stats = eng.infer(y)
        assert stats["plan"]["route"] == PL.ROUTE_SHARDED == jstats["plan"]["route"]
        assert stats["plan"]["level"] == "sharded" == jstats["plan"]["level"]
        assert stats["plan"]["shards"] == shards
        assert sum(stats["plan"]["grid_steps_per_shard"]) == stats["grid_steps"]
        assert stats["grid_steps"] == jstats["grid_steps"]  # 8 columns: one tile in both
        assert stats["kernel_launches"] == shards * jstats["pallas_calls"]
        _close(out, ref)
        _close(out, jout)


def test_batcher_serves_over_a_mesh_engine():
    (jws, jbs), (ws, bs) = _stack(0, 3, 64)
    eng = SparseDNNEngine(ws, bs, batch_align=8, mesh=_mesh(8))
    b = ContinuousBatcher(eng, batch_size=16, min_fill=0.0, width_classes=(8, 16))
    cols = {}
    for i in range(5):
        for j in range(1 + i % 3):
            jcol, col = _uniform(200 + 10 * i + j, (64,))
            cols[b.submit(col)] = jcol
        b.step(force=True)
    b.drain()
    for rid, jcol in cols.items():
        _close(b.result(rid), jdnn.dnn_forward(jws, jbs, jcol[:, None], fused=True)[:, 0])
    assert {r.plan_level for r in b.stats().steps} == {"sharded"}


def test_shard_failure_demotes_the_ladder_like_the_reference():
    """SITE_SHARD_FAILURE at dispatch 1 marks ``sharded`` unhealthy: that
    panel and the next serve from ``layered`` with the same outputs, and
    the demotion is an event, as in the reference engine."""
    (jws, jbs), (ws, bs) = _stack(13, 2, 64)
    jinj, inj = JInjector(), FaultInjector()
    for i in (jinj, inj):
        i.schedule(SITE_SHARD_FAILURE, 1, reason="shard 3 lost")
    jeng = JEngine(jws, jbs, batch_align=8, mesh=jmake_mesh(1), fault_injector=jinj)
    eng = SparseDNNEngine(ws, bs, batch_align=8, mesh=_mesh(4), fault_injector=inj)
    levels, jlevels = [], []
    for k in range(3):
        jy, y = _uniform(30 + k, (64, 4))
        out, stats = eng.infer(y)
        jout, jstats = jeng.infer(jy)
        levels.append((stats["plan"]["level"], stats["plan"]["route"], stats["plan"]["degraded"]))
        jlevels.append((jstats["plan"]["level"], jstats["plan"]["route"],
                        jstats["plan"]["degraded"]))
        _close(out, jout)
        _close(out, jdnn.dnn_forward(jws, jbs, jy, fused=True))
    assert levels == jlevels == [("sharded", "sharded", False), ("layered", "layered", True),
                                 ("layered", "layered", True)]
    assert [(e.level, e.healthy, e.reason, e.step) for e in eng.ladder.events] == [
        (e.level, e.healthy, e.reason, e.step) for e in jeng.ladder.events] == [
        ("sharded", False, "shard 3 lost", 1)]
    assert eng.ladder.describe()["health"] == {"sharded": False, "resident": True}
    eng.ladder.restore("sharded")
    assert eng.infer(_uniform(40, (64, 4))[1])[1]["plan"]["level"] == "sharded"


def test_challenge_over_a_mesh():
    from repro_torch.serve import run_challenge

    spec = rx.RadixNetSpec(1024, 4)
    res = run_challenge(spec, n_inputs=64, panel_width=32, mesh=_mesh(4), warmup=False)
    assert res.routes == ("sharded",) and res.levels == ("sharded",)
    panel = rx.radixnet_input_panel(1024, 64, density=0.3, seed=0)
    np.testing.assert_array_equal(res.categories, rx.radixnet_reference(spec, panel)[1])
    ws, _ = rx.radixnet_weights(spec, device="cpu")
    assert res.grid_steps == 2 * dnn.dnn_grid_steps(
        [BlockCSRMatrix.from_bsr(w) for w in ws], 32)


# ---------------------------------------------------------------------
# gradients and training, against the reference's UNSHARDED step
# ---------------------------------------------------------------------


def test_sharded_gradients_match_unsharded_reference():
    (jws, jbs), (ws, bs) = _stack(0, 3, 64)
    jy, y = _uniform(99, (64, 8))
    jtargets = jdnn.dnn_forward(jws, jbs, jy, fused=True) * 0.5
    targets = torch.from_numpy(np.array(jtargets))
    dplan = PL.build_sharded_plan(ws, bs, 8, _mesh(8), differentiable=True)
    assert dplan.describe()["executable"] == "eager"
    l1, (dw1, db1) = dnn.dnn_value_and_grad(ws, bs, y, targets, plan=dplan)
    l2, (dw2, db2) = jdnn.dnn_value_and_grad(jws, jbs, jy, jtargets)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(dw1, dw2):
        assert isinstance(a, BlockCSRMatrix) and a.row_ptr is not None
        np.testing.assert_allclose(a.values.numpy(), np.asarray(b.values), rtol=1e-4,
                                   atol=1e-7)
    for a, b in zip(db1, db2):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-7)
    # the plan's unsharded plain path gives the same gradients
    l3, (dw3, _) = dnn.dnn_value_and_grad(ws, bs, y, targets, plan=dplan, use_kernel=False)
    np.testing.assert_allclose(float(l3), float(l2), rtol=1e-5)
    with pytest.raises(ValueError, match="differentiable"):
        PL.build_sharded_plan(ws, bs, 8, _mesh(8)).forward_trainable(ws, bs, y)


def test_sharded_train_steps_match_unsharded_reference(tmp_path):
    (jws, jbs), (ws, bs) = _stack(0, 3, 64)
    jy, y = _uniform(99, (64, 8))
    jtargets = jdnn.dnn_forward(jws, jbs, jy, fused=True) * 0.5
    targets = torch.from_numpy(np.array(jtargets))
    dplan = PL.build_sharded_plan(ws, bs, 8, _mesh(8), differentiable=True)
    step = make_sparse_train_step(sgd(0.5, momentum=0.0), plan=dplan)
    jstep = jax.jit(jmake_step(jsgd(0.5, momentum=0.0), use_kernel=True))
    st = init_sparse_mlp_state(ws, bs, sgd(0.5, momentum=0.0))
    jst = jinit_state(jws, jbs, jsgd(0.5, momentum=0.0))
    losses, jlosses = [], []
    for _ in range(4):
        st, m = step(st, {"y0": y, "targets": targets})
        jst, jm = jstep(jst, {"y0": jy, "targets": jtargets})
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    # the state restores onto the devices ``shardings`` names: a tree of
    # the state's structure with device leaves
    checkpoint.save(str(tmp_path), 4, st)
    shardings = checkpoint._map_leaves(lambda key, leaf: torch.device("cpu"), st)
    back, manifest = checkpoint.restore(str(tmp_path), st, shardings=shardings)
    assert manifest["step"] == 4
    for a, b in zip(back.weights, st.weights):
        assert torch.equal(a.values, b.values) and a.values.device.type == "cpu"
    for a, b in zip(back.opt.mu, st.opt.mu):
        assert torch.equal(a, b)


def test_checkpoint_restore_with_a_tree_of_devices(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": (torch.ones(2), torch.zeros(3))}
    checkpoint.save(str(tmp_path), 1, tree)
    places = {"w": torch.device("cpu"), "b": (torch.device("cpu"), torch.device("cpu"))}
    back, _ = checkpoint.restore(str(tmp_path), tree, shardings=places)
    assert torch.equal(back["w"], tree["w"]) and torch.equal(back["b"][1], tree["b"][1])
    with pytest.raises(RuntimeError):  # not a device
        checkpoint.restore(str(tmp_path), tree, shardings={"w": "nowhere", "b": ("cpu", "cpu")})


# ---------------------------------------------------------------------
# the reference's own 8-device run, in a subprocess
# ---------------------------------------------------------------------

_FIELDS = ("values", "row_ptr", "row_id", "col_idx", "valid")

_REFERENCE_8 = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    jax.config.update("jax_default_matmul_precision", "highest")
    from repro.launch.mesh import make_row_blocks_mesh
    from repro.plan import build_sharded_plan
    from repro.serve import ContinuousBatcher, SparseDNNEngine
    from repro.sparse import BlockCSRMatrix

    assert len(jax.devices()) >= 8, jax.devices()
    d = np.load(sys.argv[1])
    fields = ("values", "row_ptr", "row_id", "col_idx", "valid")

    def csr(p):
        return BlockCSRMatrix(*(jnp.asarray(d[f"{p}_{f}"]) for f in fields),
                              tuple(int(x) for x in d[f"{p}_shape"]),
                              tuple(int(x) for x in d[f"{p}_block"]))

    L = int(d["layers"])
    ws = [csr(f"w{i}") for i in range(L)]
    bs = [jnp.asarray(d[f"b{i}"]) for i in range(L)]
    mesh = make_row_blocks_mesh(8)
    out = {}

    plan = build_sharded_plan(ws, bs, 8, mesh)
    out["forward8"] = np.asarray(plan.forward(jnp.asarray(d["y0"])))
    out["forward8_nnz"] = np.asarray(plan.nnz_per_shard())
    out["forward8_bills"] = np.asarray(plan.grid_steps_per_shard)
    out["forward8_imbalance"] = np.asarray(plan.imbalance())

    tiny = [csr("tiny")]
    tb = [jnp.zeros((tiny[0].shape[0],), jnp.float32)]
    tp = build_sharded_plan(tiny, tb, 8, mesh)
    out["degenerate8"] = np.asarray(tp.forward(jnp.asarray(d["y0"])))
    out["degenerate8_nnz"] = np.asarray(tp.layers[0].sharded.nnz_per_shard())
    out["degenerate8_bills"] = np.asarray(tp.grid_steps_per_shard)

    e1 = SparseDNNEngine(ws, bs, batch_align=8, mesh=mesh)
    for k in (3, 8, 5):
        o, s = e1.infer(jnp.asarray(d[f"serve_{k}"]))
        out[f"serve8_{k}"] = np.asarray(o)
        out[f"serve8_{k}_bills"] = np.asarray(s["plan"]["grid_steps_per_shard"])
    b = ContinuousBatcher(e1, batch_size=16, min_fill=0.0, width_classes=(8, 16))
    rids, c = [], 0
    for i in range(5):
        for j in range(1 + i % 3):
            rids.append(b.submit(jnp.asarray(d["cols"][c])))
            c += 1
        b.step(force=True)
    b.drain()
    out["serve8_batcher"] = np.stack([np.asarray(b.result(r)) for r in rids], axis=1)
    np.savez(sys.argv[2], **out)
    print("reference8 OK")
    """
)


def _save_csr(arrays, prefix, w):
    for f in _FIELDS:
        arrays[f"{prefix}_{f}"] = np.asarray(getattr(w, f))
    arrays[f"{prefix}_shape"] = np.asarray(w.shape)
    arrays[f"{prefix}_block"] = np.asarray(w.block_shape)


def test_eight_shards_match_the_reference_eight_device_run(tmp_path):
    m = 64
    (jws, jbs), (ws, bs) = _stack(0, 3, m)  # nnz 16 blocks a layer: 8 | 16
    jtiny = JBCSR.from_dense(jnp.zeros((m, m)).at[:16, :32].set(0.25), (16, 16))
    rng = np.random.default_rng(19)
    arrays = {"layers": np.asarray(len(jws)),
              "y0": rng.random((m, 8), dtype=np.float32),
              "cols": rng.random((10, m), dtype=np.float32),
              **{f"serve_{k}": rng.random((m, k), dtype=np.float32) for k in (3, 8, 5)}}
    for i, (w, b) in enumerate(zip(jws, jbs)):
        _save_csr(arrays, f"w{i}", w)
        arrays[f"b{i}"] = np.asarray(b)
    _save_csr(arrays, "tiny", jtiny)
    src, dst = tmp_path / "inputs.npz", tmp_path / "reference8.npz"
    np.savez(src, **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REFERENCE_8, str(src), str(dst)],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0 and "reference8 OK" in r.stdout, r.stderr[-3000:]
    ref = np.load(dst)

    mesh = _mesh(8)
    y0 = torch.from_numpy(arrays["y0"])
    plan = PL.build_sharded_plan(ws, bs, 8, mesh)
    _close(plan.forward(y0), ref["forward8"])
    np.testing.assert_array_equal(plan.nnz_per_shard(), ref["forward8_nnz"])
    np.testing.assert_array_equal(plan.grid_steps_per_shard, ref["forward8_bills"])
    assert plan.imbalance() == float(ref["forward8_imbalance"])

    tiny = [convert.layout(jtiny)]
    tplan = PL.build_sharded_plan(tiny, [torch.zeros(m)], 8, mesh)
    _close(tplan.forward(y0), ref["degenerate8"])
    nnz = np.asarray(tplan.layers[0].nnz_per_shard)
    np.testing.assert_array_equal(nnz, ref["degenerate8_nnz"])
    assert (nnz == 0).sum() == 6
    # the reference bills each shard its padded length (1 slot); the port
    # bills valid blocks: the empty shards cost nothing
    np.testing.assert_array_equal(ref["degenerate8_bills"], np.ones(8, int))
    np.testing.assert_array_equal(tplan.grid_steps_per_shard, nnz)
    for local in tplan.layers[0].shards[2:]:  # an empty shard's launch is exact zeros
        assert not bool(kernel_ops.bcsr_spmm(local, y0).any())

    eng = SparseDNNEngine(ws, bs, batch_align=8, mesh=mesh)
    for k in (3, 8, 5):
        out, stats = eng.infer(torch.from_numpy(arrays[f"serve_{k}"]))
        _close(out, ref[f"serve8_{k}"])
        np.testing.assert_array_equal(stats["plan"]["grid_steps_per_shard"],
                                      ref[f"serve8_{k}_bills"])
    b = ContinuousBatcher(eng, batch_size=16, min_fill=0.0, width_classes=(8, 16))
    rids, c = [], 0
    for i in range(5):
        for j in range(1 + i % 3):
            rids.append(b.submit(torch.from_numpy(arrays["cols"][c])))
            c += 1
        b.step(force=True)
    b.drain()
    _close(torch.stack([b.result(r) for r in rids], dim=1), ref["serve8_batcher"])
