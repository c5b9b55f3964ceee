"""The port's autotuner (``repro_torch.tune``) against the reference's.

Every case of the reference's ``tests/test_tune.py`` runs on both
packages with the same stacks (``jax.random`` ones converted through
numpy): the same tokens, table round trips and refusals, and the same
winners on the reference's stacks; bills are compared at the port's
16-column tile. The reference's ``test_mesh_plus_tuned_rejected`` has no
counterpart yet: the port's plan cache takes no mesh (ROADMAP Queue 1
item 5), which its case here pins. Then the file format both ways (the
committed ``BENCH_tuning_table.json`` read by both, a table the port
saved read by the reference), and what the port refuses by design: a
``block_n`` outside the wrappers' column tiles, a shared-memory budget
above the card's, and a JAX backend key.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as JP
from repro.serve import SparseDNNEngine as JEngine
from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.tune import SCHEMA_VERSION as JSCHEMA
from repro.tune import TunedConfig as JTuned
from repro.tune import TuningTable as JTable
from repro.tune import default_candidates as jdefault_candidates
from repro.tune import sweep_stack as jsweep_stack
from repro.tune import tune_stack as jtune_stack
from repro_torch import convert
from repro_torch import plan as P
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES, fused_mlp_smem_bytes
from repro_torch.serve import SparseDNNEngine
from repro_torch.tune import (
    SCHEMA_VERSION,
    TunedConfig,
    TuningTable,
    TuningTableError,
    default_candidates,
    entry_key,
    sweep_stack,
    tune_stack,
)
from repro_torch.tune.table import default_backend

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _square_stack(key, L=3, m=64, bpr=2, block=16):
    """The reference's ``_square_stack`` and its port."""
    jws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr)
           for k in jax.random.split(key, L)]
    jbs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    return (jws, jbs), ([convert.layout(w) for w in jws], [convert.bias(b) for b in jbs])


def _skewed_stack():
    """The reference's rectangular skewed stack whose ELL waste stays under
    the relayout threshold, and its port."""
    specs = [((128, 256), 100), ((128, 128), 55), ((64, 128), 28)]
    jws = []
    for i, (shape, tb) in enumerate(specs):
        w = JBCSR.random_skewed(i, shape, (16, 16), tb, skew=0.3).to_bsr()
        nrb, mbpr = w.col_idx.shape
        assert 1 - tb / (nrb * mbpr) < P.ELL_WASTE_THRESHOLD
        assert nrb * mbpr > tb
        jws.append(w)
    jbs = [jnp.zeros((s[0],), jnp.float32) for s, _ in specs]
    return (jws, jbs), ([convert.layout(w) for w in jws], [convert.bias(b) for b in jbs])


def _normal(seed, shape):
    j = jax.random.normal(jax.random.PRNGKey(seed), shape)
    return j, torch.from_numpy(np.array(j))


def _port_bill(jweights, width, block_n=16):
    """The reference's bill of its plan's executed weights at the port's tile."""
    return JP.stack_grid_steps(jweights, width, block_n=block_n)


# ---------------------------------------------------------------- table


def test_default_token():
    for cfg in (TunedConfig(), JTuned()):
        assert cfg.token() == "default" and cfg.is_default


def test_token_deterministic_and_distinct():
    for cls in (TunedConfig, JTuned):
        a = cls(block_n=64, panel_dtype="bfloat16")
        b = cls(block_n=64, panel_dtype="bfloat16")
        c = cls(block_n=64)
        assert a.token() == b.token() and a.token() != c.token()
    assert TunedConfig(block_n=64, panel_dtype="bfloat16").token() == JTuned(
        block_n=64, panel_dtype="bfloat16").token()


def test_panel_dtype_normalized():
    assert TunedConfig(panel_dtype=torch.bfloat16).token() == TunedConfig(
        panel_dtype="bfloat16").token() == JTuned(panel_dtype=jnp.bfloat16).token()
    assert TunedConfig(panel_dtype=np.float32).token() == JTuned(panel_dtype=np.float32).token()


def test_bad_layout_rejected():
    for cls in (TunedConfig, JTuned):
        with pytest.raises(ValueError, match="layout"):
            cls(layout="csc")


def test_dict_round_trip():
    cfg = TunedConfig(block_size=32, layout="bcsr")
    assert TunedConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.to_dict() == JTuned(block_size=32, layout="bcsr").to_dict()
    full = dict(block_size=32, block_n=8, layout="ell", panel_dtype="bfloat16",
                vmem_limit_bytes=1 << 17)
    assert TunedConfig(**full).token() == JTuned(**full).token()
    assert JTuned.from_dict(TunedConfig(**full).to_dict()) == JTuned(**full)


def test_unknown_knob_rejected():
    for cls, err in ((TunedConfig, TuningTableError), (JTuned, ValueError)):
        with pytest.raises(err, match="unknown"):
            cls.from_dict({"warp_size": 32})


def test_round_trip(tmp_path):
    cfg = TunedConfig(panel_dtype="bfloat16", block_n=64)
    table = TuningTable()
    table.put("fp1", "cpu", "float32", cfg, {"grid_steps": 7})
    path = tmp_path / "table.json"
    table.save(path)
    loaded = TuningTable.load(path)
    assert loaded.lookup("fp1", backend="cpu") == cfg
    assert loaded.record("fp1", backend="cpu")["grid_steps"] == 7
    # the same file as the reference's for the same table
    jtable = JTable()
    jtable.put("fp1", "cpu", "float32", JTuned(panel_dtype="bfloat16", block_n=64),
               {"grid_steps": 7})
    jtable.save(tmp_path / "jtable.json")
    assert (tmp_path / "jtable.json").read_text() == path.read_text()


def test_fingerprint_isolation():
    table = TuningTable()
    table.put("fpA", "cpu", "float32", TunedConfig(block_n=64))
    assert table.lookup("fpB", backend="cpu") is None
    assert table.lookup("fpA", backend="tpu") is None
    assert table.lookup("fpA", backend="cpu", dtype="bfloat16") is None
    assert table.lookup("fpA", backend="cpu") == TunedConfig(block_n=64)


def test_schema_version_rejected(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"schema_version": SCHEMA_VERSION + 1, "entries": {}}))
    assert SCHEMA_VERSION == JSCHEMA == 1
    for cls in (TuningTable, JTable):
        with pytest.raises(ValueError, match="schema_version"):
            cls.load(path)


@pytest.mark.parametrize("text, match", [
    ("{not json", "cannot read"),
    ("[]", "root"),
    (json.dumps({"schema_version": 1}), "entries"),
    (json.dumps({"schema_version": 1, "entries": {"k": 3}}), "config"),
    (json.dumps({"schema_version": 1, "entries": {"k": {"config": {"warp_size": 4}}}}),
     "unknown"),
])
def test_corrupt_rejected(tmp_path, text, match):
    """``load`` refuses exactly what the reference's refuses."""
    path = tmp_path / "bad.json"
    path.write_text(text)
    for cls in (TuningTable, JTable):
        with pytest.raises(ValueError, match=match):
            cls.load(path)
    with pytest.raises(TuningTableError):
        TuningTable.load(path)


# ---------------------------------------------------------------- sweep


def test_default_candidate_enumerated_first():
    for fn in (default_candidates, jdefault_candidates):
        cands = fn()
        assert cands[0].is_default
        tokens = [c.token() for c in cands]
        assert len(tokens) == len(set(tokens))
    grid = dict(block_ns=(None, 8), vmem_limits=(None, 4096))
    assert [c.token() for c in default_candidates(**grid)] == [
        c.token() for c in jdefault_candidates(**grid)]


def test_bcsr_forcing_wins_on_skewed_stack():
    (jws, jbs), (ws, bs) = _skewed_stack()
    jwinner, jrecords = jsweep_stack(jws, jbs, 64, time_forwards=False)
    winner, records = sweep_stack(ws, bs, 64, time_forwards=False, device="cpu")
    assert winner.layout == "bcsr" and winner.token() == jwinner.token()
    by_token = {r["token"]: r for r in records}
    assert by_token["layout=bcsr"]["grid_steps"] < by_token["default"]["grid_steps"]
    assert sum(r.get("selected", False) for r in records) == 1
    assert [r["token"] for r in records] == [r["token"] for r in jrecords]
    # the bills are the reference's at the port's 16-column tile
    for tok in ("default", "layout=bcsr"):
        jplan = JP.build_plan(jws, jbs, 64, tuned=JTuned.from_dict(by_token[tok]["config"]))
        assert by_token[tok]["grid_steps"] == _port_bill(jplan.weights, 64)
        assert by_token[tok]["block_work"] == JP.stack_block_work(jplan.weights, 64,
                                                                  block_n=16)


def test_sweep_is_deterministic():
    _, (ws, bs) = _skewed_stack()
    w1, r1 = sweep_stack(ws, bs, 64, time_forwards=False, device="cpu")
    w2, r2 = sweep_stack(ws, bs, 64, time_forwards=False, device="cpu")
    assert w1 == w2
    assert [r["token"] for r in r1] == [r["token"] for r in r2]


def test_accuracy_gate_rejects():
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(0))
    for winner, records in (
            jsweep_stack(jws, jbs, 32, time_forwards=False, accuracy_rtol=0.0),
            sweep_stack(ws, bs, 32, time_forwards=False, accuracy_rtol=0.0, device="cpu")):
        assert winner.panel_dtype is None
        bf16 = [r for r in records if "bfloat16" in r["token"]]
        assert bf16 and all(not r["ok"] for r in bf16)


def test_tune_stack_evidence():
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(1))
    jwinner, _ = jtune_stack(jws, jbs, 32, time_forwards=False)
    winner, table = tune_stack(ws, bs, 32, time_forwards=False, device="cpu")
    assert winner.token() == jwinner.token()
    fp = P.topology_fingerprint(ws)
    rec = table.record(fp, backend="cpu")
    assert rec is not None and list(table.entries) == [entry_key(fp, "cpu", "float32")]
    assert rec["grid_steps"] <= rec["default_grid_steps"]
    assert rec["config"] == winner.to_dict()
    assert table.lookup(fp, backend="cpu") == winner


# ----------------------------------------------------- plan integration


def test_plan_cache_tuned_untuned_non_collision():
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(2))
    tuned = TunedConfig(panel_dtype="bfloat16")
    for cache, w, b, cfg in ((JP.PlanCache(), jws, jbs, JTuned(panel_dtype="bfloat16")),
                             (P.PlanCache(), ws, bs, tuned)):
        p_default = cache.get(w, b, 32)
        p_tuned = cache.get(w, b, 32, tuned=cfg)
        assert p_default is not p_tuned and p_default.key != p_tuned.key
        assert p_default.key.tuned is None and p_tuned.key.tuned == tuned.token()
        builds = cache.stats()["builds"]
        assert cache.get(w, b, 32) is p_default
        assert cache.get(w, b, 32, tuned=cfg) is p_tuned
        assert cache.stats()["builds"] == builds


def test_mesh_plus_tuned_rejected():
    """The reference refuses a mesh with a tuned config; the port's cache
    takes no mesh at all yet (ROADMAP Queue 1 item 5)."""
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(3))
    with pytest.raises(ValueError, match="single-device"):
        JP.PlanCache().get(jws, jbs, 32, mesh=object(), tuned=JTuned(block_n=64))
    with pytest.raises(TypeError, match="mesh"):
        P.PlanCache().get(ws, bs, 32, mesh=object(), tuned=TunedConfig(block_n=8))


def test_tuned_plan_outputs_match():
    (jws, jbs), (ws, bs) = _skewed_stack()
    jx, x = _normal(4, (256, 32))
    p0 = P.build_plan(ws, bs, 32)
    p1 = P.build_plan(ws, bs, 32, tuned=TunedConfig(layout="bcsr"))
    j1 = JP.build_plan(jws, jbs, 32, tuned=JTuned(layout="bcsr"))
    assert p1.layouts == j1.layouts == ("bcsr", "bcsr", "bcsr")
    np.testing.assert_allclose(p1.forward(x).numpy(), p0.forward(x).numpy(), rtol=1e-6)
    np.testing.assert_allclose(p1.forward(x).numpy(), np.asarray(j1.forward(jx)),
                               rtol=1e-5, atol=1e-5)


def test_reblocked_plan_outputs_match():
    (jws, jbs), (ws, bs) = _skewed_stack()
    jx, x = _normal(5, (256, 32))
    p0 = P.build_plan(ws, bs, 32)
    p1 = P.build_plan(ws, bs, 32, tuned=TunedConfig(block_size=32))
    j1 = JP.build_plan(jws, jbs, 32, tuned=JTuned(block_size=32))
    assert all(w.block_shape == (32, 32) for w in p1.weights)
    assert p1.layouts == j1.layouts
    np.testing.assert_allclose(p1.forward(x).numpy(), p0.forward(x).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p1.forward(x).numpy(), np.asarray(j1.forward(jx)),
                               rtol=1e-4, atol=1e-4)
    # a re-blocked candidate does not win by coarsening the grid
    assert P.stack_block_work(p1.weights, 32) >= P.stack_block_work(
        P.build_plan(ws, bs, 32, tuned=TunedConfig(layout="bcsr")).weights, 32)


def test_bf16_moves_resident_boundary_at_plan_layer():
    """The reference's case at the port's budget: a shared-memory budget
    under the f32 resident panel but over the bf16 one flips the route as
    bf16 panels do at the boundary (3424 neurons, ``test_torch_plan.py``)."""
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(6), m=64)
    limit = fused_mlp_smem_bytes(64) - 1
    assert fused_mlp_smem_bytes(64, "bfloat16") <= limit
    p_f32 = P.build_plan(ws, bs, 32, tuned=TunedConfig(vmem_limit_bytes=limit))
    p_bf16 = P.build_plan(ws, bs, 32, tuned=TunedConfig(vmem_limit_bytes=limit,
                                                         panel_dtype="bfloat16"))
    assert p_f32.route == P.ROUTE_FUSED_TILED and p_bf16.route == P.ROUTE_FUSED
    assert P.fused_route(ws, smem_limit=limit) == P.ROUTE_FUSED_TILED
    assert P.resident_eligible(ws, panel_dtype="bfloat16", smem_limit=limit)


# --------------------------------------------------- engine integration


def test_engine_consults_table():
    (jws, jbs), (ws, bs) = _square_stack(jax.random.PRNGKey(7))
    _, jtable = jtune_stack(jws, jbs, 64, time_forwards=False)
    _, table = tune_stack(ws, bs, 64, time_forwards=False, device="cpu")
    eng = SparseDNNEngine(ws, bs, batch_align=32, tuning_table=table, device="cpu")
    jeng = JEngine(jws, jbs, batch_align=32, tuning_table=jtable)
    assert eng.tuned == table.lookup(P.topology_fingerprint(ws), backend="cpu")
    assert eng.tuned.token() == jeng.tuned.token()
    jx, x = _normal(8, (64, 20))
    out, stats = eng.infer(x)
    assert stats["plan"]["tuned"] == eng.tuned.token()
    ref, ref_stats = SparseDNNEngine(ws, bs, batch_align=32, device="cpu").infer(x)
    assert ref_stats["plan"]["tuned"] is None
    jout, _ = jeng.infer(jx)
    for want in (ref.numpy(), np.asarray(jout, np.float32)):
        np.testing.assert_allclose(out.numpy(), want,
                                   atol=0.02 * float(np.max(np.abs(want))) + 1e-6)


def test_engine_table_miss_serves_defaults():
    _, (ws, bs) = _square_stack(jax.random.PRNGKey(9))
    eng = SparseDNNEngine(ws, bs, batch_align=32, tuning_table=TuningTable(), device="cpu")
    assert eng.tuned is None
    _, stats = eng.infer(torch.ones((64, 4)))
    assert stats["plan"]["tuned"] is None


def test_engine_panel_dtype_override():
    _, (ws, bs) = _square_stack(jax.random.PRNGKey(10))
    table = TuningTable()
    table.put(P.topology_fingerprint(ws), "cpu", "float32", TunedConfig(block_n=8))
    for tt, token in ((None, "panel_dtype=bfloat16"),
                      (table, "block_n=8,panel_dtype=bfloat16")):
        eng = SparseDNNEngine(ws, bs, batch_align=32, panel_dtype="bfloat16",
                              tuning_table=tt, device="cpu")
        assert eng.tuned.panel_dtype == "bfloat16"
        _, stats = eng.infer(torch.ones((64, 4)))
        assert stats["plan"]["tuned"] == token


# ------------------------------------------------- the file both ways


def test_both_packages_read_the_committed_table():
    """The committed ``BENCH_tuning_table.json`` (read-only here): the
    port's ``load`` gives the reference's configs, entry by entry."""
    path = ROOT / "BENCH_tuning_table.json"
    mine, theirs = TuningTable.load(path), JTable.load(path)
    assert mine.entries.keys() == theirs.entries.keys() and len(mine) >= 1
    for key in mine.entries:
        fp, backend, dtype = key.split(":")
        assert mine.lookup(fp, backend=backend, dtype=dtype).to_dict() == (
            theirs.lookup(fp, backend=backend, dtype=dtype).to_dict())
        assert mine.record(fp, backend=backend, dtype=dtype) == theirs.record(
            fp, backend=backend, dtype=dtype)


def test_the_reference_reads_a_table_the_port_tuned(tmp_path):
    _, (ws, bs) = _skewed_stack()
    winner, table = tune_stack(ws, bs, 64, time_forwards=False, device="cpu")
    path = tmp_path / "port.json"
    table.save(path)
    theirs = JTable.load(path)
    fp = P.topology_fingerprint(ws)
    assert theirs.lookup(fp, backend="cpu").to_dict() == winner.to_dict() == {"layout": "bcsr"}
    assert theirs.record(fp, backend="cpu") == table.record(fp, backend="cpu")


# ------------------------------------------- what the port refuses by design


@pytest.mark.parametrize("block_n", [4, 32, 64, 128])
def test_block_n_outside_the_wrappers_tiles_is_refused(block_n):
    """``block_n`` on the port is the column tile the wrappers pad to and
    bill in, 8 or 16; another cannot be honoured, on any route, and the
    sweep records it as an error (the reference records a knob
    combination its builder refuses the same way)."""
    (_, _), (ws, bs) = _square_stack(jax.random.PRNGKey(11))
    _, (sws, sbs) = _skewed_stack()
    for w, b in ((ws, bs), (sws, sbs)):
        with pytest.raises(ValueError, match=f"block_n={block_n}"):
            P.build_plan(w, b, 32, tuned=TunedConfig(block_n=block_n))
    with pytest.raises(ValueError, match=f"block_n={block_n}"):
        P.fused_route(ws, block_n=block_n)
    winner, records = sweep_stack(ws, bs, 32, time_forwards=False, device="cpu",
                                  candidates=default_candidates(block_ns=(None, block_n)))
    errors = [r for r in records if "error" in r]
    assert errors and all(f"block_n={block_n}" in r["error"] for r in errors)
    assert winner.block_n is None


def test_a_budget_above_the_cards_shared_memory_is_refused():
    (_, _), (ws, bs) = _square_stack(jax.random.PRNGKey(12))
    over = TunedConfig(vmem_limit_bytes=SMEM_LIMIT_BYTES + 1)
    with pytest.raises(ValueError, match="shared-memory budget"):
        P.build_plan(ws, bs, 32, tuned=over)
    with pytest.raises(ValueError, match="shared-memory budget"):
        SparseDNNEngine(ws, bs, device="cpu", panel_dtype="float32",
                        tuning_table=_table_for(ws, over))
    at = P.build_plan(ws, bs, 32, tuned=TunedConfig(vmem_limit_bytes=SMEM_LIMIT_BYTES))
    assert at.route == P.build_plan(ws, bs, 32).route == P.ROUTE_FUSED


def _table_for(ws, cfg):
    table = TuningTable()
    table.put(P.topology_fingerprint(ws), "cpu", "float32", cfg)
    return table


def test_the_backend_key_is_the_torch_device_type():
    """A table the JAX package tuned (``gpu``/``tpu`` keys) never steers the
    port's kernels, whose tiles mean something else."""
    assert default_backend("cpu") == "cpu" and default_backend("cuda:0") == "cuda"
    assert default_backend() == ("cuda" if torch.cuda.is_available() else "cpu")
    _, (ws, bs) = _square_stack(jax.random.PRNGKey(13))
    table = TuningTable()
    for backend in ("gpu", "tpu"):
        table.put(P.topology_fingerprint(ws), backend, "float32", TunedConfig(block_n=8))
    assert SparseDNNEngine(ws, bs, tuning_table=table, device="cpu").tuned is None
    table.put(P.topology_fingerprint(ws), "cpu", "float32", TunedConfig(block_n=8))
    assert SparseDNNEngine(ws, bs, tuning_table=table, device="cpu").tuned == TunedConfig(
        block_n=8)


# ------------------------------------------- build_plan's relayout and donor


def test_relayout_tri_state_follows_the_reference():
    """``relayout=None`` relayouts inference plans only; ``False`` keeps the
    caller's layouts (and ignores the tuned layout, as the reference
    does); a differentiable plan refuses ``True``."""
    (jws, jbs), (ws, bs) = _skewed_stack()
    cfg, jcfg = TunedConfig(layout="bcsr"), JTuned(layout="bcsr")
    for relayout in (None, False):
        plan = P.build_plan(ws, bs, 32, tuned=cfg, relayout=relayout)
        jplan = JP.build_plan(jws, jbs, 32, tuned=jcfg, relayout=relayout)
        assert plan.layouts == jplan.layouts
    assert P.build_plan(ws, bs, 32, tuned=cfg, relayout=False).layouts == ("ell",) * 3
    assert P.build_plan(ws, bs, 32, differentiable=True).layouts == ("ell",) * 3
    for build, w, b in ((P.build_plan, ws, bs), (JP.build_plan, jws, jbs)):
        with pytest.raises(ValueError, match="relayout"):
            build(w, b, 32, differentiable=True, relayout=True)


def test_a_donor_with_another_tuned_token_is_refused():
    _, (ws, bs) = _skewed_stack()
    donor = P.build_plan(ws, bs, 32, tuned=TunedConfig(layout="bcsr"))
    same = P.build_plan(ws, bs, 64, tuned=TunedConfig(layout="bcsr"), donor=donor)
    assert same.weights == donor.weights and same.layouts == ("bcsr",) * 3
    for other in (None, TunedConfig(block_n=8)):
        with pytest.raises(ValueError, match="donor"):
            P.build_plan(ws, bs, 64, tuned=other, donor=donor)


def test_block_n_feeds_the_bill_and_every_wrapper_call():
    """A layered plan at ``block_n=8`` bills 8-wide tiles and pads its
    panels to 8 columns; the output is the default plan's."""
    _, (ws, bs) = _skewed_stack()
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((256, 20)).astype(np.float32))
    p16 = P.build_plan(ws, bs, 20)
    p8 = P.build_plan(ws, bs, 20, tuned=TunedConfig(block_n=8))
    assert p8.block_n == 8 and p16.block_n == 16
    assert p8.grid_steps == P.stack_grid_steps(p8.weights, 20, block_n=8) == (
        p16.grid_steps // 2 * 3)  # 3 tiles of 8 against 2 of 16
    torch.testing.assert_close(p8.forward(x), p16.forward(x), rtol=1e-6, atol=1e-6)
