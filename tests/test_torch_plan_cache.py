"""The port's plan cache, width classes and plan executables against the reference.

The cache and width-class cases of the reference's ``tests/test_plan.py``
on both packages with the reference's ``jax.random`` stacks (converted
through numpy): the same hits, misses, builds, evictions and compile
counts; outputs within ``rtol=1e-5, atol=1e-5``. Then the port's own
pieces: the cached topology digest (a second fingerprint of the same
index tensors copies nothing to the host; an in-place change of an index
tensor changes the fingerprint; the strings are the ones the port always
made), ``describe()``, ``TunedConfig`` and its five knobs (bf16 panels
held to the plain version exactly on the CPU and to the reference within
its ``tune`` gate, 2% of the output's scale; the other knobs' plans as
the reference builds them), and ``dnn_forward_resident`` over the
default cache.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.plan as JP
from repro.core import dnn as jdnn
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import SparseDNNEngine as JEngine
from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.tune import TunedConfig as JTuned
from repro_torch import convert
from repro_torch import plan as P
from repro_torch.core import dnn
from repro_torch.core.dnn import stack_bsr
from repro_torch.data import radixnet as rx
from repro_torch.kernels.fused_mlp import fused_mlp_plain
from repro_torch.plan import stack_plan
from repro_torch.serve import ContinuousBatcher, SparseDNNEngine
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix
from repro_torch.sparse.bcsr import reset_transpose_sort_count, transpose_sort_count
from repro_torch.tune import TunedConfig

TOL = dict(rtol=1e-5, atol=1e-5)


def _stacks(seed, L, m, bpr=2, block=16):
    """The reference tests' ``_stack(PRNGKey(seed), ...)`` and its port."""
    ks = jax.random.split(jax.random.PRNGKey(seed), L)
    jws = [JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr) for k in ks]
    jbs = [jnp.zeros((m,), jnp.float32) for _ in range(L)]
    return (jws, jbs), ([convert.layout(w) for w in jws], [convert.bias(b) for b in jbs])


def _u(seed, shape):
    j = jax.random.uniform(jax.random.PRNGKey(seed), shape)
    return j, torch.from_numpy(np.array(j))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------
# cache keying + eviction
# ---------------------------------------------------------------------


def test_cache_same_topology_same_width_hits():
    (jws, jbs), (ws, bs) = _stacks(1, 2, 32)
    for cache, w, b in ((JP.PlanCache(max_size=4), jws, jbs), (P.PlanCache(max_size=4), ws, bs)):
        p1 = cache.get(w, b, 16)
        assert cache.get(w, b, 16) is p1
        assert cache.stats()["hits"] == 1 and cache.stats()["builds"] == 1
        assert p1.key in cache and cache.hit_rate == 0.5


def test_cache_distinct_plans_per_key_axis():
    (jws, jbs), (ws, bs) = _stacks(2, 2, 64, bpr=1)
    (jother, _), (other, _) = _stacks(3, 2, 64, bpr=1)
    assert P.topology_fingerprint(ws) != P.topology_fingerprint(other)
    stats = []
    for cache, w, o, b in ((JP.PlanCache(max_size=8), jws, jother, jbs),
                           (P.PlanCache(max_size=8), ws, other, bs)):
        base = cache.get(w, b, 16)
        assert cache.get(o, b, 16) is not base
        assert cache.get(w, b, 32) is not base
        assert cache.get(w, b, 16, differentiable=True) is not base
        assert cache.get(w, b, 16) is base
        stats.append(cache.stats())
    assert stats[1] == stats[0] and stats[1]["builds"] == 4


def test_cache_eviction_respects_max_size():
    (jws, jbs), (ws, bs) = _stacks(4, 2, 32)
    stats = []
    for cache, w, b in ((JP.PlanCache(max_size=2), jws, jbs), (P.PlanCache(max_size=2), ws, bs)):
        p8 = cache.get(w, b, 8)
        cache.get(w, b, 16)
        cache.get(w, b, 32)
        assert len(cache) == 2 and cache.stats()["evictions"] == 1
        assert cache.get(w, b, 8) is not p8
        stats.append(cache.stats())
    assert stats[1] == stats[0] and stats[1]["builds"] == 4


def test_cache_rejects_stale_bound_values():
    (jws, jbs), (ws, bs) = _stacks(5, 2, 32)
    jrescaled = [w.map_blocks(lambda x: x * 3.0) for w in jws]
    rescaled = [convert.layout(w) for w in jrescaled]
    cache = P.PlanCache(max_size=4)
    p1 = cache.get(ws, bs, 8)
    p2 = cache.get(rescaled, bs, 8)
    assert p1 is not p2 and p1.key == p2.key
    jy, y = _u(6, (32, 4))
    _close(p2.forward(y), jdnn.dnn_forward(jrescaled, jbs, jy, fused=True))


def test_cache_shares_topology_artifacts_across_width_classes():
    (jws, jbs), (ws, bs) = _stacks(34, 2, 32)
    mixed = [BlockCSRMatrix.from_bsr(ws[0]), ws[1]]
    cache = P.PlanCache(max_size=8)
    reset_transpose_sort_count()
    p8 = cache.get(mixed, bs, 8, differentiable=True)
    p16 = cache.get(mixed, bs, 16, differentiable=True)
    assert transpose_sort_count() == 2  # the block-CSR and the ELL layer, once each
    assert all(p16.layers[i].transpose_plan is p8.layers[i].transpose_plan for i in (0, 1))
    jmixed = [JBCSR.from_bsr(jws[0]), jws[1]]
    assert p16.grid_steps == jdnn.dnn_grid_steps(jmixed, 16, block_n=16)
    f8, f16 = cache.get(ws, bs, 8), cache.get(ws, bs, 16)
    assert f8.route == f16.route == P.ROUTE_FUSED
    assert f16.stacked is f8.stacked  # one device copy per topology
    assert f8.pool is f16.pool is p8.pool is None  # no CUDA graphs on the CPU
    assert cache.compiled_widths(f8.key.fingerprint) == {8, 16}
    jy, y = _u(35, (32, 10))
    _close(f16.forward(y), jdnn.dnn_forward(jws, jbs, jy, fused=True))


def test_cache_stats_and_clear_match_reference():
    (jws, jbs), (ws, bs) = _stacks(36, 2, 32)
    jcache, cache = JP.PlanCache(max_size=3), P.PlanCache(max_size=3)
    for width in (8, 16, 8, 32, 64, 8):
        jcache.get(jws, jbs, width)
        cache.get(ws, bs, width)
    assert cache.stats() == jcache.stats()
    fp = P.topology_fingerprint(ws)
    assert cache.compiled_widths(fp) == jcache.compiled_widths(
        JP.topology_fingerprint(jws)) == {32, 64, 8}
    assert cache.compiled_widths("not-a-fingerprint") == set()
    cache.clear()
    assert len(cache) == 0 and cache.compiled_widths(fp) == set()
    assert cache.stats()["lookups"] == 6  # counters survive a clear, as the reference's


def test_default_cache_is_small_and_resettable():
    P.reset_default_cache()
    cache = P.default_cache()
    assert P.default_cache() is cache and cache.max_size == JP.default_cache().max_size == 4
    P.reset_default_cache()
    assert P.default_cache() is not cache


# ---------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------


def test_engine_steps_share_one_plan_per_width_class():
    (jws, jbs), (ws, bs) = _stacks(24, 2, 32)
    seen = []
    for eng, conv in ((JEngine(jws, jbs, batch_align=8), lambda x: x),
                      (SparseDNNEngine(ws, bs, batch_align=8, device="cpu"),
                       lambda x: torch.from_numpy(np.array(x)))):
        stats = [eng.infer(conv(jax.random.uniform(jax.random.PRNGKey(s), (32, k))))[1]["plan"]
                 for s, k in ((25, 5), (26, 7), (27, 9))]
        assert [s["width_class"] for s in stats] == [8, 8, 16]
        assert [s["cache_hit"] for s in stats] == [False, True, False]
        assert stats[1]["compiles"] == 1
        seen.append((stats, eng.plan_cache.stats()))
    assert seen[1] == seen[0]


def test_engine_pad_to_quantizes_panel():
    (jws, jbs), (ws, bs) = _stacks(28, 2, 32)
    eng = SparseDNNEngine(ws, bs, batch_align=8, device="cpu")
    jy, y = _u(29, (32, 3))
    eng.submit(y)
    out, stats = eng.step(pad_to=24)
    assert stats["padded_batch"] == 24 and stats["pad_slots"] == 21
    assert stats["grid_steps"] == jdnn.dnn_grid_steps(jws, 24, block_n=16)
    assert out.shape == (32, 3)
    _close(out, jdnn.dnn_forward(jws, jbs, jy, fused=True))
    with pytest.raises(ValueError):
        eng.step(pad_to=0)


def test_batcher_width_classes_reuse_compiled_plans():
    (jws, jbs), (ws, bs) = _stacks(30, 2, 32)
    runs = []
    for eng, batcher, conv in (
        (JEngine(jws, jbs, batch_align=8), JBatcher, lambda x: x),
        (SparseDNNEngine(ws, bs, batch_align=8, device="cpu"), ContinuousBatcher,
         lambda x: torch.from_numpy(np.array(x))),
    ):
        b = batcher(eng, batch_size=16, min_fill=0.0, width_classes=(8, 16))
        for i in range(23):
            for j in range(1 + (i * 5) % 7):
                b.submit(conv(jax.random.uniform(jax.random.PRNGKey(100 + 10 * i + j), (32,))))
            b.step(force=True)
        b.drain()
        stats = b.stats()
        assert {s.width_class for s in stats.steps} <= {8, 16}
        assert sum(stats.plan_recompiles_by_class.values()) == len(
            stats.plan_recompiles_by_class)
        assert eng.plan_cache.stats()["builds"] == len(stats.plan_recompiles_by_class)
        assert stats.plan_cache_hit_rate >= 0.8
        runs.append((b, stats))
    (jb, js), (tb, ts) = runs
    assert ts.plan_recompiles_by_class == js.plan_recompiles_by_class
    assert ts.plan_cache_hit_rate == js.plan_cache_hit_rate
    for rid in js.latencies:
        _close(tb.result(rid), jb.result(rid))


def test_batcher_width_classes_validation():
    _, (ws, bs) = _stacks(31, 2, 32)
    with pytest.raises(ValueError, match="width class"):
        ContinuousBatcher(SparseDNNEngine(ws, bs, batch_align=8, device="cpu"), batch_size=32,
                          width_classes=(8, 16))
    with pytest.raises(ValueError, match="positive"):
        ContinuousBatcher(SparseDNNEngine(ws, bs, batch_align=8, device="cpu"), batch_size=4,
                          width_classes=(0, 8))


# ---------------------------------------------------------------------
# plan executables on the CPU
# ---------------------------------------------------------------------


def test_plan_forward_compiles_once_and_describes_itself_like_reference():
    (jws, jbs), (ws, bs) = _stacks(14, 2, 32)
    plans = (JP.build_plan(jws, jbs, 16), P.build_plan(ws, bs, 16))
    for plan, conv in zip(plans, (lambda x: x, lambda x: torch.from_numpy(np.array(x)))):
        assert plan.compile_count == 0
        assert plan.forward(conv(jax.random.uniform(jax.random.PRNGKey(15), (32, 3)))).shape == (
            32, 3)
        plan.forward(conv(jax.random.uniform(jax.random.PRNGKey(16), (32, 9))))
        assert plan.compile_count == 1 and plan.calls == 2
        with pytest.raises(ValueError, match="width"):
            plan.forward(conv(jnp.zeros((32, 17))))
    jd, d = (p.describe() for p in plans)
    assert d.pop("kernel_launches") == jd.pop("pallas_calls") == 1
    assert d.pop("executable") == "eager" and "cpu" in d.pop("eager_because")
    assert (d.pop("replays"), d.pop("warmups")) == (0, 0)
    jd.pop("fingerprint"), d.pop("fingerprint")  # each package hashes its own way
    assert d == jd
    assert plans[1].captured_launches is None


def test_a_differentiable_plan_stays_eager_and_says_why():
    _, (ws, bs) = _stacks(17, 2, 32)
    plan = P.build_plan(ws, bs, 8, differentiable=True)
    assert "autograd" in plan.eager_because
    plan.forward(torch.rand(32, 8))
    assert plan.compile_count == 1 and plan.describe()["executable"] == "eager"


def _old_fingerprint(weights):
    """The port's fingerprint as it was computed before the digest cache:
    every layer's index arrays copied and hashed on every call."""
    digests, h = {}, hashlib.sha1()
    for w in weights:
        if id(w) not in digests:
            d = hashlib.sha1()
            if isinstance(w, BlockCSRMatrix):
                d.update(b"bcsr")
                d.update(repr((w.shape, w.block_shape, w.total_blocks)).encode())
                arrays = (w.row_ptr, w.row_id, w.col_idx, w.valid)
            elif isinstance(w, BlockSparseMatrix):
                d.update(b"ell")
                d.update(repr((w.shape, w.block_shape, w.max_blocks_per_row)).encode())
                arrays = (w.col_idx, w.block_mask)
            else:
                d.update(b"dense")
                d.update(repr(tuple(w.shape)).encode())
                arrays = ()
            for arr in arrays:
                d.update(arr.cpu().numpy().tobytes())
            digests[id(w)] = d.digest()
        h.update(digests[id(w)])
    return h.hexdigest()


def test_topology_digest_is_cached_on_the_index_tensors(monkeypatch):
    ws, _ = rx.radixnet_weights(rx.RadixNetSpec(256, 4), device="cpu")
    mixed = [BlockCSRMatrix.from_bsr(ws[0]), ws[1], ws[1].to_dense(), ws[0]]
    copies = []
    hash_arrays = stack_plan._hash_arrays
    monkeypatch.setattr(stack_plan, "_hash_arrays",
                        lambda header, arrays: copies.append(header) or hash_arrays(header,
                                                                                    arrays))
    fp = P.topology_fingerprint(mixed)
    assert fp == _old_fingerprint(mixed)  # the same strings as before the cache
    assert len(copies) == 3  # one host copy per distinct sparse layer
    assert P.topology_fingerprint(mixed) == fp and len(copies) == 3  # none the second time
    # values are not topology: another value tensor on the same indices hits
    assert P.topology_fingerprint([dnn.with_values(ws[1], ws[1].blocks * 2)]) == (
        P.topology_fingerprint([ws[1]]))
    assert len(copies) == 3
    # an in-place change of an index tensor is a new topology
    ws[1].col_idx[0, 0] = (ws[1].col_idx[0, 0] + 1) % ws[1].n_col_blocks
    fp2 = P.topology_fingerprint(mixed)
    assert fp2 != fp and fp2 == _old_fingerprint(mixed) and len(copies) == 4


# ---------------------------------------------------------------------
# tuned configs: panel_dtype
# ---------------------------------------------------------------------


def test_tuned_config_matches_reference_tokens():
    for kw in ({}, {"panel_dtype": "bfloat16"}, {"panel_dtype": "float32"}):
        assert TunedConfig(**kw).token() == JTuned(**kw).token()
        assert TunedConfig(**kw).is_default == JTuned(**kw).is_default
    assert TunedConfig(panel_dtype=torch.bfloat16) == TunedConfig(panel_dtype="bfloat16")
    assert TunedConfig(panel_dtype=np.float32).panel_dtype == "float32"
    with pytest.raises(ValueError, match="panel_dtype"):
        TunedConfig(panel_dtype="float16")


@pytest.mark.parametrize("knob", [{"block_n": 8}, {"block_size": 32}, {"layout": "bcsr"},
                                  {"vmem_limit_bytes": "f32 panel - 1"}])
def test_tuned_knobs_other_than_panel_dtype_are_refused(knob):
    """The reference's other four knobs, which the port's config refused
    until ROADMAP Queue 1 item 4, are honoured now: the reference's token,
    and plans built as the reference builds them, with its outputs. A
    layered stack: ``block_n`` 8 bills and pads in 8-wide tiles,
    ``block_size`` re-blocks the layered weights, ``layout`` forces
    block-CSR. A square stack: a shared-memory budget one byte under the
    f32 resident panel tips it to ``fused-tiled``, bf16 panels keep it
    resident. (What the port still refuses is in ``test_torch_tune.py``.)"""
    from repro.kernels.fused_mlp import fused_mlp_vmem_bytes
    from repro_torch.kernels.fused_mlp import fused_mlp_smem_bytes

    (name, value), = knob.items()
    (jws, jbs), (ws, bs) = _stacks(42, 2, 64)
    jy, y = _u(43, (64, 40))
    if name == "vmem_limit_bytes":
        port = TunedConfig(vmem_limit_bytes=fused_mlp_smem_bytes(64) - 1)
        ref = JTuned(vmem_limit_bytes=fused_mlp_vmem_bytes(64, 128) - 1)
        assert port.token() == f"vmem_limit_bytes={fused_mlp_smem_bytes(64) - 1}"
        plan, jplan = P.build_plan(ws, bs, 40, tuned=port), JP.build_plan(jws, jbs, 40, tuned=ref)
        assert plan.route == jplan.route == P.ROUTE_FUSED_TILED
        bf16 = dataclasses.replace(port, panel_dtype="bfloat16")
        assert P.build_plan(ws, bs, 40, tuned=bf16).route == P.ROUTE_FUSED
        _close(plan.forward(y), jplan.forward(jy))
        return
    cfg, jcfg = TunedConfig(**knob), JTuned(**knob)
    assert cfg.token() == jcfg.token() and cfg.to_dict() == jcfg.to_dict() == knob
    assert TunedConfig(panel_dtype="bfloat16", **knob).token() == JTuned(
        panel_dtype="bfloat16", **knob).token()
    mixed, jmixed = [BlockCSRMatrix.from_bsr(ws[0]), ws[1]], [JBCSR.from_bsr(jws[0]), jws[1]]
    plan, jplan = P.build_plan(mixed, bs, 40, tuned=cfg), JP.build_plan(jmixed, jbs, 40, tuned=jcfg)
    assert plan.route == jplan.route == P.ROUTE_LAYERED and plan.key.tuned == cfg.token()
    assert plan.layouts == jplan.layouts
    assert [w.block_shape for w in plan.weights] == [w.block_shape for w in jplan.weights]
    if name == "block_n":
        assert plan.block_n == 8 and plan.grid_steps == jplan.grid_steps
        assert plan.grid_steps == P.stack_grid_steps(plan.weights, 40, block_n=8) > (
            P.build_plan(mixed, bs, 40).grid_steps)
    np.testing.assert_allclose(plan.forward(y).numpy(), np.asarray(jplan.forward(jy)),
                               rtol=1e-4, atol=1e-4)


def test_plan_cache_tuned_untuned_non_collision():
    _, (ws, bs) = _stacks(41, 2, 64)
    cache = P.PlanCache()
    tuned = TunedConfig(panel_dtype="bfloat16")
    p_default, p_tuned = cache.get(ws, bs, 32), cache.get(ws, bs, 32, tuned=tuned)
    assert p_default is not p_tuned and p_default.key != p_tuned.key
    assert p_default.key.tuned is None and p_tuned.key.tuned == tuned.token()
    assert cache.get(ws, bs, 32, tuned=tuned) is p_tuned
    assert p_tuned.describe()["tuned"] == "panel_dtype=bfloat16"


def test_bf16_panels_move_the_resident_boundary():
    """3424 neurons tile with f32 panels but stay resident with bf16 ones."""
    w = BlockSparseMatrix(torch.zeros(214, 2, 16, 16), torch.zeros(214, 2, dtype=torch.int32),
                          torch.zeros(214, 2, dtype=torch.bool), (3424, 3424), (16, 16))
    b = torch.zeros(3424)
    assert P.build_plan([w], [b], 16).route == P.ROUTE_FUSED_TILED
    tuned = P.build_plan([w], [b], 16, tuned=TunedConfig(panel_dtype="bfloat16"))
    assert tuned.route == P.ROUTE_FUSED


def test_engine_panel_dtype_serves_bf16_panels_like_the_reference():
    spec = rx.RadixNetSpec(256, 6)
    from repro.data import radixnet as jrx

    jws, jbs = jrx.radixnet_weights(jrx.RadixNetSpec(256, 6))
    ws, bs = rx.radixnet_weights(spec, device="cpu")
    panel = rx.radixnet_input_panel(256, 20, density=0.3, seed=3)
    eng = SparseDNNEngine(ws, bs, batch_align=32, device="cpu", panel_dtype="bfloat16")
    assert eng.tuned.panel_dtype == "bfloat16"
    out, stats = eng.infer(torch.from_numpy(panel))
    assert stats["plan"]["tuned"] == "panel_dtype=bfloat16" and stats["plan"]["route"] == "fused"
    want = fused_mlp_plain(stack_bsr(ws), torch.stack(bs), torch.from_numpy(panel),
                           panel_dtype="bfloat16")
    assert torch.equal(out, want)
    ref, rstats = JEngine(jws, jbs, batch_align=32, panel_dtype="bfloat16").infer(
        jnp.asarray(panel))
    assert rstats["plan"]["tuned"] == stats["plan"]["tuned"]
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=0.02 * float(np.abs(ref).max()) + 1e-6)


# ---------------------------------------------------------------------
# dnn_forward_resident
# ---------------------------------------------------------------------


def test_dnn_forward_resident_matches_reference_over_the_default_cache():
    P.reset_default_cache()
    (jws, jbs), (ws, bs) = _stacks(36, 3, 64)
    jy, y = _u(37, (64, 10))
    want = jdnn.dnn_forward_resident(jws, jbs, jy)
    _close(dnn.dnn_forward_resident(ws, bs, y), want)
    _close(dnn.dnn_forward_resident(ws, bs, y), want)
    cache = P.default_cache()
    assert cache.stats()["builds"] == 1 and cache.stats()["hits"] == 1
    assert cache.plans()[0].route == P.ROUTE_FUSED
    # a stack no fused route takes runs the plan's layered kernels
    mixed = [BlockCSRMatrix.from_bsr(ws[0]), ws[1], ws[2]]
    jmixed = [JBCSR.from_bsr(jws[0]), jws[1], jws[2]]
    _close(dnn.dnn_forward_resident(mixed, bs, y), jdnn.dnn_forward_resident(jmixed, jbs, jy))
    assert cache.plans()[-1].route == P.ROUTE_LAYERED
    # an explicit panel_dtype is a tuned plan of the cache: that stack's
    # layered kernels, where the reference falls back to dnn_forward
    _close(dnn.dnn_forward_resident(mixed, bs, y, panel_dtype="float32"),
           jdnn.dnn_forward_resident(jmixed, jbs, jy, panel_dtype="float32"))
    tuned = cache.plans()[-1]
    assert tuned.route == P.ROUTE_LAYERED and tuned.key.tuned == "panel_dtype=float32"
    assert cache.stats()["builds"] == 3
    # an explicit block_n is a tuned plan of the cache too; the fused
    # kernels take column tiles of 8 and 16 only
    _close(dnn.dnn_forward_resident(ws, bs, y, block_n=8),
           jdnn.dnn_forward_resident(jws, jbs, jy, block_n=8))
    assert cache.plans()[-1].key.tuned == "block_n=8"
    assert cache.plans()[-1].route == P.ROUTE_FUSED and cache.plans()[-1].block_n == 8
    with pytest.raises(ValueError, match="block_n=32"):
        dnn.dnn_forward_resident(ws, bs, y, block_n=32)
    P.reset_default_cache()


@pytest.mark.parametrize("name, wrapper", [
    ("_ZN12_GLOBAL__N_118fused_tiled_kernelILi16EfEEvPKfPKiPKhS3_", "fused_mlp_tiled_forward"),
    ("_ZN12_GLOBAL__N_121fused_resident_kernelILi16EfEEvPKf", "fused_mlp_forward"),
    ("_ZN12_GLOBAL__N_115bsr_spmm_kernelIN8semiring10PlusTimesE", "bsr_spmm"),
    ("_ZN12_GLOBAL__N_116bcsr_spmm_kernelIN8semiring10PlusTimesE", "bcsr_spmm"),
    ("void (anonymous namespace)::bcsr_spmm_kernel<semiring::PlusTimes>(float const*)",
     "bcsr_spmm"),
    ("void (anonymous namespace)::semiring_matmul_kernel<Tile<64, 64>>(float const*)",
     "semiring_matmul"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>",
     None),
])
def test_wrapper_of_maps_device_function_names(name, wrapper):
    """A captured graph's kernel nodes name their functions mangled (the
    libcuda's names) or demangled (a profiler's); both map to the wrapper,
    and PyTorch's own kernels to none."""
    from repro_torch.kernels import ops

    assert ops.wrapper_of(name) == wrapper
