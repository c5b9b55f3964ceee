"""The port's GraphBLAS façade, transposes, skewed generator, GNN workload
and three-call DNN against the JAX package, on the same numpy inputs.

On this CPU-only host ``mxm`` on a sparse operand goes through an
``MxmPlan`` whose wrappers run the kernels' plain versions; the reference
runs its Pallas kernels in interpret mode, or its XLA oracle
(``use_kernel=False``) where interpret mode would be slow — the
reference's own tests pin its kernels to that oracle. Integer-valued
inputs make every comparison but ``plus_times`` on real-valued features
exact; the graph convolution is held to the GNN arm's scale-normalised
1e-5 (benchmarks/kernel_bench.py ``gnn_arm``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.core import graphblas as jgb
from repro.core import semiring as jsr
from repro.data import radixnet as jrx
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.core import dnn
from repro_torch.core import graphblas as gb
from repro_torch.core import semiring as sr
from repro_torch.data import radixnet as rx
from repro_torch.plan import mxm as pmxm
from repro_torch.serve import SparseDNNEngine
from repro_torch.sparse.bcsr import (
    BlockCSRMatrix,
    reset_transpose_sort_count,
    transpose_sort_count,
)

t = torch.from_numpy


def _sparse(seed, m=32, k=48, bs=8):
    """Reference ELL (with pad slots, one empty block-row, one empty
    block-column) and block-CSR (with tail padding), and the port's."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-3, 4, (m, k)).astype(np.float32)
    keep = rng.random((m // bs, k // bs)) < 0.5
    keep[0, :3] = True
    keep[1] = False
    keep[:, -1] = False
    d *= np.kron(keep, np.ones((bs, bs), np.float32))
    jb = JBSR.from_dense(d, (bs, bs), pad_to=k // bs)
    jc = JBCSR.from_bsr(jb, pad_to=int(keep.sum()) + 3)
    return d, jb, jc, convert.layout(jb), convert.layout(jc)


def _arrays_equal(port, ref, names):
    for name in names:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_bsr_transpose_matches_reference_and_honours_pad_to():
    d, jb, _, pb, _ = _sparse(0)
    for pad_to in (None, 5):
        got, want = pb.transpose(pad_to=pad_to), jb.transpose(pad_to=pad_to)
        _arrays_equal(got, want, ("blocks", "col_idx", "block_mask"))
        assert got.shape == want.shape and got.block_shape == want.block_shape
        np.testing.assert_array_equal(got.to_dense().numpy(), d.T)
    with pytest.raises(ValueError, match="column occupancy"):
        pb.transpose(pad_to=1)


def test_bcsr_transpose_plan_matches_reference_and_sorts_once():
    d, _, jc, _, pc = _sparse(1)
    reset_transpose_sort_count()
    plan = pc.transpose_plan()
    jplan = jc.transpose_plan()
    _arrays_equal(plan, jplan, ("order", "row_ptr", "row_id", "col_idx", "valid"))
    # invalid tail slots sort last and ride on the last valid row
    nnz = int(plan.row_ptr[-1])
    assert not plan.valid[nnz:].any() and (plan.row_id[nnz:] == plan.row_id[nnz - 1]).all()
    scaled = BlockCSRMatrix(pc.values * 2, pc.row_ptr, pc.row_id, pc.col_idx, pc.valid,
                            pc.shape, pc.block_shape)
    for _ in range(3):  # new values, frozen topology: a gather, no sort
        got = plan.apply(scaled)
    assert transpose_sort_count() == 1
    np.testing.assert_array_equal(got.to_dense().numpy(), 2 * d.T)
    _arrays_equal(pc.transpose(), jc.transpose(), ("values", "row_ptr", "row_id", "col_idx"))
    assert transpose_sort_count() == 2
    assert gb.transpose(pc).validate() is not None


def test_random_skewed_is_bit_identical_to_reference():
    """The GNN arm's adjacency (256, block 16, 56 blocks, skew 0.8, seed 5)."""
    want = JBCSR.random_skewed(seed=5, shape=(256, 256), block_shape=(16, 16),
                               total_blocks=56, skew=0.8)
    got = BlockCSRMatrix.random_skewed(5, (256, 256), (16, 16), 56, skew=0.8, device="cpu")
    _arrays_equal(got, want, ("values", "row_ptr", "row_id", "col_idx", "valid"))
    assert got.validate() is got
    with pytest.raises(ValueError, match="capacity"):
        BlockCSRMatrix.random_skewed(5, (256, 256), (16, 16), 257, device="cpu")


LOG_PLUS_TOL = 1e-5  # the reference's TOL: log_plus reductions chain in another order


def _check_products(ja, pa, layout, name, m, k):
    rng = np.random.default_rng(3)
    y = rng.integers(-3, 4, (k, 7)).astype(np.float32)
    v = rng.integers(-3, 4, k).astype(np.float32)
    u = rng.integers(-3, 4, m).astype(np.float32)
    js, ps = jsr.get_semiring(name), sr.get_semiring(name)
    kw = {} if layout == "dense" else {"use_kernel": False}
    cases = [
        (gb.mxm(pa, t(y), ps), jgb.mxm(ja, jnp.asarray(y), js, **kw)),
        (gb.mxv(pa, t(v), ps), jgb.mxv(ja, jnp.asarray(v), js, **kw)),
        (gb.vxm(t(u), pa, ps), jgb.vxm(jnp.asarray(u), ja, js, **kw)),
    ]
    if layout != "dense":  # the port's oracle route too
        cases.append((gb.mxm(pa, t(y), ps, use_kernel=False), cases[0][1]))
    for got, want in cases:
        want = np.asarray(want)
        if layout != "dense":
            assert got.dtype == torch.float32  # sparse products: f32 encoding
        if name == "log_plus":
            np.testing.assert_allclose(got.numpy(), want, rtol=LOG_PLUS_TOL, atol=LOG_PLUS_TOL)
        else:
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("name", sorted(sr.REGISTRY))
@pytest.mark.parametrize("layout", ["dense", "ell", "bcsr"])
def test_mxm_mxv_vxm_match_reference(layout, name):
    """Every semiring of the registry: exact on integer operands,
    ``log_plus`` within LOG_PLUS_TOL."""
    d, jb, jc, pb, pc = _sparse(2)
    ja, pa = {"dense": (jnp.asarray(d), t(d)), "ell": (jb, pb), "bcsr": (jc, pc)}[layout]
    _check_products(ja, pa, layout, name, 32, 48)


@pytest.mark.parametrize("name", sorted(sr.REGISTRY))
@pytest.mark.parametrize("layout", ["ell", "bcsr"])
@pytest.mark.parametrize("block", [(8, 16), (16, 8), (4, 8)], ids=lambda b: f"{b[0]}x{b[1]}")
def test_mxm_mxv_vxm_match_reference_on_rectangular_blocks(block, layout, name):
    """The same products on rectangular blocks, with pad slots, an empty
    block-row and tail padding."""
    rng = np.random.default_rng(9)
    m, k = 32, 48
    d = rng.integers(-3, 4, (m, k)).astype(np.float32)
    keep = rng.random((m // block[0], k // block[1])) < 0.5
    keep[0, :2] = True
    keep[1] = False
    d *= np.kron(keep, np.ones(block, np.float32))
    jb = JBSR.from_dense(d, block, pad_to=k // block[1])
    ja = jb if layout == "ell" else JBCSR.from_bsr(jb, pad_to=int(keep.sum()) + 2)
    _check_products(ja, convert.layout(ja), layout, name, m, k)


def test_masks_accumulators_reductions_and_indexing_match_reference():
    rng = np.random.default_rng(4)
    a = rng.integers(-3, 4, (6, 5)).astype(np.float32)
    b = rng.integers(-3, 4, (5, 4)).astype(np.float32)
    prev = rng.integers(-3, 4, (6, 4)).astype(np.float32)
    mask = rng.random((6, 4)) < 0.5
    ja, jb_, jp, jm = (jnp.asarray(x) for x in (a, b, prev, mask))
    pa, pb_, pp, pm = (t(x) for x in (a, b, prev, mask))
    rows, cols = np.array([4, 0, 2]), np.array([3, 1])
    pairs = [
        (gb.mxm(pa, pb_, mask=pm), jgb.mxm(ja, jb_, mask=jm)),
        (gb.mxm(pa, pb_, sr.MIN_PLUS, accum=torch.minimum, prev=pp, mask=pm),
         jgb.mxm(ja, jb_, jsr.MIN_PLUS, accum=jnp.minimum, prev=jp, mask=jm)),
        (gb.ewise_mult(pp, pp, sr.MAX_PLUS, accum=torch.add, prev=pp),
         jgb.ewise_mult(jp, jp, jsr.MAX_PLUS, accum=jnp.add, prev=jp)),
        (gb.ewise_add(pp, -pp, sr.MAX_PLUS, mask=pm, prev=pp),
         jgb.ewise_add(jp, -jp, jsr.MAX_PLUS, mask=jm, prev=jp)),
        (gb.apply(pp, torch.abs, mask=pm), jgb.apply(jp, jnp.abs, mask=jm)),
        (gb.reduce_rows(pa, sr.MAX_PLUS), jgb.reduce_rows(ja, jsr.MAX_PLUS)),
        (gb.reduce_rows(pa, sr.XOR_AND, dim=0), jgb.reduce_rows(ja, jsr.XOR_AND, axis=0)),
        (gb.reduce_scalar(pa, sr.MIN_PLUS), jgb.reduce_scalar(ja, jsr.MIN_PLUS)),
        (gb.reduce_scalar(pa), jgb.reduce_scalar(ja)),
        (gb.select(pa, lambda x: x > 0), jgb.select(ja, lambda x: x > 0)),
        (gb.select(pa, lambda x: x < 0, fill=9.0), jgb.select(ja, lambda x: x < 0, fill=9.0)),
        (gb.extract(pa, t(rows), t(cols)), jgb.extract(ja, jnp.asarray(rows), jnp.asarray(cols))),
        (gb.assign(pa, t(rows), t(cols), 7.0),
         jgb.assign(ja, jnp.asarray(rows), jnp.asarray(cols), 7.0)),
        (gb.transpose(pa), jgb.transpose(ja)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(i))
    assert pa.numpy().tolist() == a.tolist()  # assign left its input alone
    with pytest.raises(ValueError, match="accum requires"):
        gb.ewise_add(pa, pa, accum=torch.add)


def _relax(present, lengths, d):
    """One numpy Bellman-Ford step: d ← min(d, min_j (A[i,j] + d[j]))."""
    a = np.where(present, lengths, np.inf)
    return np.minimum(d, (a + d[None, :]).min(axis=1))


def test_gnn_arm_at_its_cpu_config_matches_reference():
    """Two plus_times graph-convolution rounds and min_plus Bellman-Ford
    (integer lengths) over the skewed adjacency, handed over as ELL."""
    m, feat = 256, 32
    jcsr = JBCSR.random_skewed(seed=5, shape=(m, m), block_shape=(16, 16), total_blocks=56,
                               skew=0.8)
    csr = BlockCSRMatrix.random_skewed(5, (m, m), (16, 16), 56, skew=0.8, device="cpu")
    jadj, adj = jcsr.to_bsr(), csr.to_bsr()
    pmxm.reset_mxm_cache()
    plan = pmxm.mxm_plan(adj, feat)
    assert (plan.source_layout, plan.layout) == ("ell", "bcsr")
    assert plan.grid_steps < plan.xla_equiv_grid_steps

    rng = np.random.default_rng(5)
    h0 = rng.random((m, feat), dtype=np.float32)
    ws = rng.uniform(-0.5, 0.5, (2, feat, feat)).astype(np.float32)
    jh, h, ho = jnp.asarray(h0), t(h0), t(h0)
    for r in range(2):
        jh = jnp.maximum(jgb.mxm(jadj, jh @ jnp.asarray(ws[r]), jsr.PLUS_TIMES), 0.0)
        h = torch.clamp_min(gb.mxm(adj, h @ t(ws[r])), 0.0)
        ho = torch.clamp_min(gb.mxm(adj, ho @ t(ws[r]), use_kernel=False), 0.0)
    scale = max(float(np.abs(np.asarray(jh)).max()), 1.0)
    assert float(np.abs(h.numpy() - np.asarray(jh)).max()) / scale <= 1e-5
    assert float((h - ho).abs().max()) / scale <= 1e-5
    assert pmxm.mxm_cache_stats()["hits"] >= 2  # rounds reuse the plan

    lengths = np.round(np.abs(csr.values.numpy()) * 2.0).astype(np.float32)
    lcsr = BlockCSRMatrix(t(lengths), csr.row_ptr, csr.row_id, csr.col_idx, csr.valid,
                          csr.shape, csr.block_shape)
    jl = JBCSR(jnp.asarray(lengths), jcsr.row_ptr, jcsr.row_id, jcsr.col_idx, jcsr.valid,
               jcsr.shape, jcsr.block_shape)
    adj_len, jadj_len = lcsr.to_bsr(), jl.to_bsr()
    ones = BlockCSRMatrix(torch.ones_like(lcsr.values), *[getattr(lcsr, f) for f in
                          ("row_ptr", "row_id", "col_idx", "valid", "shape", "block_shape")])
    present = ones.to_dense().numpy() != 0
    dense_len = lcsr.to_dense().numpy()
    d = torch.full((m,), float("inf"))
    d[0] = 0.0
    jd, d_np = jnp.asarray(d.numpy()), d.numpy().copy()
    hits_before = pmxm.mxm_cache_stats()["hits"]
    for it in range(32):
        d_next = torch.minimum(d, gb.mxv(adj_len, d, sr.MIN_PLUS))
        jd = jnp.minimum(jd, jgb.mxv(jadj_len, jd, jsr.MIN_PLUS, use_kernel=False))
        d_np = _relax(present, dense_len, d_np)
        np.testing.assert_array_equal(d_next.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(d_next.numpy(), d_np)
        if torch.equal(d_next, d):
            break
        d = d_next
    assert 1 < it < 31 and bool(torch.isfinite(d).any())
    assert pmxm.mxm_cache_stats()["hits"] - hits_before == it  # one build, then hits

    frontier = torch.zeros(m)
    frontier[0] = 1.0
    step = gb.vxm(frontier, adj, sr.LOR_LAND)
    want = np.asarray(jgb.vxm(jnp.asarray(frontier.numpy()), jadj, jsr.LOR_LAND,
                              use_kernel=False))
    np.testing.assert_array_equal(step.numpy(), want)
    np.testing.assert_array_equal(step.numpy() != 0, present[0])  # row 0's edges


@pytest.mark.parametrize("dense", [False, True], ids=["ell", "dense"])
def test_three_call_dnn_matches_reference(dense):
    """Fig. 4's mxm / eWiseMult / eWiseAdd per layer, and the fused form,
    on the same RadiX-net stack (sparse through MxmPlans, or densified)."""
    spec = jrx.RadixNetSpec(64, 4)
    jw, jb = jrx.radixnet_weights(spec)
    if dense:
        jw = [w.to_dense() for w in jw]
    w = [torch.tensor(np.asarray(x)) if dense else convert.layout(x) for x in jw]
    b = [convert.bias(x) for x in jb]
    y0 = jrx.radixnet_input_panel(64, 24, density=0.3, seed=11)
    want = np.asarray(jdnn.dnn_forward(jw, jb, jnp.asarray(y0), fused=False))
    got = dnn.dnn_forward(w, b, t(y0), fused=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(rx.reference_categories(got.numpy()),
                          rx.radixnet_reference(spec, y0)[1])
    np.testing.assert_allclose(dnn.dnn_forward(w, b, t(y0)).numpy(), want, rtol=1e-5, atol=1e-6)
    ys = dnn.dnn_forward_all(w, b, t(y0), fused=False)
    assert len(ys) == 5 and torch.equal(ys[-1], got) and torch.equal(ys[0], t(y0))


def test_engine_serves_a_dense_stack_through_kernel_dense():
    spec = jrx.RadixNetSpec(64, 4)
    jw, jb = jrx.radixnet_weights(spec)
    dense = {id(x): x.to_dense() for x in jw}  # shared phases stay shared
    port_dense = {k: torch.tensor(np.asarray(v)) for k, v in dense.items()}
    w = [port_dense[id(x)] for x in jw]
    y0 = jrx.radixnet_input_panel(64, 40, density=0.3, seed=2)
    engine = SparseDNNEngine(w, [convert.bias(x) for x in jb], batch_align=8, device="cpu")
    out, stats = engine.infer(t(y0))
    assert stats["plan"]["route"] == "layered" and stats["kernel_launches"] == 4
    want = np.asarray(jdnn.dnn_forward([dense[id(x)] for x in jw], jb, jnp.asarray(y0)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def _scan_net(seed: int, L: int, m: int = 32, sparse: bool = True):
    """The reference's ``test_dnn._mk_net`` stack: L layers of U[-1, 3)
    weights (ELL, 2 of m/8 blocks a row, or dense) and U[0, 1) biases."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(seed), 2 * L)
    if sparse:
        ws = [JBSR.random(keys[2 * k], (m, m), (8, 8), blocks_per_row=2) for k in range(L)]
    else:
        ws = [jax.random.uniform(keys[2 * k], (m, m), minval=-1.0, maxval=3.0)
              for k in range(L)]
    bs = [jax.random.uniform(keys[2 * k + 1], (m,)) for k in range(L)]
    return ws, bs


@pytest.mark.parametrize("fused", [True, False], ids=["plan", "three-call"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "bsr"])
def test_scan_equals_loop(sparse, fused):
    """``dnn_forward_scan`` over a stacked stack equals the layer loop and
    the reference's scanned forward (its own tolerance)."""
    from repro_torch.plan.cache import reset_default_cache

    jws, jbs = _scan_net(8, L=5, sparse=sparse)
    y0 = np.random.default_rng(9).random((32, 8), dtype=np.float32)
    jstack = jdnn.stack_bsr(jws) if sparse else jnp.stack(jws)
    want = np.asarray(jdnn.dnn_forward_scan(jstack, jnp.stack(jbs), jnp.asarray(y0)))
    ws = [convert.layout(w) if sparse else t(np.array(w)) for w in jws]
    bs = [convert.bias(b) for b in jbs]
    stack = dnn.stack_bsr(ws) if sparse else torch.stack(ws)
    reset_default_cache()
    got = dnn.dnn_forward_scan(stack, torch.stack(bs), t(y0), fused=fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), dnn.dnn_forward(ws, bs, t(y0)).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_scan_builds_one_plan_for_any_depth():
    """The counterpart of the reference's "jits once for any depth": one
    plan build and one executable for a stack, whatever its depth, reused
    by every later call on it (the layer views are made once a stack)."""
    from repro_torch.plan.cache import default_cache, reset_default_cache

    y0 = t(np.random.default_rng(11).random((16, 4), dtype=np.float32))
    for L in (2, 6):
        reset_default_cache()
        jws, jbs = _scan_net(10, L=L, m=16)
        stack = dnn.stack_bsr([convert.layout(w) for w in jws])
        biases = torch.stack([convert.bias(b) for b in jbs])
        first = dnn.dnn_forward_scan(stack, biases, y0)
        again = dnn.dnn_forward_scan(stack, biases, y0)
        assert torch.equal(first, again)
        cache = default_cache()
        (plan,) = cache.plans()
        assert cache.builds == 1 and cache.hits == 1 and plan.compile_count == 1
        assert plan.n_layers == L
