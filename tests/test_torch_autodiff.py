"""Autograd of the port's SpMM kernels against the reference's custom VJPs.

The cases of ``tests/test_autodiff.py`` on inputs converted through
numpy: the port's gradients (its autograd Functions, whose forward on
this CPU host runs the kernels' plain versions) against ``jax.grad`` of
the reference (its Pallas kernels in interpret mode, or its XLA oracle
where the port's case is the plain path too). Layouts: ELL with pad
slots, block-CSR with an empty block-row and tail padding, dense, and a
mixed stack.

Tolerances: one SpMM with a sin/cos loss ``rtol=atol=1e-4`` (the
reference's own bound: f32, the products sum in another order); a
three-layer stack's loss ``rtol=1e-5`` and gradients ``rtol=1e-4,
atol=1e-5``; the backward helpers ``rtol=atol=1e-5``; f32 central
differences within 1e-2 (the reference's ``check_grads`` bound). The
gradient outside the stored pattern, and the dX rows of empty rows of
Aᵀ, are held to exactly 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.kernels import ops as jkops
from repro.models import layers as jlayers
from repro.plan import DegradationLadder as JLadder
from repro.plan import PlanCache as JPlanCache
from repro.plan import build_plan as jbuild_plan
from repro.serve.engine import SparseDNNEngine as JEngine
from repro.sparse import ops as jsops
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.core import dnn
from repro_torch.kernels import ops
from repro_torch.plan import DegradationLadder, PlanCache, build_plan
from repro_torch.serve import SparseDNNEngine
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix
from repro_torch.sparse import ops as sops
from repro_torch.sparse.bcsr import reset_transpose_sort_count, transpose_sort_count

SPMM_TOL = dict(rtol=1e-4, atol=1e-4)
STACK_TOL = dict(rtol=1e-4, atol=1e-5)
HELPER_TOL = dict(rtol=1e-5, atol=1e-5)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _random_bsr(seed, shape, block, bpr, scale=0.3):
    """The reference test's ``_random_bsr``, and the port's conversion of it."""
    a = JBSR.random(jax.random.PRNGKey(seed), shape, block, blocks_per_row=bpr)
    a = a.map_blocks(lambda x: x * scale)
    return a, convert.layout(a)


def _skewed_bcsr(m, k, block, *, empty_col=None):
    """Block-CSR with an empty block-row AND invalid tail padding (the
    reference test's ``_skewed_bcsr``), optionally an empty block-column
    (an empty row of Aᵀ); reference and port."""
    nrb, ncb = m // block, k // block
    dense = np.zeros((m, k), np.float32)
    rng = np.random.default_rng(0)
    for i in range(nrb):
        if i == 1:
            continue  # empty block-row
        cols = [c for c in range(ncb) if c != empty_col]
        cols = rng.choice(cols, size=min(2 + (i % 2), len(cols)), replace=False)
        for c in cols:
            dense[i * block:(i + 1) * block, c * block:(c + 1) * block] = (
                rng.uniform(-0.5, 0.5, (block, block)))
    c = JBCSR.from_dense(jnp.asarray(dense), (block, block))
    jc = JBCSR.from_dense(jnp.asarray(dense), (block, block), pad_to=c.total_blocks + 3)
    return dense, jc, convert.layout(jc)


def _port_grads(fn, *tensors):
    leaves = [x.detach().clone().requires_grad_() for x in tensors]
    fn(*leaves).backward()
    return [x.grad for x in leaves]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **tol)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_relu"])
@pytest.mark.parametrize("m,k,block,bpr", [(32, 48, (8, 8), 2), (32, 64, (8, 16), 3)])
def test_bsr_spmm_grad_matches_reference(m, k, block, bpr, fused):
    ja, pa = _random_bsr(m + k, (m, k), block, bpr)
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (k, 20)))
    bias = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (m,)))

    def ref_loss(blocks, b_, bias_):
        aa = JBSR(blocks, ja.col_idx, ja.block_mask, ja.shape, ja.block_shape)
        return jnp.sum(jnp.sin(jkops.bsr_spmm(aa, b_, bias_ if fused else None,
                                              fuse_bias_relu=fused)))

    def port_loss(blocks, b_, bias_):
        aa = dataclasses.replace(pa, blocks=blocks)
        return torch.sum(torch.sin(ops.bsr_spmm(aa, b_, bias_ if fused else None,
                                                fuse_bias_relu=fused)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(ja.blocks, jnp.asarray(b), jnp.asarray(bias))
    got = _port_grads(port_loss, pa.blocks, t(b), t(bias))
    for g, w in zip(got[:2], want[:2]):
        _close(g, w, SPMM_TOL)
    if fused:
        _close(got[2], want[2], SPMM_TOL)
    else:
        assert got[2] is None  # the bias takes no part without the epilogue


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_relu"])
def test_bcsr_spmm_grad_matches_reference(fused):
    _, jc, pc = _skewed_bcsr(48, 32, 8)
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (32, 24)))
    bias = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (48,)))

    def ref_loss(values, b_, bias_):
        cc = JBCSR(values, jc.row_ptr, jc.row_id, jc.col_idx, jc.valid, jc.shape, jc.block_shape)
        return jnp.sum(jnp.cos(jkops.bcsr_spmm(cc, b_, bias_ if fused else None,
                                               fuse_bias_relu=fused)))

    def port_loss(values, b_, bias_):
        cc = dataclasses.replace(pc, values=values)
        return torch.sum(torch.cos(ops.bcsr_spmm(cc, b_, bias_ if fused else None,
                                                 fuse_bias_relu=fused)))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jc.values, jnp.asarray(b), jnp.asarray(bias))
    got = _port_grads(port_loss, pc.values, t(b), t(bias))
    _close(got[0], want[0], SPMM_TOL)
    _close(got[1], want[1], SPMM_TOL)
    if fused:
        _close(got[2], want[2], SPMM_TOL)


@pytest.mark.parametrize("layout", ["ell", "bcsr"])
def test_spmm_finite_differences(layout):
    """Directional central differences in f32 (the kernels are f32-only),
    within the reference's ``check_grads`` bound of 1e-2."""
    if layout == "ell":
        _, w = _random_bsr(5, (16, 16), (8, 8), 2)
        field, kern = "blocks", ops.bsr_spmm
    else:
        _, _, w = _skewed_bcsr(16, 16, 8)
        field, kern = "values", ops.bcsr_spmm
    rng = np.random.default_rng(6)
    b = t(rng.standard_normal((16, 8)).astype(np.float32))
    vals = getattr(w, field)

    def f(v, b_):
        return torch.sum(kern(dataclasses.replace(w, **{field: v}), b_) ** 2)

    gv, gb = _port_grads(f, vals, b)
    dv = t(rng.standard_normal(vals.shape).astype(np.float32))
    db = t(rng.standard_normal(b.shape).astype(np.float32))
    eps = 1e-2
    num = (f(vals + eps * dv, b + eps * db) - f(vals - eps * dv, b - eps * db)) / (2 * eps)
    ana = (gv * dv).sum() + (gb * db).sum()
    assert abs(float(num) - float(ana)) <= 1e-2 * max(1.0, abs(float(ana))), (num, ana)


def test_weight_cotangent_pattern_equals_primal():
    """The gradient lives exactly in the primal's pattern, and matches the
    reference's cotangent there."""
    ja, _ = _random_bsr(8, (32, 32), (8, 8), 2)
    jwide = JBSR.from_dense(ja.to_dense(), (8, 8), pad_to=4)
    wide = convert.layout(jwide)
    assert not bool(wide.block_mask.all())
    b = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (32, 12)))
    want = jax.grad(lambda aa: jnp.sum(jkops.bsr_spmm(aa, jnp.asarray(b)) ** 2),
                    allow_int=True)(jwide)
    (g,) = _port_grads(lambda v: torch.sum(ops.bsr_spmm(
        dataclasses.replace(wide, blocks=v), t(b)) ** 2), wide.blocks)
    assert float(g[~wide.block_mask].abs().max()) == 0.0
    assert float(g[wide.block_mask].abs().max()) > 0.0
    _close(g, want.blocks, SPMM_TOL)

    _, jc, c = _skewed_bcsr(32, 32, 8)
    assert not bool(c.valid.all())
    want_c = jax.grad(lambda cc: jnp.sum(jkops.bcsr_spmm(cc, jnp.asarray(b)) ** 2),
                      allow_int=True)(jc)
    (gc,) = _port_grads(lambda v: torch.sum(ops.bcsr_spmm(
        dataclasses.replace(c, values=v), t(b)) ** 2), c.values)
    assert float(gc[~c.valid].abs().max()) == 0.0
    assert float(gc.abs().max()) > 0.0
    _close(gc, want_c.values, SPMM_TOL)
    # the converted reference cotangent, in the port's class
    ref_cot = convert.cotangent(want_c, c)
    assert ref_cot.row_ptr is c.row_ptr and ref_cot.values.shape == gc.shape


def test_backward_helpers_match_reference():
    ja, pa = _random_bsr(10, (32, 48), (8, 8), 3)
    rng = np.random.default_rng(11)
    y = rng.standard_normal((32, 10)).astype(np.float32)
    b = rng.standard_normal((48, 10)).astype(np.float32)
    _close(sops.bsr_transpose_matmul(pa, t(y)), jsops.bsr_transpose_matmul(ja, jnp.asarray(y)),
           HELPER_TOL)
    _close(sops.bsr_weight_cotangent(pa, t(y), t(b)),
           jsops.bsr_weight_cotangent(ja, jnp.asarray(y), jnp.asarray(b)), HELPER_TOL)
    _, jc, pc = _skewed_bcsr(48, 32, 8)
    yc = rng.standard_normal((48, 10)).astype(np.float32)
    bc = rng.standard_normal((32, 10)).astype(np.float32)
    _close(sops.bcsr_transpose_matmul(pc, t(yc)),
           jsops.bcsr_transpose_matmul(jc, jnp.asarray(yc)), HELPER_TOL)
    _close(sops.bcsr_weight_cotangent(pc, t(yc), t(bc)),
           jsops.bcsr_weight_cotangent(jc, jnp.asarray(yc), jnp.asarray(bc)), HELPER_TOL)
    # the transposed product runs the same math as the kernel on the transpose
    torch.testing.assert_close(sops.bcsr_transpose_matmul(pc, t(yc)),
                               ops.bcsr_spmm(pc.transpose(), t(yc)), **HELPER_TOL)


@pytest.mark.parametrize("with_plan", [False, True], ids=["sorted", "plan"])
def test_empty_transpose_rows_get_exactly_zero_dx(with_plan):
    """Rows of Aᵀ with no stored block (an empty block-column of A) give
    dX rows of exactly 0, and the cached transpose sorts nothing."""
    _, jc, pc = _skewed_bcsr(48, 40, 8, empty_col=2)
    tp = pc.transpose_plan() if with_plan else None
    # the kernels read row-major blocks: the transpose's values are contiguous
    assert (pc.transpose() if tp is None else tp.apply(pc)).values.is_contiguous()
    rng = np.random.default_rng(12)
    b = t(rng.standard_normal((40, 16)).astype(np.float32))
    bias = t(rng.standard_normal(48).astype(np.float32))
    reset_transpose_sort_count()
    (gb,) = _port_grads(lambda b_: ops.bcsr_spmm(pc, b_, bias, tp, fuse_bias_relu=True).sum(), b)
    assert transpose_sort_count() == (0 if with_plan else 1)
    assert bool((gb[16:24] == 0).all()) and float(gb.abs().max()) > 0
    want = jax.grad(lambda b_: jkops.bcsr_spmm(jc, b_, jnp.asarray(bias.numpy()),
                                               fuse_bias_relu=True).sum())(jnp.asarray(b.numpy()))
    _close(gb, want, SPMM_TOL)


def _stack(kind, m=32, bs=8, layers=3):
    """Reference and port stacks of three m x m layers: ``kind`` picks the
    layouts (mixed: ELL, block-CSR with tail slots, dense)."""
    rng = np.random.default_rng(20)
    kinds = {"ell": ["ell"] * layers, "bcsr": ["bcsr"] * layers, "dense": ["dense"] * layers,
             "mixed": ["ell", "bcsr", "dense"]}[kind]
    jws, pws = [], []
    for i, lay in enumerate(kinds):
        ja, _ = _random_bsr(30 + i, (m, m), (bs, bs), 2)
        if lay == "bcsr":
            ja = JBCSR.from_bsr(ja, pad_to=int(ja.block_mask.sum()) + 2)
        elif lay == "dense":
            ja = ja.to_dense()
        jws.append(ja)
        pws.append(convert.weight(ja))
    biases = [rng.standard_normal(m).astype(np.float32) * 0.1 for _ in kinds]
    y0 = rng.random((m, 8), dtype=np.float32)
    targets = rng.random((m, 8), dtype=np.float32)
    return jws, pws, biases, y0, targets


def _values(w):
    return w.values if hasattr(w, "row_ptr") else (w.blocks if hasattr(w, "block_mask") else w)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("kind", ["ell", "bcsr", "dense", "mixed"])
def test_dnn_value_and_grad_matches_reference(kind, use_kernel):
    jws, pws, biases, y0, targets = _stack(kind)
    loss, (dws, dbs) = dnn.dnn_value_and_grad(pws, [t(b) for b in biases], t(y0), t(targets),
                                              use_kernel=use_kernel)
    jloss, (jdws, jdbs) = jdnn.dnn_value_and_grad(
        jws, [jnp.asarray(b) for b in biases], jnp.asarray(y0), jnp.asarray(targets),
        use_kernel=use_kernel)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for w, g, jg in zip(pws, dws, jdws):
        assert type(g) is type(w)
        _close(_values(g), _values(jg), STACK_TOL)
        if isinstance(w, (BlockSparseMatrix, BlockCSRMatrix)):
            off = _values(g)[~(w.block_mask if hasattr(w, "block_mask") else w.valid)]
            assert off.numel() == 0 or float(off.abs().max()) == 0.0
            assert g.col_idx is w.col_idx  # the primal's own topology tensors
    for g, jg in zip(dbs, jdbs):
        _close(g, jg, STACK_TOL)


def test_non_plus_times_semirings_refuse_grad():
    _, pa = _random_bsr(40, (16, 16), (8, 8), 2)
    y = torch.ones(16, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="plus_times"):
        ops.bsr_spmm(pa, y, semiring_name="min_plus")
    with pytest.raises(NotImplementedError, match="plus_times"):
        ops.bcsr_spmm(BlockCSRMatrix.from_bsr(pa), y, semiring_name="max_plus")
    with torch.no_grad():  # serving: the forward-only path, no graph
        out = ops.bsr_spmm(pa, y, semiring_name="min_plus")
        assert out.grad_fn is None
        assert ops.bsr_spmm(pa, y).grad_fn is None


@pytest.mark.parametrize("kern", [ops.fused_mlp_forward, ops.fused_mlp_tiled_forward],
                         ids=["resident", "tiled"])
def test_fused_mlp_grad_raises(kern):
    ws = [_random_bsr(40 + i, (32, 32), (8, 8), 2)[1] for i in range(2)]
    stacked = dnn.stack_bsr(ws)
    sb = torch.zeros(2, 32)
    y0 = torch.rand(32, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="dnn_forward_trainable"):
        kern(stacked, sb, y0)


def test_serve_engine_differentiable_routing():
    pairs = [_random_bsr(50 + i, (32, 32), (8, 8), 2) for i in range(2)]
    jws, ws = [p[0] for p in pairs], [p[1] for p in pairs]
    bs = [np.zeros(32, np.float32) for _ in ws]
    y = np.random.default_rng(51).random((32, 4), dtype=np.float32)
    assert jdnn.resident_eligible(jws)
    jeng = JEngine(jws, [jnp.asarray(b) for b in bs], batch_align=8, differentiable=True)
    _, jstats = jeng.infer(jnp.asarray(y))
    eng = SparseDNNEngine(ws, [t(b) for b in bs], batch_align=8, differentiable=True,
                          device="cpu")
    out, stats = eng.infer(t(y))
    assert stats["resident"] is False and stats["differentiable"] is True
    assert stats["plan"]["route"] == jstats["plan"]["route"] == "layered"
    assert out.shape == (32, 4)
    # a plain engine on the same stack serves the fused route
    assert SparseDNNEngine(ws, [t(b) for b in bs], device="cpu").infer(t(y))[1]["plan"][
        "route"] == "fused"
    with pytest.raises(ValueError, match="no VJP"):
        SparseDNNEngine(ws, [t(b) for b in bs], use_resident=True, differentiable=True,
                        device="cpu")


def test_serve_engine_differentiable_with_dense_layer():
    """A dense layer in a differentiable engine takes the plain fused form
    (``xla-dense``); the input gradient matches the reference engine's."""
    ja, pa = _random_bsr(60, (32, 32), (8, 8), 2)
    dense = np.asarray(jax.random.normal(jax.random.PRNGKey(61), (32, 32))) * 0.1
    bs = [np.full(32, 0.05, np.float32) for _ in range(2)]
    y0 = np.asarray(jax.random.uniform(jax.random.PRNGKey(62), (32, 4)))
    jeng = JEngine([ja, jnp.asarray(dense)], [jnp.asarray(b) for b in bs], batch_align=4,
                   differentiable=True)
    want = jax.grad(lambda y: jnp.sum(jeng.infer(y)[0]))(jnp.asarray(y0))
    eng = SparseDNNEngine([pa, t(dense)], [t(b) for b in bs], batch_align=4,
                          differentiable=True, device="cpu")
    (g,) = _port_grads(lambda y: eng.infer(y)[0].sum(), t(y0))
    assert g.shape == y0.shape and float(g.abs().max()) > 0.0
    _close(g, want, STACK_TOL)
    plan, *_ = eng._ladder.get_plan(eng.weights, eng.biases, 4, differentiable=True)
    assert [lp.path for lp in plan.layers] == ["kernel-ell", "xla-dense"]
    assert plan.kernel_launches == 1


@pytest.mark.parametrize("kind", ["ell", "bcsr", "dense", "mixed"])
def test_differentiable_plans_route_like_reference(kind):
    jws, pws, biases, y0, targets = _stack(kind)
    jplan = jbuild_plan(jws, [jnp.asarray(b) for b in biases], 8, differentiable=True)
    reset_transpose_sort_count()
    plan = build_plan(pws, [t(b) for b in biases], 8, differentiable=True)
    assert plan.route == jplan.route
    assert [lp.path for lp in plan.layers] == [lp.path for lp in jplan.layers]
    assert plan.layouts == jplan.layouts  # the caller's layouts, never relayouted
    # the reference caches the block-CSR layers' transposes; the port also
    # each ELL layer's, whose dX it launches on it (ROADMAP Queue 3)
    assert [tp is not None for tp in plan.transpose_plans] == [
        tp is not None or isinstance(w, BlockSparseMatrix)
        for tp, w in zip(jplan.transpose_plans, pws)]
    assert transpose_sort_count() == sum(tp is not None for tp in plan.transpose_plans)
    assert plan.differentiable and plan.key.differentiable
    assert not build_plan(pws, [t(b) for b in biases], 8).differentiable
    # the trainable forward through the plan sorts nothing more
    bl = [t(b) for b in biases]
    built = transpose_sort_count()
    loss, (dws, _) = dnn.dnn_value_and_grad(pws, bl, t(y0), t(targets), plan=plan)
    assert transpose_sort_count() == built
    loss2, (dws2, _) = dnn.dnn_value_and_grad(pws, bl, t(y0), t(targets))
    # without a plan each sparse layer past the first (whose dX the loss
    # does not need) sorts its topology again
    assert transpose_sort_count() == built + sum(
        isinstance(w, (BlockCSRMatrix, BlockSparseMatrix)) for w in pws[1:])
    torch.testing.assert_close(loss, loss2)
    for g, g2 in zip(dws, dws2):
        torch.testing.assert_close(_values(g), _values(g2))
    torch.testing.assert_close(plan.forward_trainable(pws, bl, t(y0)),
                               dnn.dnn_forward_trainable(pws, bl, t(y0)))
    with pytest.raises(ValueError, match="not differentiable"):
        dnn.dnn_forward_trainable(pws, bl, t(y0), plan=build_plan(pws, bl, 8))


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "plain"])
@pytest.mark.parametrize("layout", ["ell", "bcsr"])
def test_linear_grad_matches_reference(layout, use_kernel):
    """The reference's ``layers.linear`` (x @ Wᵀ + b on a sparse W) against
    the port's SpMM on xᵀ: the same product, so the same gradients."""
    if layout == "bcsr":
        _, jw, pw = _skewed_bcsr(32, 48, 8)
        field = "values"
    else:
        jw, pw = _random_bsr(15, (32, 48), (8, 8), 2)
        field = "blocks"
    rng = np.random.default_rng(13)
    x = rng.standard_normal((5, 48)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    kern = ops.bcsr_spmm if layout == "bcsr" else ops.bsr_spmm

    def ref_loss(v, x_, b_):
        ww = dataclasses.replace(jw, **{field: v})
        return jnp.sum(jlayers.linear(ww, x_, b_, use_kernel=use_kernel) ** 2)

    def port_loss(v, x_, b_):
        ww = dataclasses.replace(pw, **{field: v})
        z = (kern(ww, x_.T) if use_kernel else
             (sops.bcsr_matmul(ww, x_.T) if layout == "bcsr" else sops.bsr_matmul(ww, x_.T)))
        return torch.sum((z + b_[:, None]).T ** 2)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(getattr(jw, field), jnp.asarray(x),
                                                 jnp.asarray(bias))
    got = _port_grads(port_loss, getattr(pw, field), t(x), t(bias))
    for g, w in zip(got, want):
        _close(g, w, SPMM_TOL)


def test_plain_relu_gradient_is_the_kernels_mask():
    """The plain ReLU keeps NaN (the engine's quarantine needs it) and its
    gradient is the kernels' backward mask ``out > 0``: 0 at exactly 0,
    where ``jnp.maximum`` splits 0.5."""
    x = torch.tensor([-1.0, 0.0, -0.0, 2.0, float("nan"), float("inf")], requires_grad=True)
    y = sops.relu(x)
    assert y[:4].tolist() == [0.0, 0.0, 0.0, 2.0] and bool(y[4].isnan()) and y[5] == float("inf")
    y[:4].sum().backward()
    assert x.grad[:4].tolist() == [0.0, 0.0, 0.0, 1.0]
    assert float(jax.grad(lambda v: jnp.maximum(v, 0.0))(0.0)) == 0.5


def test_plan_cache_and_ladder_key_differentiability_like_reference():
    """A differentiable and a serving plan of one stack are two cache
    entries; a second differentiable lookup hits, and the ladder never
    tries a resident level for a differentiable plan."""
    pairs = [_random_bsr(70 + i, (32, 32), (8, 8), 2) for i in range(2)]
    jws, ws = [p[0] for p in pairs], [p[1] for p in pairs]
    bs = [np.zeros(32, np.float32) for _ in ws]
    jbs, pbs = [jnp.asarray(b) for b in bs], [t(b) for b in bs]
    jcache, cache = JPlanCache(max_size=4), PlanCache(max_size=4)
    for diff in (True, False, True):
        jplan = jcache.get(jws, jbs, 8, differentiable=diff)
        plan = cache.get(ws, pbs, 8, differentiable=diff)
        assert plan.route == jplan.route and plan.differentiable is diff
    assert (cache.hits, cache.misses) == (jcache.hits, jcache.misses) == (1, 2)
    jplan, jlevel, _ = JLadder(JPlanCache(), use_resident=True).get_plan(
        jws, jbs, 8, differentiable=True)
    ladder = DegradationLadder(PlanCache(), use_resident=True)
    plan, level, _ = ladder.get_plan(ws, pbs, 8, differentiable=True)
    assert (plan.route, level) == (jplan.route, jlevel) == ("layered", "layered")
    assert ladder.is_healthy("resident") and not ladder.events  # it stays for serving
    assert ladder.get_plan(ws, pbs, 8)[0].route == "fused"
