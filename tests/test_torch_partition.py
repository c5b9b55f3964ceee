"""The port's block-CSR partitioner against the reference's, case by case.

Every case of the reference's ``tests/test_partition_properties.py``
(hypothesis, or ``tests/_hypothesis_fallback.py`` without it) and the
partition cases of ``tests/test_sharded.py`` run on both packages with
the same matrices: the reference's, converted through numpy. Beside the
reference's own assertions, which both sides must pass, the port's
integer tensors (``row_ptr``, ``row_id``, ``col_idx``, ``valid``,
``gather_index``, and each shard's transpose order) must equal the
reference's exactly and the values bit for bit.
"""

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import BlockCSRMatrix as JBCSR
from repro.sparse import BlockSparseMatrix as JBSR
from repro.sparse import partition_block_csr as jpartition
from repro.sparse import stack_transpose_plans as jstack_tps
from repro_torch import convert
from repro_torch.sparse.partition import (
    SHARDED_CSR_LEAVES,
    partition_block_csr,
    shard_transpose_plan,
    stack_transpose_plans,
)

BLOCK = 8  # the property tests' block


def _port(a):
    return convert.layout(a)


def _same_partition(j, t):
    """The port's partition equals the reference's: integers exactly,
    values bit for bit, the same shape and block shape."""
    assert t.shape == tuple(j.shape) and t.block_shape == tuple(j.block_shape)
    for name in SHARDED_CSR_LEAVES:
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(t.nnz_per_shard(), j.nnz_per_shard())
    assert t.imbalance() == j.imbalance()


def _random_bcsr(seed: int, nrb: int, density: float):
    """The property test's seeded random block-occupancy pattern."""
    rng = np.random.default_rng(seed)
    occ = rng.random((nrb, nrb)) < density
    occ[rng.integers(nrb), rng.integers(nrb)] = True
    m = nrb * BLOCK
    dense = np.zeros((m, m), np.float32)
    for i, j in zip(*np.nonzero(occ)):
        dense[i * BLOCK:(i + 1) * BLOCK, j * BLOCK:(j + 1) * BLOCK] = rng.standard_normal(
            (BLOCK, BLOCK))
    return JBCSR.from_bsr(JBSR.from_dense(jnp.asarray(dense), (BLOCK, BLOCK)))


def _invariants(a, sharded, n_shards):
    """The property test's assertions, on either package (numpy views)."""
    np_ = (lambda x: np.asarray(x)) if isinstance(sharded.values, jax.Array) else (
        lambda x: x.numpy())
    valid_src = np_(a.valid)
    nnz = int(valid_src.sum())
    per = sharded.nnz_per_shard()
    assert int(per.sum()) == nnz
    assert int(per.max() - per.min()) <= 1
    assert sharded.imbalance() <= 1.0 + n_shards / max(nnz, 1) + 1e-12
    mask = np_(sharded.valid)
    gidx = np_(sharded.gather_index)[mask]
    np.testing.assert_array_equal(np.sort(gidx), np.nonzero(valid_src)[0])
    local = np.diff(np_(sharded.row_ptr), axis=1)
    src_rows = np_(a.row_id)[valid_src]
    np.testing.assert_array_equal(local.sum(axis=0),
                                  np.bincount(src_rows, minlength=a.n_row_blocks))
    np.testing.assert_array_equal(np_(sharded.to_dense()), np_(a.to_dense()))
    np.testing.assert_array_equal(np_(sharded.rescatter_values(a.values)), np_(sharded.values))


@hypothesis.given(data=st.data())
@hypothesis.settings(deadline=None, max_examples=30)
def test_partition_block_csr_invariants(data):
    seed = data.draw(st.integers(0, 2**16 - 1), label="seed")
    nrb = data.draw(st.integers(1, 6), label="row_blocks")
    density = data.draw(st.floats(0.05, 1.0), label="density")
    n_shards = data.draw(st.integers(1, 9), label="shards")
    ja = _random_bcsr(seed, nrb, density)
    ta = _port(ja)
    js, ts = jpartition(ja, n_shards), partition_block_csr(ta, n_shards)
    _invariants(ja, js, n_shards)
    _invariants(ta, ts, n_shards)
    _same_partition(js, ts)


def test_degenerate_zero_nnz_shards_validate():
    ja = JBCSR.from_bsr(JBSR.random(jax.random.PRNGKey(0), (16, 16), (BLOCK, BLOCK),
                                    blocks_per_row=1))
    ta = _port(ja)
    nnz = int(np.asarray(ja.valid).sum())
    js, ts = jpartition(ja, nnz + 3), partition_block_csr(ta, nnz + 3)
    _same_partition(js, ts)
    per = ts.nnz_per_shard()
    assert int(per.sum()) == nnz and (per <= 1).all()
    for s in range(ts.n_shards):
        sub = ts.shard(s)
        if per[s] == 0:
            assert not bool(ts.valid[s].any())
            assert int(ts.row_ptr[s].sum()) == 0
            assert not bool(sub.to_dense().any())
    torch.testing.assert_close(ts.to_dense(), ta.to_dense(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="n_shards"):
        partition_block_csr(ta, 0)


def test_partition_balances_and_reassembles():
    ja = JBCSR.random_skewed(seed=3, shape=(128, 128), block_shape=(16, 16),
                             total_blocks=40, skew=0.9)
    ta = _port(ja)
    ts = partition_block_csr(ta, 8)
    _same_partition(jpartition(ja, 8), ts)
    assert ts.n_shards == 8
    assert ts.imbalance() <= 1.10
    assert int(ts.nnz_per_shard().sum()) == ta.nnz_blocks()
    torch.testing.assert_close(ts.to_dense(), ta.to_dense(), rtol=0, atol=0)


def test_partition_degenerate_zero_nnz_shards():
    m, block = 64, 16
    dense = jnp.zeros((m, m)).at[:block, :block].set(1.0)
    ja = JBCSR.from_dense(dense, (block, block))  # 1 stored block
    ta = _port(ja)
    ts = partition_block_csr(ta, 8)
    _same_partition(jpartition(ja, 8), ts)
    nnz = ts.nnz_per_shard()
    assert int(nnz.sum()) == 1 and (nnz == 0).sum() == 7
    for s in range(1, 8):
        local = ts.shard(s)
        assert not bool(local.valid.any())
        assert int(local.row_ptr.max()) == 0
    np.testing.assert_array_equal(ts.to_dense().numpy(), np.asarray(dense))


def _csr_layer(seed, m=64, bpr=4, block=16):
    """One layer of the reference's ``_csr_stack`` (test_sharded.py)."""
    (k,) = jax.random.split(jax.random.PRNGKey(seed), 1)
    w = JBSR.random(k, (m, m), (block, block), blocks_per_row=bpr, minval=-0.5, maxval=0.5)
    return JBCSR.from_bsr(w.map_blocks(lambda x: x / (bpr * block) ** 0.5))


def test_partition_rescatter_roundtrip_and_grad():
    ja = _csr_layer(1)
    ta = _port(ja)
    ts = partition_block_csr(ta, 4)
    _same_partition(jpartition(ja, 4), ts)
    torch.testing.assert_close(ts.rescatter_values(ta.values), ts.values, rtol=0, atol=0)
    v = ta.values.clone().requires_grad_()
    (g,) = torch.autograd.grad((ts.rescatter_values(v) ** 2).sum(), v)
    torch.testing.assert_close(g, 2.0 * ta.values, rtol=1e-6, atol=0)
    jg = jax.grad(lambda v: jnp.sum(jpartition(ja, 4).rescatter_values(v) ** 2))(ja.values)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_rescatter_gradient_skips_tail_slots_and_is_exact():
    """A source with tail padding: the backward writes each valid slot's
    cotangent once (no accumulation) and leaves the tail slots 0."""
    ja = JBCSR.from_bsr(JBSR.random(jax.random.PRNGKey(5), (64, 64), (16, 16),
                                    blocks_per_row=2), pad_to=11)
    ta = _port(ja)
    ts = partition_block_csr(ta, 3)
    _same_partition(jpartition(ja, 3), ts)
    seed = torch.Generator().manual_seed(0)
    cot = torch.randn(ts.values.shape, generator=seed)
    v = ta.values.clone().requires_grad_()
    (g,) = torch.autograd.grad((ts.rescatter_values(v) * cot).sum(), v)
    want = torch.zeros_like(ta.values)
    valid = ts.valid
    want[ts.gather_index[valid].long()] = cot[valid]
    assert torch.equal(g, want)
    assert not bool(g[~ta.valid].any())


def test_stacked_transpose_plans_match_per_shard():
    ja = _csr_layer(2)
    ta = _port(ja)
    ts = partition_block_csr(ta, 4)
    stacked = stack_transpose_plans(ts)
    jstacked = jstack_tps(jpartition(ja, 4))
    assert stacked.order.shape[0] == 4
    for name in ("order", "row_ptr", "row_id", "col_idx", "valid"):
        np.testing.assert_array_equal(getattr(stacked, name).numpy(),
                                      np.asarray(getattr(jstacked, name)), err_msg=name)
    for s in range(4):
        got = shard_transpose_plan(stacked, s).apply(ts.shard(s))
        want = ts.shard(s).transpose()
        torch.testing.assert_close(got.to_dense(), want.to_dense(), rtol=0, atol=0)
