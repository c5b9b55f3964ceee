"""The port's semiring registry against ``repro.core.semiring``.

Same numpy inputs through both registries: the generalized ``matmul``,
``vecmat``/``matvec``, ⊕/⊗ and the ⊕-reduce, in all eight semirings.
Integer-valued inputs keep every semiring but ``log_plus`` exact; the
boolean semirings return bool in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro_torch.core import semiring as sr
from repro_torch.kernels import semirings as ksr

NAMES = sorted(jsr.REGISTRY)


def _same(name, got, want):
    want = np.asarray(want)
    assert (got.dtype == torch.bool) == (want.dtype == np.bool_), (got.dtype, want.dtype)
    if name == "log_plus":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_registry_matches_reference():
    assert sorted(sr.REGISTRY) == NAMES
    for name in NAMES:
        a, b = sr.get_semiring(name), jsr.get_semiring(name)
        assert (a.zero, a.one) == (float(b.zero), float(b.one))
    with pytest.raises(KeyError, match="available"):
        sr.get_semiring("no_such")


@pytest.mark.parametrize("name", NAMES)
def test_products_match_reference(name):
    rng = np.random.default_rng(1)
    a = rng.integers(-3, 4, (2, 9, 17)).astype(np.float32)  # a batch dim
    b = rng.integers(-3, 4, (2, 17, 6)).astype(np.float32)
    v = rng.integers(-3, 4, 17).astype(np.float32)
    p, j = sr.get_semiring(name), jsr.get_semiring(name)
    t = torch.from_numpy
    _same(name, p.matmul(t(a), t(b)), j.matmul(jnp.asarray(a), jnp.asarray(b)))
    _same(name, p.matvec(t(a[0]), t(v)), j.matvec(jnp.asarray(a[0]), jnp.asarray(v)))
    _same(name, p.vecmat(t(v), t(b[1])), j.vecmat(jnp.asarray(v), jnp.asarray(b[1])))
    _same(name, p.add(t(a[0]), t(a[1])), j.add(jnp.asarray(a[0]), jnp.asarray(a[1])))
    _same(name, p.mul(t(a[0]), t(a[1])), j.mul(jnp.asarray(a[0]), jnp.asarray(a[1])))
    _same(name, p.add_reduce(t(a[0]), 0), j.add_reduce(jnp.asarray(a[0]), axis=0))
    _same(name, p.add_reduce(t(a)), j.add_reduce(jnp.asarray(a)))


@pytest.mark.parametrize("name", NAMES)
def test_chunked_contraction_equals_one_slab(name, monkeypatch):
    """The contraction axis is cut into slabs to bound the broadcast; any
    slab size gives the one-slab result (log_plus to f32 roundoff)."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.integers(-3, 4, (7, 50)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-3, 4, (50, 5)).astype(np.float32))
    for s in (sr.get_semiring(name), ksr.kernel_semiring(name)):
        whole = s.matmul(a, b)
        monkeypatch.setattr(sr, "_CHUNK_ELEMS", 7 * 5 * 3)  # slabs of 3
        sliced = s.matmul(a, b)
        monkeypatch.undo()
        _same(name, sliced, whole.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_f32_lowering_is_the_encoding_of_the_algebra(name):
    """The kernels' f32 lowering gives the registry's answer, booleans as
    {0, 1}; ⊗ canonicalises raw values (and NaN) with != 0."""
    rng = np.random.default_rng(3)
    a = rng.integers(-3, 4, (6, 11)).astype(np.float32)
    a[0, 0] = np.nan if name in ("lor_land", "xor_and") else a[0, 0]
    b = torch.from_numpy(rng.integers(-3, 4, (11, 4)).astype(np.float32))
    got = ksr.kernel_semiring(name).matmul(torch.from_numpy(a), b)
    assert got.dtype == torch.float32
    want = jsr.get_semiring(name).matmul(jnp.asarray(a), jnp.asarray(b.numpy()))
    _same(name, got, np.asarray(want).astype(np.float32))


def test_nan_and_infinity_rules_follow_jnp():
    nan, inf = float("nan"), float("inf")
    x = torch.tensor([[nan, 1.0, -inf]])
    y = torch.tensor([[2.0], [3.0], [-inf]])
    for name in ("max_plus", "min_plus", "max_min", "min_max"):
        assert torch.isnan(sr.get_semiring(name).matmul(x, y)).all(), name
    lp = sr.LOG_PLUS.matmul(torch.tensor([[-inf, -inf]]), torch.tensor([[0.0], [0.0]]))
    assert lp.item() == -inf  # logaddexp(-inf, -inf) is -inf, not NaN
