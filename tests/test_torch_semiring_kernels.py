"""The port's three semiring kernels, in all eight semirings, against the
JAX package's Pallas kernels (interpret mode) on the same numpy inputs.

On this CPU-only host the port's wrappers run their plain versions, which
repeat the kernels' f32 arithmetic. Inputs are integer-valued, so every
order-independent semiring (and ``plus_times``, whose sums stay far below
2^24) must agree bit for bit; ``log_plus`` chains its reductions in
another order and is held to 1e-5, the reference's own ``TOL``
(tests/test_semiring_kernels.py). Operands carry the hazards the
kernels must survive for non-additive monoids: an empty block-row, ELL
pad slots (``col_idx = 0``, zero block, masked) and block-CSR tail
padding. Boolean semirings see raw integers, so ⊗'s ``!= 0``
canonicalisation is exercised too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.kernels import ops as jops
from repro.sparse import ops as jsparse
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.core import semiring as sr
from repro_torch.kernels import build, ops
from repro_torch.kernels import semirings as ksr
from repro_torch.sparse import ops as sparse_ops

NAMES = sorted(sr.REGISTRY)
TOL = {"log_plus": 1e-5}
BS = 8


def _assert_matches(name, got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if name in TOL:
        np.testing.assert_allclose(got, want, rtol=TOL[name], atol=TOL[name])
    else:
        np.testing.assert_array_equal(got, want)


def _operands(seed):
    """(ref ELL, ref block-CSR, port ELL, port block-CSR, panel) with an
    empty block-row (1), ELL pad slots and two invalid CSR tail slots."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-3, 4, (4 * BS, 6 * BS)).astype(np.float32)
    keep = rng.random((4, 6)) < 0.5
    keep[0, :3] = True
    keep[1] = False
    d *= np.kron(keep, np.ones((BS, BS), np.float32))
    jb = JBSR.from_dense(d, (BS, BS), pad_to=6)
    jc = JBCSR.from_bsr(jb, pad_to=int(keep.sum()) + 2)
    assert not np.asarray(jb.block_mask).all()
    y = rng.integers(-3, 4, (6 * BS, 11)).astype(np.float32)  # ragged n
    return jb, jc, convert.layout(jb), convert.layout(jc), y


@pytest.mark.parametrize("layout", ["ell", "bcsr"])
@pytest.mark.parametrize("name", NAMES)
def test_sparse_kernels_match_reference(name, layout):
    jb, jc, pb, pc, y = _operands(3)
    ja, pa = (jb, pb) if layout == "ell" else (jc, pc)
    jfn, fn = (jops.bsr_spmm, ops.bsr_spmm) if layout == "ell" else (jops.bcsr_spmm, ops.bcsr_spmm)
    want = jfn(ja, jnp.asarray(y), semiring_name=name)
    got = fn(pa, torch.from_numpy(y), semiring_name=name)
    assert got.dtype == torch.float32 and got.shape == (4 * BS, 11)
    _assert_matches(name, got, want)
    # the empty block-row is the semiring zero everywhere
    assert torch.all(got[BS:2 * BS] == ksr.kernel_zero(name))


@pytest.mark.parametrize("name", ["plus_times", "min_plus", "max_min", "log_plus"])
def test_fused_epilogue_on_empty_rows_matches_reference(name):
    """Fused: an empty row is max(zero + bias, 0) — +inf under min_plus."""
    jb, jc, pb, pc, y = _operands(5)
    bias = np.random.default_rng(6).standard_normal(4 * BS).astype(np.float32)
    for ja, pa, jfn, fn in ((jb, pb, jops.bsr_spmm, ops.bsr_spmm),
                            (jc, pc, jops.bcsr_spmm, ops.bcsr_spmm)):
        want = jfn(ja, jnp.asarray(y), jnp.asarray(bias), semiring_name=name,
                   fuse_bias_relu=True)
        got = fn(pa, torch.from_numpy(y), torch.from_numpy(bias), semiring_name=name,
                 fuse_bias_relu=True)
        _assert_matches(name, got, want)
    fill = np.maximum(ksr.kernel_zero(name) + bias[BS:2 * BS], 0)
    np.testing.assert_array_equal(got[BS:2 * BS].numpy(), np.repeat(fill[:, None], 11, 1))


@pytest.mark.parametrize("name", NAMES)
def test_dense_kernel_matches_reference(name):
    """Ragged m, n and k: k is padded with the semiring zero (0 would be
    a free edge under min_plus and a win under max_min)."""
    rng = np.random.default_rng(11)
    a = rng.integers(-3, 4, (40, 21)).astype(np.float32)
    b = rng.integers(-3, 4, (21, 13)).astype(np.float32)
    want = jops.semiring_matmul(jnp.asarray(a), jnp.asarray(b), semiring_name=name)
    got = ops.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b), semiring_name=name)
    assert got.shape == (40, 13)
    _assert_matches(name, got, want)


def test_dense_kernel_fused_epilogue_matches_reference():
    rng = np.random.default_rng(12)
    a = rng.standard_normal((24, 30)).astype(np.float32)
    b = rng.random((30, 9), dtype=np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want = jops.semiring_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                                fuse_bias_relu=True)
    got = ops.semiring_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(bias), fuse_bias_relu=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", ["ell", "bcsr"])
@pytest.mark.parametrize("name", NAMES)
def test_oracles_match_reference_oracles(name, layout):
    """``sparse.ops`` under the registry semiring: the algebra's own
    result (bool for the boolean semirings), the reference's oracle."""
    jb, jc, pb, pc, y = _operands(7)
    ja, pa = (jb, pb) if layout == "ell" else (jc, pc)
    jfn, fn = ((jsparse.bsr_matmul, sparse_ops.bsr_matmul) if layout == "ell"
               else (jsparse.bcsr_matmul, sparse_ops.bcsr_matmul))
    want = np.asarray(jfn(ja, jnp.asarray(y), jsr.get_semiring(name)))
    got = fn(pa, torch.from_numpy(y), sr.get_semiring(name))
    assert (got.dtype == torch.bool) == (want.dtype == np.bool_)
    _assert_matches(name, got, want)


def test_lowering_ids_inits_and_unknown_names():
    assert ksr.supported() == tuple(NAMES)
    assert sorted(ksr.SEMIRING_IDS.values()) == list(range(8))
    header = (build.CSRC_DIR / "semiring.cuh").read_text()
    cases = header[header.index("switch (id)"):]
    structs = ["PlusTimes", "MaxPlus", "MinPlus", "MaxMin", "MinMax", "LorLand",
               "XorAnd", "LogPlus"]
    for name, sid in ksr.SEMIRING_IDS.items():
        assert f"case {sid}: launch({structs[sid]}{{}})" in cases
        assert structs[sid].lower() == name.replace("_", "")
        assert ksr.kernel_zero(name) == float(jsr.get_semiring(name).zero)
    y = torch.zeros(16, 4)
    a = convert.layout(JBSR.from_dense(np.eye(16, dtype=np.float32), (8, 8)))
    for call in (lambda: ops.bsr_spmm(a, y, semiring_name="no_such"),
                 lambda: ops.semiring_matmul(y.T, y, semiring_name="no_such")):
        with pytest.raises(KeyError, match="no_such"):
            call()


def test_editing_a_header_changes_every_library_path(tmp_path, monkeypatch):
    """Libraries are named by a hash over the source AND csrc's headers,
    so an edit to semiring.cuh cannot reuse a stale build."""
    for f in build.CSRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {name: build.library_path(name) for name in build.SOURCES}
    with open(tmp_path / "semiring.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)
    assert all(after[n].name.startswith(f"lib{n}-") for n in build.SOURCES)
