"""The reference's public aliases in ``core/`` on both packages:
``core.dnn``'s ``preferred_layout``, ``to_preferred_layout``,
``layer_grid_steps``, ``resident_eligible`` and its module attribute
``ELL_WASTE_THRESHOLD`` (aliases of ``plan``), and
``core.semiring.logsumexp_reduce`` (``log_plus``'s ⊕-reduce), called on
the same inputs: layouts, sparse bills and eligibility equal, the reduce
within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dnn as jdnn
from repro.core import semiring as jsr
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch.core import dnn
from repro_torch.core import semiring as sr
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def _pair(seed: int, m: int, k: int, block: int, keep: float, pad_to: int):
    """(reference ELL weight, the port's) from one numpy matrix whose
    block-rows keep ``keep`` of their blocks."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, k)).astype(np.float32)
    live = rng.random((m // block, k // block)) < keep
    live[:, 0] = True
    dense *= np.kron(live, np.ones((block, block), np.float32))
    return (JBSR.from_dense(jnp.asarray(dense), (block, block), pad_to=pad_to),
            BlockSparseMatrix.from_dense(dense, (block, block), pad_to=pad_to, device="cpu"))


@pytest.mark.parametrize("keep,layout", [(1.0, "ell"), (0.2, "bcsr")])
def test_the_layout_aliases_match_the_reference(keep, layout):
    jw, w = _pair(1, 64, 64, 8, keep, 8)
    assert dnn.preferred_layout(w) == jdnn.preferred_layout(jw) == layout
    jw2, w2 = jdnn.to_preferred_layout(jw), dnn.to_preferred_layout(w)
    assert isinstance(jw2, JBCSR) == isinstance(w2, BlockCSRMatrix) == (layout == "bcsr")
    np.testing.assert_array_equal(w2.to_dense().numpy(), np.asarray(jw2.to_dense()))
    assert dnn.ELL_WASTE_THRESHOLD == jdnn.ELL_WASTE_THRESHOLD
    with pytest.raises(AttributeError):
        dnn.NOT_A_NAME  # noqa: B018


@pytest.mark.parametrize("n", [1, 8, 33])
def test_layer_grid_steps_and_resident_eligible_match_the_reference(n):
    """Sparse bills equal at the port's column tile; a dense weight's bill
    counts the port's own dense tiles (``plan.cost``), not the reference's."""
    from repro_torch.plan import cost

    jws, ws = zip(*(_pair(2 + i, 64, 64, 8, 0.5, 8) for i in range(2)))
    for jw, w in ((jws[0], ws[0]), (JBCSR.from_bsr(jws[0]), BlockCSRMatrix.from_bsr(ws[0]))):
        assert dnn.layer_grid_steps(w, n) == jdnn.layer_grid_steps(
            jw, n, block_n=DEFAULT_BLOCK_N)
    dense = ws[0].to_dense()
    assert dnn.layer_grid_steps(dense, n) == cost.layer_grid_steps(dense, n)
    assert dnn.resident_eligible(list(ws)) == jdnn.resident_eligible(list(jws)) is True
    mixed = [ws[0], BlockCSRMatrix.from_bsr(ws[1])]
    assert dnn.resident_eligible(mixed) == jdnn.resident_eligible(
        [jws[0], JBCSR.from_bsr(jws[1])]) is False


@pytest.mark.parametrize("dim,keepdim", [(None, False), (None, True), (0, False), (1, True)])
def test_logsumexp_reduce_matches_the_reference(dim, keepdim):
    x = np.random.default_rng(3).standard_normal((5, 7)).astype(np.float32) * 4
    got = sr.logsumexp_reduce(torch.from_numpy(x), dim, keepdim=keepdim)
    want = jsr.logsumexp_reduce(jnp.asarray(x), axis=dim, keepdims=keepdim)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert sr.LOG_PLUS.add_reduce is sr.logsumexp_reduce
