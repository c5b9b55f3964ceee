"""Block shapes the SpMM kernels refuse reach a launch they take (``kernels.retile``).

The ELL and block-CSR kernels refuse ``bs_c % 4 != 0``, blocks taller
than 64 rows and blocks too large for shared memory; the reference takes
any block shape. The wrappers re-tile such a matrix into launchable
sub-blocks (block columns padded with the semiring zero, blocks split),
on the CPU as on the card, so these tests check on the CPU that:

* for every block shape of the reference's tests and configs, and for
  each one's transpose, the launch the wrapper makes fits the kernel's
  limits (through the Python mirrors ``tile_for``, ``threads``,
  ``smem_bytes``), and a launchable shape is left alone;
* the re-tiled matrix keeps the layout's invariants and the same dense
  matrix (with the pad columns);
* the re-tiled plain products match the reference's in all eight
  semirings: exact on integer-valued operands, ``log_plus`` within 1e-5
  (its reductions chain in another order);
* the topology map is cached and the values are gathered anew only when
  they change.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import semiring as jsr
from repro.sparse import ops as jops
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch.core.semiring import REGISTRY
from repro_torch.kernels import bcsr_spmm as kbcsr
from repro_torch.kernels import bsr_spmm as kbsr
from repro_torch.kernels import ops, retile
from repro_torch.kernels.fused_mlp import SMEM_LIMIT_BYTES
from repro_torch.kernels.semirings import kernel_zero
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix

LOG_PLUS_TOL = 1e-5

# block shapes of the reference's tests and configs (configs/base.py:64 and
# graphblas_mlp.py use 128 x 128), the ones the kernels take and the ones
# they refuse
BLOCK_SHAPES = [(1, 4), (1, 8), (2, 2), (2, 8), (3, 8), (4, 2), (4, 4), (5, 5), (8, 5), (8, 8),
                (8, 16), (16, 8), (16, 4), (16, 16), (16, 128), (32, 3), (32, 4), (32, 8),
                (32, 32), (32, 256), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256)]
SHAPES_AND_TRANSPOSES = sorted(set(BLOCK_SHAPES) | {(c, r) for r, c in BLOCK_SHAPES})
PANELS = (8, 512)  # a narrow-tile and a wide-tile panel
PRODUCT_PANELS = (8, 40)  # the same two tiles, at a width the CPU products afford


def _launch_ok(tile, bs_r, bs_c):
    return (bs_c % 4 == 0 and tile.threads(bs_r) <= kbsr.MAX_THREADS
            and tile.smem_bytes(bs_r, bs_c) <= SMEM_LIMIT_BYTES)


def _matrices(bs, rng, *, values=None):
    """An ELL matrix (2 x 3 block-rows x cols, one empty block-row, pad
    slots) and its block-CSR form with two tail slots."""
    bs_r, bs_c = bs
    keep = np.array([[True, False, True], [False, False, False], [False, True, True]])
    if values is None:
        values = rng.integers(-3, 4, (3 * bs_r, 3 * bs_c))
    d = values.astype(np.float32)
    d *= np.kron(keep, np.ones(bs, np.float32))
    ell = BlockSparseMatrix.from_dense(d, bs, pad_to=3)
    return d, ell, BlockCSRMatrix.from_bsr(ell, pad_to=ell.nnz_blocks() + 2)


@pytest.mark.parametrize("n", PANELS)
@pytest.mark.parametrize("bs", SHAPES_AND_TRANSPOSES, ids=lambda bs: f"{bs[0]}x{bs[1]}")
def test_every_block_shape_reaches_a_launch_the_kernels_take(bs, n):
    bs_r, bs_c = bs
    for mod in (kbsr, kbcsr):
        tile = mod.tile_for(n)
        sub_r, sub_c, pad_c = retile.launch_block_shape(tile, bs_r, bs_c)
        assert _launch_ok(tile, sub_r, sub_c), (mod.__name__, bs, (sub_r, sub_c))
        assert bs_r % sub_r == 0 and pad_c % sub_c == 0 and pad_c - bs_c < 4
        if _launch_ok(tile, bs_r, bs_c):  # launchable: left alone
            assert (sub_r, sub_c, pad_c) == (bs_r, bs_c, bs_c)
    # the wrapper's launch, on a real matrix of this block shape
    rng = np.random.default_rng(bs_r * 1000 + bs_c)
    _, ell, csr = _matrices(bs, rng)
    y = torch.ones(3 * bs_c, n)
    for a, mod in ((ell, kbsr), (csr, kbcsr)):
        tile = mod.tile_for(n)
        got, bp = retile.for_launch(a, y, tile, "plus_times")
        assert _launch_ok(tile, *got.block_shape)
        assert bp.shape[0] == got.shape[1] and got.shape[0] == a.shape[0]
        if _launch_ok(tile, bs_r, bs_c):
            assert got is a and bp is y


def test_the_issue_shapes_split_as_documented():
    wide, narrow = kbsr.TILES["wide"], kbsr.TILES["narrow"]
    assert retile.launch_block_shape(wide, 128, 128) == (64, 64, 128)
    assert retile.launch_block_shape(wide, 32, 256) == (32, 64, 256)
    assert retile.launch_block_shape(wide, 128, 16) == (64, 16, 16)  # a (16, 128) transpose
    assert retile.launch_block_shape(wide, 32, 3) == (32, 4, 4)
    assert retile.launch_block_shape(wide, 16, 16) == (16, 16, 16)
    assert retile.launch_block_shape(narrow, 16, 16) == (16, 16, 16)


@pytest.mark.parametrize("bs", [(2, 2), (32, 3), (8, 5), (128, 128), (64, 128), (16, 128),
                                (128, 16), (256, 256)], ids=lambda bs: f"{bs[0]}x{bs[1]}")
def test_retiled_matrices_keep_the_layout_and_the_matrix(bs):
    rng = np.random.default_rng(7)
    d, ell, csr = _matrices(bs, rng)
    for tile in kbsr.TILES.values():
        sub_r, sub_c, pad_c = retile.launch_block_shape(tile, *bs)
        want = np.zeros((d.shape[0], d.shape[1] // bs[1] * pad_c), np.float32)
        want.reshape(d.shape[0], -1, pad_c)[:, :, :bs[1]] = d.reshape(d.shape[0], -1, bs[1])
        e = retile.retile_bsr(ell, sub_r, sub_c, pad_c)
        c = retile.retile_bcsr(csr, sub_r, sub_c, pad_c)
        for got in (e, c):
            assert got.block_shape == (sub_r, sub_c)
            assert got.validate() is got
            np.testing.assert_array_equal(got.to_dense().numpy(), want)
        # tail slots stay invalid, last, and ride on the last valid row
        nnz = c.nnz_blocks()
        assert c.total_blocks == csr.total_blocks * (bs[0] // sub_r) * (pad_c // sub_c)
        assert not bool(c.valid[nnz:].any()) and bool((c.row_id[nnz:] == c.row_id[nnz - 1]).all())
        # the empty block-row stays empty
        rp = c.row_ptr.numpy()
        fr = bs[0] // sub_r
        assert (rp[fr:2 * fr + 1] == rp[fr]).all()


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("bs", [(2, 2), (32, 3), (128, 128), (64, 128)],
                         ids=lambda bs: f"{bs[0]}x{bs[1]}")
def test_retiled_products_match_reference(bs, name):
    """The wrappers' products (re-tiled, plain versions on the CPU) against
    the reference's oracle, on both panels, in every semiring."""
    rng = np.random.default_rng(sum(bs))
    d, ell, csr = _matrices(bs, rng)
    jb = JBSR.from_dense(d, bs, pad_to=3)
    jc = JBCSR.from_bsr(jb, pad_to=int(jb.block_mask.sum()) + 2)
    js = jsr.get_semiring(name)
    for n in PRODUCT_PANELS:
        y = rng.integers(-3, 4, (d.shape[1], n)).astype(np.float32)
        for got, want in (
            (ops.bsr_spmm(ell, torch.from_numpy(y), semiring_name=name),
             jops.bsr_matmul(jb, jnp.asarray(y), js)),
            (ops.bcsr_spmm(csr, torch.from_numpy(y), semiring_name=name),
             jops.bcsr_matmul(jc, jnp.asarray(y), js)),
        ):
            want = np.asarray(want).astype(np.float32)
            if name == "log_plus":
                np.testing.assert_allclose(got.numpy(), want, rtol=LOG_PLUS_TOL,
                                           atol=LOG_PLUS_TOL)
            else:
                np.testing.assert_array_equal(got.numpy(), want)
            # the empty block-row: the semiring zero
            assert bool((got[bs[0]:2 * bs[0]] == kernel_zero(name)).all())


def test_nan_still_propagates_through_split_blocks():
    rng = np.random.default_rng(1)
    d, ell, csr = _matrices((128, 128), rng)
    d[5, 300] = np.nan  # inside stored block (0, 2), split into 64 x 64 sub-blocks
    ell = BlockSparseMatrix.from_dense(d, (128, 128), pad_to=3)
    csr = BlockCSRMatrix.from_bsr(ell)
    y = torch.ones(384, 16)
    for name in ("plus_times", "max_plus", "min_plus"):
        for kern, a in ((ops.bsr_spmm, ell), (ops.bcsr_spmm, csr)):
            out = kern(a, y, semiring_name=name)
            assert bool(out[5].isnan().all()) and not bool(out[6].isnan().any()), (name, kern)


def test_topology_is_cached_and_values_regathered_when_they_change():
    rng = np.random.default_rng(2)
    _, ell, csr = _matrices((128, 128), rng, values=rng.standard_normal((384, 384)))
    tile = kbsr.TILES["wide"]
    y = torch.ones(384, 32)
    for a, field in ((ell, "blocks"), (csr, "values")):
        first, _ = retile.for_launch(a, y, tile, "plus_times")
        again, _ = retile.for_launch(a, y, tile, "plus_times")
        assert getattr(again, field) is getattr(first, field)  # values cached too
        assert again.col_idx is first.col_idx
        getattr(a, field).mul_(2.0)  # in place: a new version, values gathered anew
        third, _ = retile.for_launch(a, y, tile, "plus_times")
        assert third.col_idx is first.col_idx
        assert getattr(third, field) is not getattr(first, field)
        torch.testing.assert_close(getattr(third, field), 2 * getattr(first, field),
                                   rtol=0, atol=0)


def test_plus_times_stays_within_spmm_tolerance_on_real_values():
    """Under plus_times the split changes the summation order: held to the
    one-layer tolerance of the card checks (rtol 1e-5, atol 1e-6) against
    the plain product on the unsplit blocks (positive values: no
    cancellation)."""
    rng = np.random.default_rng(3)
    _, ell, csr = _matrices((128, 128), rng, values=rng.random((384, 384)))
    y = torch.from_numpy(rng.random((384, 40), dtype=np.float32))
    bias = torch.from_numpy(rng.random(384, dtype=np.float32))
    for kern, plain, a in ((ops.bsr_spmm, kbsr.bsr_spmm_plain, ell),
                           (ops.bcsr_spmm, kbcsr.bcsr_spmm_plain, csr)):
        got = kern(a, y, bias, fuse_bias_relu=True)
        want = plain(a, y, bias, fuse_bias_relu=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert retile.for_launch(a, y, kbsr.TILES["wide"], "plus_times")[0].block_shape == (64, 64)
