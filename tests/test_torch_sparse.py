"""The port's sparse layouts and weight converter against the JAX package.

Inputs are built once in numpy; the reference's layouts are converted
(``repro_torch.convert``), never regenerated.
"""

import numpy as np
import pytest
import torch

from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro_torch import convert
from repro_torch.core.dnn import stack_bsr
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix


def _block_sparse_dense(rng, m, k, bs, *, empty_row=True):
    """Random (m, k) matrix with ~half its bs×bs blocks zero and, when
    asked, one all-zero block-row."""
    d = rng.standard_normal((m, k)).astype(np.float32)
    keep = rng.random((m // bs, k // bs)) < 0.5
    keep[0, 0] = True
    if empty_row:
        keep[1] = False
    return d * np.kron(keep, np.ones((bs, bs), np.float32))


@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_from_dense_matches_reference(bs):
    rng = np.random.default_rng(bs)
    d = _block_sparse_dense(rng, 4 * bs, 6 * bs, bs)
    ref = JBSR.from_dense(d, (bs, bs), pad_to=6)
    port = BlockSparseMatrix.from_dense(d, (bs, bs), pad_to=6)
    np.testing.assert_array_equal(port.blocks.numpy(), np.asarray(ref.blocks))
    np.testing.assert_array_equal(port.col_idx.numpy(), np.asarray(ref.col_idx))
    np.testing.assert_array_equal(port.block_mask.numpy(), np.asarray(ref.block_mask))
    assert port.max_blocks_per_row == ref.max_blocks_per_row == 6
    assert port.nbytes == ref.nbytes
    np.testing.assert_array_equal(port.to_dense().numpy(), d)
    port.validate()
    conv = convert.layout(ref)
    for name in ("blocks", "col_idx", "block_mask"):
        assert torch.equal(getattr(conv, name), getattr(port, name)), name


@pytest.mark.parametrize("bs", [8, 16])
def test_bcsr_from_bsr_matches_reference_including_tail_slots(bs):
    rng = np.random.default_rng(10 + bs)
    d = _block_sparse_dense(rng, 5 * bs, 4 * bs, bs)
    ref_bsr = JBSR.from_dense(d, (bs, bs))
    nnz = int(np.asarray(ref_bsr.block_mask).sum())
    ref = JBCSR.from_bsr(ref_bsr, pad_to=nnz + 3)  # three invalid tail slots
    port = BlockCSRMatrix.from_bsr(convert.layout(ref_bsr), pad_to=nnz + 3)
    for name in ("values", "row_ptr", "row_id", "col_idx", "valid"):
        np.testing.assert_array_equal(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    # tail slots ride on the last real row (reference sparse/bcsr.py:331-333)
    last_row = int(np.asarray(ref.row_id)[nnz - 1])
    assert (port.row_id[nnz:] == last_row).all()
    assert port.nnz_blocks() == nnz and port.total_blocks == nnz + 3
    np.testing.assert_array_equal(port.to_dense().numpy(), d)
    back = port.to_bsr()
    np.testing.assert_array_equal(back.to_dense().numpy(), d)
    np.testing.assert_array_equal(
        back.col_idx.numpy(), np.asarray(ref.to_bsr().col_idx)
    )
    port.validate()
    conv = convert.layout(ref)
    for name in ("values", "row_ptr", "row_id", "col_idx", "valid"):
        assert torch.equal(getattr(conv, name), getattr(port, name)), name


def test_validate_rejects_broken_layouts():
    rng = np.random.default_rng(3)
    d = _block_sparse_dense(rng, 32, 32, 8, empty_row=False)
    a = BlockSparseMatrix.from_dense(d, (8, 8))
    bad = BlockSparseMatrix(a.blocks, a.col_idx.flip(1), a.block_mask, a.shape, a.block_shape)
    with pytest.raises(ValueError, match="ascending"):
        bad.validate()
    c = BlockCSRMatrix.from_bsr(a)
    vals = c.values.clone()
    vals[0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        BlockCSRMatrix(vals, c.row_ptr, c.row_id, c.col_idx, c.valid, c.shape,
                       c.block_shape).validate()
    ptr = c.row_ptr.clone()
    ptr[-1] += 1
    with pytest.raises(ValueError, match="row_ptr"):
        BlockCSRMatrix(c.values, ptr, c.row_id, c.col_idx, c.valid, c.shape,
                       c.block_shape).validate()


def test_convert_stacked_bsr_and_bias_keep_int_masks():
    """The reference's RadiX-net stacks carry int32 masks; the port's are
    bool, and a stacked conversion equals stacking converted layers."""
    rng = np.random.default_rng(4)
    mats = [JBSR.from_dense(_block_sparse_dense(rng, 32, 32, 8), (8, 8), pad_to=4)
            for _ in range(3)]
    blocks = np.stack([np.asarray(m.blocks) for m in mats])
    col_idx = np.stack([np.asarray(m.col_idx) for m in mats])
    mask = np.stack([np.asarray(m.block_mask) for m in mats]).astype(np.int32)
    stacked = convert.bsr(blocks, col_idx, mask, (32, 32), (8, 8))
    assert stacked.block_mask.dtype == torch.bool
    ref = stack_bsr([convert.layout(m) for m in mats])
    for name in ("blocks", "col_idx", "block_mask"):
        assert torch.equal(getattr(stacked, name), getattr(ref, name)), name
    b = convert.bias(np.arange(6, dtype=np.float64).reshape(2, 3))
    assert b.dtype == torch.float32 and b.shape == (2, 3)


@pytest.mark.parametrize("shape,block,bpr", [((64, 64), (8, 8), 3), ((32, 96), (16, 8), 12),
                                             ((16, 16), (8, 8), 2)])
def test_random_keeps_the_reference_contract(shape, block, bpr):
    """``BlockSparseMatrix.random`` draws from a torch.Generator (values
    unlike the reference's by design): exactly ``bpr`` distinct sorted
    block-columns a block-row, no pad slot, values in U[-1, 3), the same
    for the same seed."""
    import jax

    a = BlockSparseMatrix.random(torch.Generator().manual_seed(3), shape, block, bpr)
    ref = JBSR.random(jax.random.key(3), shape, block, bpr)
    assert tuple(a.blocks.shape) == ref.blocks.shape and a.col_idx.dtype == torch.int32
    assert a.shape == shape and a.block_shape == block and a.max_blocks_per_row == bpr
    cols = a.col_idx.numpy()
    assert (np.diff(cols, axis=1) > 0).all() and cols.min() >= 0
    assert cols.max() < shape[1] // block[1] and bool(a.block_mask.all())
    assert float(a.blocks.min()) >= -1.0 and float(a.blocks.max()) < 3.0
    a.validate()
    b = BlockSparseMatrix.random(torch.Generator().manual_seed(3), shape, block, bpr)
    assert torch.equal(a.blocks, b.blocks) and torch.equal(a.col_idx, b.col_idx)


def test_random_value_range_dtype_and_refusal():
    a = BlockSparseMatrix.random(torch.Generator().manual_seed(0), (64, 64), (8, 8), 8,
                                 dtype=torch.bfloat16, minval=0.0, maxval=1.0)
    assert a.dtype == torch.bfloat16 and float(a.blocks.min()) >= 0.0
    assert float(a.blocks.max()) < 1.0
    with pytest.raises(ValueError, match="blocks_per_row"):
        BlockSparseMatrix.random(torch.Generator(), (64, 64), (8, 8), 9)
