"""The port's model stack against the reference on the same converted
weights and numpy inputs: ``forward``, ``prefill``'s last logits and
``decode_step``'s logits at f32 compute (every row within 1e-4 of its
max |reference logit|) and at bf16 (the reference's 2e-2), the decode
caches' bytes, and every layer at bf16 on the reference's own hidden
state. This file: the dense transformers and the sparsified paper MLP (``graphblas_mlp.make_config(m=64, num_layers=2,
inverse_sparsity=2, block=16)``); the others are in
``test_torch_models_*.py``, split to keep each file short."""

import numpy as np
import pytest
import torch

import _torch_models as tm
from repro.sparse import bsr as ref_bsr
from repro_torch import convert
from repro_torch.configs import graphblas_mlp
from repro_torch.models import Model
from repro_torch.models.layers import tree_index
from repro_torch.sparse.bsr import BlockSparseMatrix

ARCHS = ("llama3.2-1b", "qwen1.5-4b", "qwen2-72b", "internvl2-76b", "musicgen-large",
         tm.SPARSE_MLP_ID)


@pytest.fixture(scope="module")
def runs():
    return tm.Runs()


@pytest.mark.parametrize("arch,dtype,output", tm.cases(ARCHS))
def test_logits_match_reference(runs, arch, dtype, output):
    tm.assert_logits_match(*runs.outputs(arch, dtype)[output], dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_and_bf16_layers_match_reference(runs, arch):
    ref_bytes, port_bytes = runs.outputs(arch, "bfloat16")["cache_bytes"]
    assert port_bytes == ref_bytes
    for spec, ref, got in runs.chain(arch, "bfloat16"):
        np.testing.assert_allclose(got, ref, rtol=tm.BF16_TOL, atol=tm.BF16_TOL, err_msg=str(spec))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "musicgen-large"])
def test_loss_matches_reference(runs, arch):
    """Cross-entropy with z-loss and masked labels, at f32 compute."""
    ref, got = runs.loss(arch)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_sparsify_prunes_like_the_reference(runs):
    """``Model.sparsify`` on the converted dense weights gives the
    reference's stacked BSR weights: the same kept blocks, values, column
    indices and masks in every period slice."""
    jp = tm.RefModel(tm.configs(tm.SPARSE_MLP_ID, "float32")[0]).init(tm.jax.random.key(0))
    ref = convert.model_params(runs.params(tm.SPARSE_MLP_ID))
    cfg = graphblas_mlp.make_config(**tm.SPARSE_MLP)
    got = Model(cfg).sparsify(convert.model_params(jp))
    w, ref_w = got["stack"]["period"][0]["ffn"]["w"], ref["stack"]["period"][0]["ffn"]["w"]
    assert isinstance(w, BlockSparseMatrix) and w.blocks.shape[0] == cfg.n_periods
    for name in ("blocks", "col_idx", "block_mask"):
        torch.testing.assert_close(getattr(w, name), getattr(ref_w, name), rtol=0, atol=0)
    one = tree_index(got["stack"]["period"][0], 1)["ffn"]["w"]
    assert one.shape == ref_w.shape and one.blocks.shape == ref_w.blocks.shape[1:]


def test_sparse_matrix_leftovers_match_the_reference():
    """``astype``, ``map_blocks``, ``block_density`` and ``dense_nbytes`` of
    ``BlockSparseMatrix`` (and ``BlockCSRMatrix.astype``), on a matrix
    with pad slots."""
    import jax
    import jax.numpy as jnp

    from repro.sparse.bcsr import BlockCSRMatrix as RefBCSR
    from repro_torch.sparse.bcsr import BlockCSRMatrix

    ref = ref_bsr.BlockSparseMatrix.random(jax.random.key(3), (64, 48), (16, 8), blocks_per_row=3)
    ref = ref_bsr.BlockSparseMatrix(ref.blocks, ref.col_idx, ref.block_mask.at[1, 2].set(False),
                                    ref.shape, ref.block_shape)
    w = convert.layout(ref)
    assert w.block_density == pytest.approx(float(ref.block_density))
    assert w.dense_nbytes == ref.dense_nbytes
    half = w.astype(torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.col_idx is w.col_idx
    np.testing.assert_array_equal(half.blocks.float().numpy(),
                                  np.asarray(ref.astype(jnp.bfloat16).blocks.astype(jnp.float32)))
    mapped = w.map_blocks(lambda b: b * 2 + 1)
    np.testing.assert_allclose(mapped.blocks.numpy(),
                               np.asarray(ref.map_blocks(lambda b: b * 2 + 1).blocks), rtol=1e-6)
    ref_csr = RefBCSR.from_bsr(ref)
    csr = convert.layout(ref_csr).astype(torch.bfloat16)
    assert isinstance(csr, BlockCSRMatrix) and csr.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        csr.values.float().numpy(),
        np.asarray(ref_csr.astype(jnp.bfloat16).values.astype(jnp.float32)))
