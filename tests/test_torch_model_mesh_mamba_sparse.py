"""A split Mamba beside a block-sparse FFN on the model mesh (split from
``test_torch_model_mesh_mamba.py`` so no file runs long under ``--dist
loadfile``): the scaled-down ``jamba-v0.1-52b`` cut to its first period
layer (Mamba and a dense FFN), the FFN block-pruned to 2 blocks of 16 ×
16 a row with a pad slot in ``w_in`` (``_torch_model_mesh.BEFORE_PRUNING``),
on ``(data, model)`` = (1, 2) and (2, 2), one SGD step against the
reference's one-device step at f32 compute, to ``LOSS_RTOL`` and
``GRAD_RTOL``."""

import pytest
import torch

from repro_torch.distribution import tensor_parallel as tp

import _torch_model_mesh as mm


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_a_split_mamba_beside_a_sparse_ffn_matches_the_reference(data, model):
    """The pruned FFN is whole (``param_pspecs`` never splits a sparse
    matrix's tensors) and runs once a group on the home device; its
    topology passes through the step (``check_against_the_reference``) and
    its ELL pad slots stay zero, as the reference's."""
    from repro_torch.sparse.bsr import BlockSparseMatrix
    from repro_torch.train import checkpoint

    di = 2 * mm.models(mm.MAMBA_ARCH, "mamba-sparse-ffn")[1].cfg.d_model
    channels, state = mm.mamba_channels_per_call(data, model, "mamba-sparse-ffn")
    assert channels == [di // model] * model * data
    (group, *_) = mm.group_params(mm.MAMBA_ARCH, "mamba-sparse-ffn", data, model)
    ffn = group["stack"]["period"][0]["ffn"]
    assert all(isinstance(w, BlockSparseMatrix) for w in ffn.values())
    assert isinstance(group["stack"]["period"][0]["mixer"]["in_proj"], tp.Split)
    _, _, _, p = mm.models(mm.MAMBA_ARCH, "mamba-sparse-ffn")
    new = checkpoint.with_leaves(p, [x.gather("cpu") for x in checkpoint.leaves(state.params)])
    w, old = new["stack"]["period"][0]["ffn"]["w_in"], p["stack"]["period"][0]["ffn"]["w_in"]
    pad = ~w.block_mask.bool()
    assert pad.any()  # made by mm.BEFORE_PRUNING
    assert torch.equal(w.blocks[pad], old.blocks[pad]) and not w.blocks[pad].any()
