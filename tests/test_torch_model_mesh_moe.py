"""The model mesh with a MoE arch (split from ``test_torch_model_mesh.py``
so no file runs long under ``--dist loadfile``): ``moonshot-v1-16b-a3b``
scaled down, its 4 experts over ``model`` = 2 and 4 (one and two data
indices), the router, dispatch and combine once a group, the shared
experts column/row-parallel, against the reference's one-device step;
and the expert banks stored as chunks."""

import pytest

from repro_torch.distribution import sharding as sh
from repro_torch.train import checkpoint

import _torch_model_mesh as mm


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
def test_a_moe_step_with_experts_over_model_matches_the_reference(data, model):
    mm.check_against_the_reference(mm.MOE_ARCH, data, model, 1)


def test_the_expert_banks_are_stored_as_chunks_of_experts():
    _, model, _, p = mm.models(mm.MOE_ARCH)
    mesh = mm.grid(1, 4)
    placed = sh.place(p, sh.shardings_for(None, mesh, sh.param_pspecs(None, p, mesh)))
    banks = [(path, leaf) for path, leaf in zip(
        checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, placed)),
        checkpoint.leaves(placed)) if path.endswith(("ffn//w_in", "ffn//w_gate", "ffn//w_out"))
        and leaf.ndim == 4]
    assert banks
    for path, leaf in banks:
        assert leaf.sharding.model_dim == 1, path  # (layers, experts, ...): experts over model
        assert [c.shape[1] for c in leaf.chunks] == [model.cfg.moe.num_experts // 4] * 4
