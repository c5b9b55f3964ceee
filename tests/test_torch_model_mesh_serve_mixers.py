"""Serving over the model's mesh for MLA and RWKV-6: DeepSeek-V2 (MLA
over ``cache_seq``, its MoE experts over ``model``) and RWKV-6 (its
``wkv`` state over heads, the token shifts home; a split that cuts a
head keeps the state whole) through ``make_serve_fns`` on meshes of the
CPU, against the reference's one-device engine at f32
(``_torch_mesh_serve``). Jamba's Mamba is in
``test_torch_model_mesh_serve_mamba.py``; a MoE served over ``data`` > 1,
its token groups crossing data indices, in
``test_torch_moe_data_serve.py``."""

from unittest import mock

import pytest

from repro_torch.models import ssm

import _torch_mesh_serve as ms
import _torch_model_mesh as mm

DEEPSEEK, RWKV = "deepseek-v2-236b", "rwkv6-3b"


@pytest.mark.parametrize("variant,model", [(None, 2), ("mla-heads4", 4)])
def test_deepseek_v2_mla_over_cache_seq_matches_the_reference(variant, model):
    """32 latent slots over the positions, a decode across the first
    boundary (16 a position on 2, 8 on 4)."""
    served = ms.serve(DEEPSEEK, variant, 1, model, batch=2, cache_len=32, prompt_len=12,
                      steps=6)
    ms.assert_cache_is_the_reference(served)
    layers = mm.models(DEEPSEEK, variant)[1].cfg.num_layers
    assert all(c["merge"]["calls"] == layers for c in served.exchanges[1:])


@pytest.mark.parametrize("variant,data,model", [(None, 2, 2), (None, 1, 2),
                                                ("rwkv-cut-heads", 1, 4)])
def test_rwkv6_wkv_state_over_heads_matches_the_reference(variant, data, model):
    cfg = mm.models(RWKV, variant)[1].cfg
    with mock.patch.object(ssm, "_wkv_gated", wraps=ssm._wkv_gated) as spy:
        served = ms.serve(RWKV, variant, data, model, batch=4, cache_len=32, prompt_len=12,
                          steps=4)
    ms.assert_cache_is_the_reference(served)
    heads = {c.args[0].shape[1] for c in spy.call_args_list}
    h = cfg.d_model // cfg.rwkv.head_dim
    assert heads == ({h} if variant else {h // model})  # a cut head runs every head whole
    wkv = [x for x in served.cache["period"][0]["rwkv"].values() if x.ndim == 5][0]
    assert wkv.sharding.model_dim == (None if variant else 2)
