"""Serving over the model's mesh for Jamba: Mamba's ``conv`` tap and
``ssm`` state split over ``di`` beside MoE experts and GQA over
``model``, and the split Mamba beside a block-sparse FFN on 2 × 2,
through ``make_serve_fns`` on meshes of the CPU against the reference's
one-device engine at f32 (``_torch_mesh_serve``); each position scans
its own channels; over ``data`` its MoE token groups cross data indices."""

from unittest import mock

from repro_torch.models import ssm

import _torch_mesh_serve as ms
import _torch_model_mesh as mm

JAMBA = "jamba-v0.1-52b"


def _channels_and_steps(arch, variant, data, model, **kw):
    """(each ``_mamba_gated`` call's channels and whether it stepped)."""
    with mock.patch.object(ssm, "_mamba_gated", wraps=ssm._mamba_gated) as spy:
        served = ms.serve(arch, variant, data, model, **kw)
    ms.assert_cache_is_the_reference(served)
    return [(c.args[3]["D"].shape[-1], c.kwargs.get("step", False)) for c in spy.call_args_list]


def test_jamba_mamba_state_over_di_matches_the_reference():
    cfg = mm.models(JAMBA)[1].cfg
    calls = _channels_and_steps(JAMBA, None, 1, 2, batch=2, cache_len=32, prompt_len=12,
                                steps=4)
    di = cfg.mamba.expand * cfg.d_model
    n_mamba = sum(s.mixer == "mamba" for s in cfg.layer_specs())
    assert calls == ([(di // 2, False)] * 2 * n_mamba + [(di // 2, True)] * 2 * n_mamba * 4)


def test_jamba_with_a_block_sparse_ffn_on_2x2_matches_the_reference():
    """The split Mamba beside a pruned FFN, whole on each group's home
    device; the batch over ``data`` (the variant has no MoE layer)."""
    calls = _channels_and_steps(JAMBA, "mamba-sparse-ffn", 2, 2, batch=4, cache_len=32,
                                prompt_len=12, steps=3)
    assert {c for c, _ in calls} == {mm.models(JAMBA)[1].cfg.mamba.expand * 64 // 2}


def test_jamba_over_data_with_its_moe_groups_crossing_matches_the_reference():
    """4 rows on 2 × 2 at capacity factor 1 (``moe-tight``): each MoE layer
    runs once on group 0's home over both groups' rows, beside the split
    Mamba of each group."""
    cfg = mm.models(JAMBA, "moe-tight")[1].cfg
    with mock.patch.object(ssm, "_mamba_gated", wraps=ssm._mamba_gated) as spy:
        served = ms.serve(JAMBA, "moe-tight", 2, 2, batch=4, cache_len=32, prompt_len=12,
                          steps=3)
    ms.assert_cache_is_the_reference(served)
    assert {c.args[3]["D"].shape[-1] for c in spy.call_args_list} == {
        cfg.mamba.expand * cfg.d_model // 2}
    layers = sum(s.ffn == "moe" for s in cfg.layer_specs())
    assert all(c["moe_gather"]["calls"] == c["moe_return"]["calls"] == layers
               for c in served.exchanges)
