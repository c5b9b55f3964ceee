"""MLA (DeepSeek-V2's latent attention) on the model mesh: the
scaled-down ``deepseek-v2-236b`` (its dense first layer and an MoE layer,
4 experts with shared experts) on ``(data, model)`` = (1, 2), (1, 4) and
(2, 2), one SGD step against the reference's one-device step at f32
compute, to ``LOSS_RTOL`` and ``GRAD_RTOL``. ``w_uq``/``w_uk``/``w_uv``
split over heads and ``w_o`` row-parallel; the down-projections, their
norms and the ``k_rope`` every head shares computed once on the home
device and fanned out. The scaled-down arch has 2 heads, which stay
whole on ``model`` = 4 (the divisibility fallback: the layer runs on the
home device), so a variant with 4 heads splits them over 4."""

from unittest import mock

import pytest

from repro_torch.models import attention

import _torch_model_mesh as mm

ARCH = "deepseek-v2-236b"


def _heads_per_call(data, model, variant):
    """The heads of each ``_mla_heads`` call during the mesh step."""
    with mock.patch.object(attention, "_mla_heads", wraps=attention._mla_heads) as spy:
        mm.check_against_the_reference(ARCH, data, model, 1, variant)
    return [c.args[0]["w_uq"].shape[-2] for c in spy.call_args_list]


@pytest.mark.parametrize("data,model,variant,heads", [
    (1, 2, None, [1] * 2 * 2),  # 2 layers × 2 positions, a head each
    (1, 4, None, [2] * 2),  # 2 heads do not divide over 4: each layer once, whole
    (2, 2, None, [1] * 2 * 2 * 2),  # × 2 groups
    (1, 4, "mla-heads4", [1] * 2 * 4),
    (2, 2, "mla-heads4", [2] * 2 * 2 * 2),
])
def test_deepseek_on_a_model_mesh_matches_the_reference(data, model, variant, heads):
    assert _heads_per_call(data, model, variant) == heads


@pytest.mark.parametrize("data,model,variant", [(1, 2, None), (1, 4, None),
                                                (1, 4, "mla-heads4")])
def test_mla_leaves_are_split_as_the_reference_or_whole_when_heads_do_not_divide(
        data, model, variant):
    from repro_torch.distribution import tensor_parallel as tp

    assert mm.assert_split_as_the_reference(ARCH, variant, data, model) > 0
    (group,) = mm.group_params(ARCH, variant, data, model)
    mla = [layer["mixer"] for layer in group["stack"]["head"] + group["stack"]["period"]]
    divides = mm.models(ARCH, variant)[1].cfg.attention.num_heads % model == 0
    for p in mla:
        for k in ("w_uq", "w_uk", "w_uv", "w_o"):
            assert isinstance(p[k], tp.Split) == divides, k
        for k in ("w_dq", "w_dkv", "q_norm", "kv_norm"):
            assert not isinstance(p[k], tp.Split), k
