"""RWKV-6 on the model mesh: the scaled-down ``rwkv6-3b`` (d 64, 4 heads
of 16) on ``(data, model)`` = (1, 2), (1, 4) and (2, 2), one SGD step
against the reference's one-device step at f32 compute, to ``LOSS_RTOL``
and ``GRAD_RTOL``. The time mix splits only ``w_r``/``w_g`` (columns):
``k``, ``v`` and the decay are computed on the home device and scattered
by heads, each position runs the WKV of its heads, and ``w_o`` runs once
on the home device; the channel mix is column/row-parallel over
``d_ff`` with the whole ``w_r``'s gate on the home device. Heads of 32 on
``model`` = 4 put a head across two positions: r and g are gathered and
the WKV runs whole, equal to the reference."""

from unittest import mock

import pytest

from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import ssm

import _torch_model_mesh as mm

ARCH = "rwkv6-3b"


def _spied(data, model, variant=None):
    """(heads of each WKV, ``d_ff`` columns of each channel-mix partial)
    during the mesh step."""
    with mock.patch.object(ssm, "_wkv_gated", wraps=ssm._wkv_gated) as wkv, \
            mock.patch.object(ssm, "_squared_relu_mlp", wraps=ssm._squared_relu_mlp) as cmix:
        mm.check_against_the_reference(ARCH, data, model, 1, variant)
    return ([c.args[0].shape[1] for c in wkv.call_args_list],
            [c.args[1].shape[-1] for c in cmix.call_args_list])


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4), (2, 2)])
def test_rwkv6_on_a_model_mesh_matches_the_reference(data, model):
    cfg = mm.models(ARCH)[1].cfg
    heads, cols = _spied(data, model)
    layers = cfg.num_layers * data
    assert heads == [cfg.d_model // cfg.rwkv.head_dim // model] * model * layers
    assert cols == [cfg.d_ff // model] * model * layers


def test_a_split_that_cuts_a_head_runs_the_wkv_whole_and_matches_the_reference():
    cfg = mm.models(ARCH, "rwkv-cut-heads")[1].cfg
    tp.reset_exchange_counts()
    heads, cols = _spied(1, 4, "rwkv-cut-heads")
    assert heads == [cfg.d_model // 32] * cfg.num_layers  # once a layer, every head
    assert cols == [cfg.d_ff // 4] * 4 * cfg.num_layers  # the channel mix still splits
    assert "scatter" not in tp.exchange_counts()  # k, v and the decay stay home


@pytest.mark.parametrize("variant,data,model", [(None, 1, 2), ("rwkv-cut-heads", 1, 4)])
def test_rwkv_leaves_are_split_as_the_reference(variant, data, model):
    assert mm.assert_split_as_the_reference(ARCH, variant, data, model) > 0
    (group,) = mm.group_params(ARCH, variant, data, model)
    for layer in group["stack"]["period"]:
        assert {k for k, w in layer["mixer"].items() if isinstance(w, tp.Split)} == {"w_r",
                                                                                   "w_g"}
        assert {k for k, w in layer["ffn"].items() if isinstance(w, tp.Split)} == {"w_k", "w_v"}
