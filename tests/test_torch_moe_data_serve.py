"""Serving a MoE over ``data`` > 1 whose token groups cross data indices:
DeepSeek-V2 and Moonlight scaled down, at capacity factor 1
(``moe-tight``: the scaled-down factor keeps every token) so that the
groups' capacity drops tokens. 4 prompts of 12 tokens make prefill groups
of 16 where a data index of 2 rows makes 8, and a decode step groups of 4
where it makes 2, so each MoE layer runs once on the first data index's
home over every index's rows (``moe.apply_moe_groups``). Held through
``make_serve_fns`` on ``data`` 2 × ``model`` 2, 2 × 1 and 4 × 1 to the
reference's one-device ``Engine`` at f32 (``_torch_mesh_serve``: tokens
equal, logits within ``F32_ROW_RTOL`` of each row's max, the cache), with
one ``moe_gather`` and one ``moe_return`` a MoE layer a call on ``data``;
each data index's rows routed alone miss that tolerance; and a prefill
with its sequence split over ``model`` gives the same tokens."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.distribution import peer
from repro_torch.distribution import sharding as sh
from repro_torch.models import moe

import _torch_mesh_serve as ms
import _torch_model_mesh as mm
import _torch_models as tm

DEEPSEEK, MOONLIGHT = "deepseek-v2-236b", "moonshot-v1-16b-a3b"
TIGHT = "moe-tight"
BATCH, CACHE, PROMPT, STEPS = 4, 32, 12, 6


def _cfg(arch):
    return mm.models(arch, TIGHT)[1].cfg


@pytest.mark.parametrize("data,model", [(2, 2), (2, 1), (4, 1)])
@pytest.mark.parametrize("arch", [DEEPSEEK, MOONLIGHT])
def test_a_moe_served_over_data_matches_the_reference(arch, data, model):
    cfg = _cfg(arch)
    peer.reset_link_counts()
    served = ms.serve(arch, TIGHT, data, model, batch=BATCH, cache_len=CACHE,
                      prompt_len=PROMPT, steps=STEPS)
    ms.assert_cache_is_the_reference(served)
    layers = sum(s.ffn == "moe" for s in cfg.layer_specs())
    row = cfg.d_model * 4  # f32
    for tokens, counts in zip([PROMPT] + [1] * STEPS, served.exchanges):
        sent = (data - 1) * BATCH // data * tokens * row * layers  # every index past the first
        for kind in ("moe_gather", "moe_return"):
            assert counts[kind] == {"calls": layers, "bytes": sent}, (kind, tokens)
    moves = {k: v for k, v in peer.link_counts().items() if k[0].startswith("moe_")}
    homes = [c * model for c in range(1, data)]
    assert set(moves) == ({("moe_gather", h, 0) for h in homes}
                          | {("moe_return", 0, h) for h in homes})
    assert all(v["calls"] == layers * (1 + STEPS) for v in moves.values())
    shape = {"data": data, "model": model}
    assert {peer.axis_crossed(shape, s, d) for _, s, d in moves} == {"data"}


@pytest.mark.parametrize("arch", [DEEPSEEK, MOONLIGHT])
def test_each_data_indexs_rows_routed_alone_miss_the_reference(arch):
    """The same prompts prefilled one data index's rows at a time on one
    device (each index's own token groups): logits outside the tolerance
    the mesh holds, and (token, expert) assignments routed otherwise."""
    eng = ms.reference_engine(arch, TIGHT, BATCH, CACHE)
    _, model, _, p = mm.models(arch, TIGHT)
    host = ms.prompts(model.cfg, BATCH, PROMPT)
    jl, _ = eng._prefill(eng.params, jnp.asarray(host), eng.model.init_cache(BATCH, CACHE))
    want = np.asarray(jl[:, -1])
    with mock.patch.object(moe, "apply_moe", wraps=moe.apply_moe) as spy:
        model.prefill(p, torch.from_numpy(host), model.init_cache(BATCH, CACHE, device="cpu"))
    inputs = [(c.args[0]["router"], c.args[2]) for c in spy.call_args_list]
    assert inputs
    for data in (2, 4):
        alone = np.concatenate([
            tm.f32(model.prefill(p, torch.from_numpy(rows),
                                 model.init_cache(BATCH // data, CACHE, device="cpu"))[0][:, -1])
            for rows in np.split(host, data)])
        err = np.abs(alone - want).max(-1) / np.abs(want).max(-1)
        assert err.max() > 100 * ms.F32_ROW_RTOL, (data, err)
        assert sum(moe.rerouted(r, model.cfg.moe, x, data) for r, x in inputs) > 0


def test_a_split_prefill_whose_moe_groups_cross_gives_the_same_tokens():
    with sh.activate(mm.grid(2, 2), sh.ShardingRules(seq_axis="model")):
        served = ms.serve(MOONLIGHT, TIGHT, 2, 2, batch=BATCH, cache_len=CACHE,
                          prompt_len=PROMPT, steps=2)
    assert served.exchanges[0]["seq_gather"]["bytes"] > 0
    assert served.exchanges[0]["moe_gather"]["calls"] == 1
    ms.assert_cache_is_the_reference(served)
