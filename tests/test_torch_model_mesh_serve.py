"""Serving over the model's mesh: ``make_serve_fns`` on Llama (and its
split-KV variant) and Gemma-3 over params placed by ``param_pspecs`` and
a cache placed by ``cache_pspecs`` on ``data`` × ``model`` meshes of the
CPU, against the reference's one-device engine at f32 (tokens equal,
logits within 1e-4 of each row's max; ``_torch_mesh_serve``): a decode
that crosses from model position 0's slot range into position 1's, one
whose second range stays empty, a local ring that wraps; the cache
written in place and, gathered, the reference's; the pieces
(``group_cache``, ``write_slots``, ``merge_softmax``) on their own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import Model
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train import checkpoint

import _torch_mesh_serve as ms
import _torch_model_mesh as mm

LLAMA = "llama3.2-1b"


@pytest.mark.parametrize("variant,data,model", [(None, 2, 2), (None, 1, 2), ("kv-split", 1, 2),
                                                ("kv-split", 2, 2)])
def test_llama_decode_across_the_slot_ranges_matches_the_reference(variant, data, model):
    """32 slots over 2 positions (16 each): a 12-token prompt and 8 steps
    cross into position 1's range at 16."""
    served = ms.serve(LLAMA, variant, data, model, batch=4, cache_len=32, prompt_len=12, steps=8)
    ms.assert_cache_is_the_reference(served)
    cfg = mm.models(LLAMA, variant)[1].cfg
    for counts in served.exchanges[1:]:  # a decode step: one merge a layer, a group
        assert counts["merge"]["calls"] == cfg.num_layers * data
        assert counts["merge"]["bytes"] > 0
    # the slot at position 12 + 8 - 1 = 19 lies in position 1's range
    k = checkpoint.leaves(served.cache["period"][0]["attn"])[0]  # "k"
    assert torch.count_nonzero(k.chunks[1].narrow(2, 0, 4)) > 0


def test_a_second_range_that_stays_empty_weighs_nothing():
    """A 4-token prompt and 4 steps fill only position 0's range: position
    1's slots stay zeros with positions -1, and the logits are the
    reference's (a softmax taken per range would spread weight there)."""
    served = ms.serve(LLAMA, None, 1, 2, batch=2, cache_len=32, prompt_len=4, steps=4)
    ms.assert_cache_is_the_reference(served)
    attn = served.cache["period"][0]["attn"]
    assert all(torch.count_nonzero(x.chunks[1]) == 0 for x in (attn["k"], attn["v"]))
    assert (attn["positions"].gather("cpu")[:, 16:] == -1).all()


def test_gemma3_local_ring_wraps_and_is_split():
    """A 80-token prompt against the scaled-down window of 64: the local
    layers' 64-slot rings wrap (32 slots a position), the global layer's
    128 slots split 64 a position."""
    served = ms.serve("gemma3-4b", None, 1, 2, batch=2, cache_len=128, prompt_len=80, steps=4)
    ms.assert_cache_is_the_reference(served)
    rings = [leaf for leaf in checkpoint.leaves(served.cache) if leaf.ndim == 5]
    assert {leaf.shape[2] for leaf in rings} == {64, 128}
    assert all(leaf.sharding.model_dim == 2 for leaf in rings)


def test_greedy_tokens_equal_the_reference_engine():
    """The 2 × 2 serve's greedy tokens are ``Engine.generate``'s."""
    eng = ms.reference_engine(LLAMA, None, 4, 32)
    host = ms.prompts(mm.models(LLAMA)[1].cfg, 4, 12)
    want, _ = eng.generate(jnp.asarray(host), 9)
    served = ms.serve(LLAMA, None, 2, 2, batch=4, cache_len=32, prompt_len=12, steps=8)
    np.testing.assert_array_equal(served.tokens, np.asarray(want))


def test_a_batch_that_does_not_split_over_data_runs_on_group_0():
    """3 rows over 2 data indices: the cache's batch is whole, group 0
    serves every row, and group 1's copies are refreshed from it."""
    served = ms.serve(LLAMA, None, 2, 2, batch=3, cache_len=32, prompt_len=12, steps=3)
    ms.assert_cache_is_the_reference(served)
    leaves = checkpoint.leaves(served.cache)
    assert all(leaf.sharding.data_dim is None for leaf in leaves)
    for leaf in leaves:
        for m in range(2):
            assert torch.equal(leaf.chunks[m], leaf.chunks[2 + m])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "jamba-v0.1-52b",
                                  "rwkv6-3b"])
def test_group_cache_views_are_the_placed_chunks(arch):
    """``group_cache`` on 2 × 2: the attention caches split along
    ``cache_seq``, Mamba's state along ``di``, RWKV-6's along heads (a
    ``Split`` of group c's chunks themselves), every other leaf the home
    position's own chunk; nothing gathered."""
    model = Model(get_config(arch).scaled_down())
    mesh = mm.grid(2, 2)
    cache = model.init_cache(4, 32, device="cpu")
    placed = sh.place(cache, sh.shardings_for(None, mesh, sh.cache_pspecs(None, cache, mesh)))
    paths = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, placed))
    want_dim = {"k": 1, "v": 1, "c_kv": 1, "k_rope": 1, "conv": 2, "ssm": 1, "wkv": 1}
    for c in range(2):
        views = checkpoint.leaves(sh.group_cache(placed, mesh, c))
        for path, leaf, view in zip(paths, checkpoint.leaves(placed), views):
            name, lead = path.split("//")[-1], int("period" in path)
            if name in want_dim:
                assert isinstance(view, tp.Split) and view.dim == want_dim[name] + lead, path
                assert all(a is b for a, b in zip(view.chunks, leaf.chunks[2 * c:2 * c + 2]))
            else:
                assert view is leaf.chunks[2 * c], path
            if leaf.sharding.data_dim is not None:
                assert view.shape[lead] == 2  # the group's 2 of 4 rows


def test_write_slots_sends_each_run_to_its_owner():
    """A ring's slots (``t % size``) land on the positions owning them, in
    runs; only the bytes that leave position 0 count."""
    cache = tp.Split(tuple(torch.zeros((2, 4, 3)) for _ in range(2)), 1)
    x = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    slots = [t % 8 for t in range(5, 11)]  # 5 6 7 0 1 2
    assert tp.slot_runs(slots, 4) == [(0, 1, 1, 3), (3, 0, 0, 3)]
    tp.reset_exchange_counts()
    tp.write_slots(cache, x, slots)
    whole = torch.cat(cache.chunks, 1)
    for i, s in enumerate(slots):
        assert torch.equal(whole[:, s], x[:, i])
    assert tp.exchange_counts()["write"] == {"calls": 1, "bytes": 2 * 3 * 3 * 4}


def test_merge_softmax_is_the_whole_softmax_and_masked_ranges_weigh_nothing():
    """Partials of 3 ranges merged in model order against one softmax over
    every slot, with the last range wholly masked (-1e30 scores)."""
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(rng.standard_normal((2, 3, 1, 12)).astype(np.float32)) * 4
    values = torch.from_numpy(rng.standard_normal((2, 12, 3, 5)).astype(np.float32))
    mask = torch.arange(12) < 8
    masked = torch.where(mask, scores, -1e30)
    want = torch.einsum("bhts,bshd->bhtd", torch.softmax(masked, -1), values)
    partials = []
    for r in range(3):
        s = masked[..., 4 * r:4 * (r + 1)]
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        partials.append((m[..., 0], e.sum(-1),
                         torch.einsum("bhts,bshd->bhtd", e, values[:, 4 * r:4 * (r + 1)])))
    got = tp.merge_softmax(partials, "cpu")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    got2 = tp.merge_softmax(partials[:2], "cpu")  # the empty range adds exactly nothing
    assert torch.equal(got, got2)


def test_a_decode_steps_serving_exchanges_replay_with_their_counts():
    """A 2 × 2 decode step into model position 1's slots (16 of 32) logs
    its slot writes, merges and replica refreshes; replayed on fresh
    tensors they move the bytes the step counted."""
    _, model, _, p = mm.models(LLAMA)
    pp, cache = ms.placed(model, p, mm.grid(2, 2), 4, 32)
    prefill_fn, decode_fn = make_serve_fns(model)
    prefill_fn(pp, torch.from_numpy(ms.prompts(model.cfg, 4, 16)), cache)
    tp.reset_exchange_counts()
    with tp.logging_exchanges() as log:
        decode_fn(pp, torch.zeros(4, dtype=torch.int32), cache, 16)
    kinds = ("write", "merge", "replicate")
    want = {k: v for k, v in tp.exchange_counts().items() if k in kinds}
    assert set(want) == set(kinds) and all(v["bytes"] > 0 for v in want.values())
    tp.reset_exchange_counts()
    for entry in log:
        if entry[0] in kinds:
            tp.replay(entry)
    assert tp.exchange_counts() == want
