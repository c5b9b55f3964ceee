"""The donated cache (``donate_cache=True``, the serve fns of the dry run's
plans) against the out-of-place default, for every arch scaled down: the
same logits and caches bit for bit, the caller's cache tensors written in
place and returned (every leaf in its own storage, a period layer's
through its views of the stacked buffers), and the out-of-place path
leaving the caller's cache as it was. The prompt is longer than
gemma3's 64-position window, so its ring buffers take the ring fill."""

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import Model
from repro_torch.models.layers import tree_leaves
from repro_torch.serve.engine import make_serve_fns

B, S, CACHE = 2, 80, 96


def _inputs(cfg, generator):
    if cfg.input_mode == "tokens":
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=generator,
                             dtype=torch.int32)
        return toks[:, :S], toks[:, S]
    emb = torch.randn((B, S + 1, cfg.d_model), generator=generator)
    return emb[:, :S], emb[:, S:S + 1]


def _ptrs(tree) -> list[int]:
    return [t.untyped_storage().data_ptr() for t in tree_leaves(tree)]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_donated_steps_equal_the_out_of_place_steps_in_place(arch):
    cfg = get_config(arch).scaled_down()
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt, nxt = _inputs(cfg, torch.Generator().manual_seed(1))
    prefill_fn, decode_fn = make_serve_fns(model)

    fresh = model.init_cache(B, CACHE, device="cpu")
    cache = model.init_cache(B, CACHE, device="cpu")
    want, want_cache = model.prefill(params, prompt, cache)
    assert _equal(cache, fresh)  # out of place: the caller's cache is untouched
    ptrs = _ptrs(cache)
    got, got_cache = prefill_fn(params, prompt, cache)
    assert torch.equal(got, want) and _equal(got_cache, want_cache)
    assert _ptrs(got_cache) == ptrs

    pos = torch.tensor(S, dtype=torch.int32)
    want, want_cache = model.decode_step(params, nxt, want_cache, pos)
    got, got_cache = decode_fn(params, nxt, got_cache, pos)
    assert torch.equal(got, want) and _equal(got_cache, want_cache)
    assert _ptrs(got_cache) == ptrs and _equal(cache, want_cache)
