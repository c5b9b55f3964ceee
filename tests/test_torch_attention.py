"""The reference's attention cases (``test_attention.py``) on both packages,
on the same numpy inputs: streaming against the block path, gradients,
the dispatch threshold, a ragged query tail, RoPE decode against
prefill; and the decode writes: a full-attention decode past the cache
(the reference clamps its write to the last slot), the ring buffer past
its window, MLA's absorbed decode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as RefAttentionConfig
from repro.models import attention as RA
from repro_torch import convert
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as A

TOL = 3e-5  # the reference's streaming-vs-block tolerance


def _qkv(seed, b=2, t=96, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("q_chunk,k_chunk", [(32, 16), (48, 32), (96, 96)])
def test_streaming_matches_block(window, q_chunk, k_chunk):
    q, k, v = _qkv(0)
    t = q.shape[1]
    ref = np.asarray(RA._attend(*_j(q, k, v), RA.causal_mask(t, window), scale=0.25, q_chunk=t))
    block = A._attend(*_t(q, k, v), A.causal_mask(t, window), scale=0.25, q_chunk=t)
    out = A._attend_streaming(*_t(q, k, v), scale=0.25, window=window, q_chunk=q_chunk,
                              k_chunk=k_chunk)
    ref_out = RA._attend_streaming(*_j(q, k, v), scale=0.25, window=window, q_chunk=q_chunk,
                                   k_chunk=k_chunk)
    np.testing.assert_allclose(block.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [0, 32])
def test_streaming_gradients_match(window):
    q, k, v = _qkv(1)
    t = q.shape[1]

    def port_grads(fn):
        args = [a.requires_grad_() for a in _t(q, k, v)]
        fn(*args).sum().backward()
        return [a.grad.numpy() for a in args]

    g_block = port_grads(lambda q, k, v: A._attend(q, k, v, A.causal_mask(t, window),
                                                   scale=0.25, q_chunk=t))
    g_str = port_grads(lambda q, k, v: A._attend_streaming(q, k, v, scale=0.25, window=window,
                                                           q_chunk=32, k_chunk=16))
    g_ref = jax.grad(lambda q, k, v: RA._attend(q, k, v, RA.causal_mask(t, window), scale=0.25,
                                                q_chunk=t).sum(), argnums=(0, 1, 2))(*_j(q, k, v))
    for a, b, r in zip(g_block, g_str, g_ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(b, np.asarray(r), rtol=2e-4, atol=2e-4)


def test_dispatch_threshold():
    """attend_causal uses the block path at/below q_chunk, streaming above."""
    q, k, v = _qkv(2, t=64)
    small = A.attend_causal(*_t(q, k, v), scale=0.25, q_chunk=64)
    stream = A._attend_streaming(*_t(q, k, v), scale=0.25, q_chunk=16, k_chunk=16)
    above = A.attend_causal(*_t(q, k, v), scale=0.25, q_chunk=16)
    ref = RA.attend_causal(*_j(q, k, v), scale=0.25, q_chunk=64)
    np.testing.assert_allclose(small.numpy(), stream.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(above.numpy(), stream.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(small.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_streaming_ragged_tail():
    """t not divisible by q_chunk exercises the ragged last block."""
    q, k, v = _qkv(3, t=80)
    ref = RA._attend(*_j(q, k, v), RA.causal_mask(80), scale=0.25, q_chunk=80)
    out = A._attend_streaming(*_t(q, k, v), scale=0.25, q_chunk=32, k_chunk=16)
    ref_out = RA._attend_streaming(*_j(q, k, v), scale=0.25, q_chunk=32, k_chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL, atol=TOL)


def test_streaming_ragged_key_tail_keeps_the_block_answer():
    """Keys not divisible by k_chunk: the port pads the last k-tile and
    masks the pad, so it gives the block path's answer (the reference
    slices that tile from a clamped start and labels its keys with the
    wrong positions)."""
    q, k, v = _qkv(6, t=40)
    ref = RA._attend(*_j(q, k, v), RA.causal_mask(40, 24), scale=0.25, q_chunk=40)
    for window in (0, 24):
        block = A._attend(*_t(q, k, v), A.causal_mask(40, window), scale=0.25, q_chunk=40)
        out = A._attend_streaming(*_t(q, k, v), scale=0.25, window=window, q_chunk=16,
                                  k_chunk=16)
        np.testing.assert_allclose(out.numpy(), block.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(block.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_rope_positions_decode_vs_prefill():
    """decode at position p uses the same rotation as prefill row p, in
    both packages."""
    x = np.random.default_rng(4).standard_normal((1, 8, 2, 32)).astype(np.float32)
    full = A.apply_rope(torch.from_numpy(x), torch.arange(8)[None, :], 10_000.0)
    one = A.apply_rope(torch.from_numpy(x[:, 5:6]), torch.full((1, 1), 5, dtype=torch.int32),
                       10_000.0)
    ref = RA.apply_rope(jnp.asarray(x), jnp.arange(8)[None, :], 10_000.0)
    np.testing.assert_allclose(one[0, 0].numpy(), full[0, 5].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


GQA = dict(kind="gqa", num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True, qk_norm=True)
MLA = dict(kind="mla", num_heads=4, num_kv_heads=4, head_dim=24, q_lora_rank=32,
           kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)


def _decode_both(kw, *, cache_len, window, prompt, positions):
    """Prefill ``prompt`` tokens, then decode at each of ``positions``, in
    both packages on the same weights; the per-step outputs and caches."""
    d = 32
    ref_cfg, cfg = RefAttentionConfig(**kw), AttentionConfig(**kw)
    kind = kw["kind"]
    jp = RA.INIT[kind](jax.random.key(0), ref_cfg, d)
    p = convert.model_params(jp)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, prompt, d)).astype(np.float32)
    jc = RA.INIT_CACHE[kind](ref_cfg, 2, cache_len, window, jnp.float32)
    c = A.INIT_CACHE[kind](cfg, 2, cache_len, window, torch.float32)
    _, jc = RA.PREFILL[kind](jp, ref_cfg, jnp.asarray(x), jc, window=window)
    _, c = A.PREFILL[kind](p, cfg, torch.from_numpy(x), c, window=window)
    steps = []
    for pos in positions:
        xt = rng.standard_normal((2, 1, d)).astype(np.float32)
        jo, jc = RA.DECODE[kind](jp, ref_cfg, jnp.asarray(xt), jc, jnp.asarray(pos, jnp.int32),
                                 window=window)
        o, c = A.DECODE[kind](p, cfg, torch.from_numpy(xt), c, pos, window=window)
        steps.append((np.asarray(jo), o.numpy(), jax.tree.map(np.asarray, jc),
                      {k: v.numpy() for k, v in c.items()}))
    return steps


@pytest.mark.parametrize("kw", [GQA, MLA], ids=["gqa", "mla"])
def test_full_attention_decode_past_the_cache_writes_the_last_slot(kw):
    """At ``pos >= cache_len`` the reference's ``dynamic_update_slice``
    clamps its start: the last slot is overwritten. The port does the same
    (``min(pos, size - 1)``) instead of raising."""
    steps = _decode_both(kw, cache_len=8, window=0, prompt=6, positions=range(6, 12))
    for ref_out, out, ref_cache, cache in steps:
        np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
        assert ref_cache.keys() == cache.keys()
        for name in cache:
            np.testing.assert_allclose(cache[name], ref_cache[name], rtol=1e-5, atol=1e-6)
    assert steps[-1][3]["positions"].tolist() == [0, 1, 2, 3, 4, 5, 6, 11]


def test_windowed_decode_wraps_its_ring_buffer_like_the_reference():
    """A window-16 layer: a 20-token prompt fills the ring with its last 16
    (``_ring_fill``), and decoding to position 40 wraps it twice."""
    steps = _decode_both(GQA, cache_len=64, window=16, prompt=20, positions=range(20, 41))
    for ref_out, out, ref_cache, cache in steps:
        np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(cache["positions"], ref_cache["positions"])
        np.testing.assert_allclose(cache["k"], ref_cache["k"], rtol=1e-5, atol=1e-6)
