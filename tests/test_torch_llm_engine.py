"""The LLM ``Engine`` (the reference's ``test_serve_engine.py`` cases on
the port, and its tokens against the reference's), ``cache_nbytes``
against the reference's, the serving launcher on the CPU, and the
entry points' refusal to fall back to the CPU without a device."""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_models as tm
from repro.configs import ARCHS as REF_ARCHS
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import cache_nbytes as ref_cache_nbytes
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import Model, cast_floating
from repro_torch.models.layers import tree_leaves
from repro_torch.serve.engine import Engine, cache_nbytes, sample_token

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def setup():
    """The reference's fixture: llama at ``scaled_down()``, here on weights
    converted from the reference's (f32 compute, so greedy tokens can be
    compared token for token with no bf16 ties)."""
    ref_cfg, cfg = tm.configs("llama3.2-1b", "float32")
    ref_model, model = tm.RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.key(0))
    return cfg, model, convert.model_params(jp), ref_model, jp


def _prompts(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_generate_shapes_and_determinism(setup):
    cfg, model, params, _, _ = setup
    eng = Engine(model, params, batch_size=3, cache_len=64, temperature=0.0, device="cpu")
    prompts = torch.from_numpy(_prompts(cfg, 3, 8, 1))
    out1, stats = eng.generate(prompts, 12)
    out2, _ = eng.generate(prompts, 12)
    assert out1.shape == (3, 12) and out1.dtype == torch.int32
    assert bool((out1 == out2).all())  # greedy = deterministic
    assert stats["generated_tokens"] == 36 and stats["prompt_tokens"] == 24
    assert stats["cache_bytes"] > 0


def test_greedy_tokens_equal_the_reference(setup):
    """The same converted weights and prompts: the port's greedy tokens
    are the reference engine's, token for token, and so are the stats."""
    cfg, model, params, ref_model, jp = setup
    prompts = _prompts(cfg, 3, 8, 1)
    ref_tokens, ref_stats = RefEngine(ref_model, jp, batch_size=3, cache_len=64).generate(
        jnp.asarray(prompts), 12)
    tokens, stats = Engine(model, params, batch_size=3, cache_len=64, device="cpu").generate(
        torch.from_numpy(prompts), 12)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    assert stats == ref_stats


def test_the_engine_casts_the_parameters_once(setup):
    """The engine holds the compute-dtype copy; ``Model``'s own cast of it
    returns every leaf as it is, so the per-call cast costs nothing, and
    the values are those of the reference's per-call cast."""
    _, _, params, _, _ = setup
    model = Model(get_config("llama3.2-1b").scaled_down())  # bf16 compute
    eng = Engine(model, params, batch_size=1, cache_len=8, device="cpu")
    leaves = tree_leaves(eng.params)
    assert all(leaf.dtype == torch.bfloat16 for leaf in leaves)
    assert all(a is b for a, b in zip(leaves, tree_leaves(cast_floating(eng.params,
                                                                        torch.bfloat16))))
    for a, b in zip(leaves, tree_leaves(params)):
        assert torch.equal(a, b.to(torch.bfloat16))


def test_sampling_temperature(setup):
    cfg = setup[0]
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros((4, cfg.vocab_size))
    logits[:, 7] = 10.0
    assert bool((sample_token(logits, gen, 0.0) == 7).all())
    hot = sample_token(torch.zeros((64, cfg.vocab_size)), gen, 10.0)
    assert len(set(hot.tolist())) > 8  # high temperature → diverse
    tied = torch.zeros((2, cfg.vocab_size))
    tied[:, [3, 9]] = 1.0
    assert sample_token(tied, gen, 0.0).tolist() == [3, 3]  # ties: the lower index


def test_sampled_tokens_follow_the_seed(setup):
    cfg, model, params, _, _ = setup
    prompts = torch.from_numpy(_prompts(cfg, 2, 6, 5))

    def run(seed):
        return Engine(model, params, batch_size=2, cache_len=32, temperature=1.0, seed=seed,
                      device="cpu").generate(prompts, 8)[0]

    assert bool((run(3) == run(3)).all()) and not bool((run(3) == run(4)).all())


def test_generate_matches_forward_greedy(setup):
    """Engine's first generated token == argmax of the plain forward."""
    cfg, model, params, _, _ = setup
    prompts = torch.from_numpy(_prompts(cfg, 2, 10, 2))
    out, _ = Engine(model, params, batch_size=2, cache_len=32, device="cpu").generate(prompts, 1)
    expect = torch.argmax(model.forward(params, prompts)[:, -1], dim=-1)
    assert bool((out[:, 0] == expect).all())


def test_windowed_arch_long_decode():
    """gemma3's local layers use a ring buffer smaller than the stream:
    decoding past the 64-token window stays finite, and at f32 compute
    every step's logits and the final cache are the reference's."""
    ref_cfg, cfg = tm.configs("gemma3-4b", "float32")
    ref_model, model = tm.RefModel(ref_cfg), Model(cfg)
    jp = ref_model.init(jax.random.key(0))
    params = convert.model_params(jp)
    b = 2
    jc, c = ref_model.init_cache(b, 128), model.init_cache(b, 128, device="cpu")
    tok = np.arange(b, dtype=np.int32)
    for pos in range(0, 80, 8):  # decode past the 64-token local window
        jl, jc = ref_model.decode_step(jp, jnp.asarray(tok), jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode_step(params, torch.from_numpy(tok), c, pos)
        assert bool(torch.isfinite(logits).all())
        tm.assert_logits_match(tm.f32(jl), tm.f32(logits), "float32")
    local = c["period"][0]["attn"]
    ref_local = jc["period"][0]["attn"]
    assert local["k"].shape[2] == 64
    np.testing.assert_array_equal(local["positions"].numpy(), np.asarray(ref_local["positions"]))
    assert cache_nbytes(c) == ref_cache_nbytes(jc) > 0


def test_ssm_state_cache_is_constant_size():
    model = Model(get_config("rwkv6-3b").scaled_down())
    small = cache_nbytes(model.init_cache(2, 32, device="cpu"))
    large = cache_nbytes(model.init_cache(2, 4096, device="cpu"))
    assert small == large  # attention-free: O(1) state, not O(seq)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cache_nbytes_equals_the_reference(arch):
    ref_cfg, cfg = tm.configs(arch, "bfloat16")
    for batch, cache_len in ((2, 32), (3, 100)):
        ref = ref_cache_nbytes(tm.RefModel(ref_cfg).init_cache(batch, cache_len))
        assert cache_nbytes(Model(cfg).init_cache(batch, cache_len, device="cpu")) == ref


def test_llama_cache_bytes_at_published_width():
    """The card's llm-serve phase holds its engine's cache_bytes to this
    count: 16 layers × (keys + values) of 4 × 128 × 8 × 64 bf16, plus each
    layer's 128 int32 positions."""
    model = Model(get_config("llama3.2-1b"))
    cache = model.init_cache(4, 128, device="meta")
    assert cache_nbytes(cache) == 16 * 2 * 4 * 128 * 8 * 64 * 2 + 16 * 128 * 4 == 16_785_408


def _serve(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_serve_launcher_runs_on_the_cpu():
    r = _serve("--arch", "llama3.2-1b", "--scale-down", "--device", "cpu",
               "--max-new-tokens", "8")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "generated 32 tokens" in r.stdout and "device=cpu" in r.stdout


def test_no_entry_point_falls_back_to_the_cpu(setup):
    """Without a GPU and without an explicit device, the engine, the
    model's init and cache and the launcher raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    cfg, model, params, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, params, batch_size=1, cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(ValueError, match="generator"):
        model.init(torch.Generator(), device="cuda")
    r = _serve("--arch", "llama3.2-1b", "--scale-down", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "no CUDA device" in r.stderr

