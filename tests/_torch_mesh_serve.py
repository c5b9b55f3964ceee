"""Shared by the serving-mesh tests (``test_torch_model_mesh_serve*.py``):
the port's ``make_serve_fns`` over params placed by ``param_pspecs`` and a
cache placed by ``cache_pspecs`` on a ``data`` × ``model`` mesh of the CPU,
against the reference's one-device ``Engine`` (its jitted
``Model.prefill``/``decode_step``, temperature 0) on the same converted
weights and numpy prompts, at f32 compute: the greedy tokens equal, every
step's logits within ``F32_ROW_RTOL`` of each row's max |logit|, and the
cache written in place and, gathered, the reference's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.serve.engine import Engine as RefEngine
from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train import checkpoint

import _torch_model_mesh as mm
import _torch_models as tm
import _torch_train as tt

F32_ROW_RTOL = tm.F32_ROW_RTOL


@dataclasses.dataclass
class Served:
    tokens: np.ndarray  # (B, 1 + steps), the port's greedy tokens
    logits: list  # each call's (B, V) logits, the port's
    ref_logits: list  # the reference's
    cache: object  # the placed cache after the last step
    ref_cache: object
    exchanges: list  # tensor_parallel.exchange_counts() of each call


def prompts(cfg, batch: int, length: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (batch, length)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference_engine(arch: str, variant: str | None, batch: int, cache_len: int) -> RefEngine:
    ref_model, _, jp, _ = mm.models(arch, variant)
    return RefEngine(ref_model, jp, batch_size=batch, cache_len=cache_len)


def placed(model, params, mesh, batch: int, cache_len: int):
    """(params placed by ``param_pspecs``, a fresh cache placed by
    ``cache_pspecs``) on ``mesh``."""
    cfg = model.cfg
    pp = sh.place(params, sh.shardings_for(None, mesh, sh.param_pspecs(cfg, params, mesh)))
    cache = model.init_cache(batch, cache_len, device="cpu")
    return pp, sh.place(cache, sh.shardings_for(None, mesh, sh.cache_pspecs(cfg, cache, mesh)))


def chunk_ptrs(cache) -> list[int]:
    return [c.data_ptr() for leaf in checkpoint.leaves(cache) for c in leaf.chunks]


def serve(arch: str, variant: str | None, data: int, model_axis: int, *, batch: int,
          cache_len: int, prompt_len: int, steps: int) -> Served:
    """A prefill of ``prompt_len`` tokens and ``steps`` greedy decode steps
    through ``make_serve_fns`` on the mesh, each call beside the
    reference engine's on the same tokens; asserts the tokens and logits
    as the module docstring says and that every chunk of the cache keeps
    its storage."""
    eng = reference_engine(arch, variant, batch, cache_len)
    _, model, _, p = mm.models(arch, variant)
    pp, cache = placed(model, p, mm.grid(data, model_axis), batch, cache_len)
    ptrs = chunk_ptrs(cache)
    host = prompts(model.cfg, batch, prompt_len)
    prefill_fn, decode_fn = make_serve_fns(model)
    jl, jc = eng._prefill(eng.params, jnp.asarray(host), eng.model.init_cache(batch, cache_len))
    tp.reset_exchange_counts()
    logits, out = prefill_fn(pp, torch.from_numpy(host), cache)
    assert out is cache
    got, want, exchanges = [logits[:, -1]], [np.asarray(jl[:, -1])], [tp.exchange_counts()]
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    tokens = [tok]
    for i in range(steps):
        jd, jc = eng._decode(eng.params, jnp.asarray(tok.numpy()), jc,
                             jnp.asarray(prompt_len + i, jnp.int32))
        tp.reset_exchange_counts()
        logits, out = decode_fn(pp, tok, cache, prompt_len + i)
        assert out is cache
        exchanges.append(tp.exchange_counts())
        got.append(logits)
        want.append(np.asarray(jd))
        tok = torch.argmax(logits, -1).to(torch.int32)
        tokens.append(tok)
    for g, w in zip(got, want):
        tm.assert_logits_match(w, tm.f32(g), "float32")
        np.testing.assert_array_equal(np.argmax(tm.f32(g), -1), np.argmax(w, -1))
    assert chunk_ptrs(cache) == ptrs
    return Served(torch.stack(tokens, 1).numpy(), got, want, cache, jc, exchanges)


def assert_cache_is_the_reference(served: Served) -> None:
    """Every leaf of the placed cache, gathered, within 1e-4 of the
    reference's leaf's max (``positions`` exactly); the copies of a chunk
    held by several positions the same bits (the replicas refreshed)."""
    leaves = checkpoint.leaves(served.cache)
    ref = [tt.host(x) for x in jax.tree.leaves(served.ref_cache)]
    assert len(leaves) == len(ref)
    mm.whole([[x.chunks[p] for x in leaves] for p in range(len(leaves[0].chunks))], leaves)
    tt.assert_leaves_close(ref, [tt.host(x.gather("cpu")) for x in leaves])
