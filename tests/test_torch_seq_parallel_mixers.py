"""Sequence parallelism over ``model`` for MLA and RWKV-6: the
scaled-down DeepSeek-V2 (MLA: the sequence gathered on the home for the
down-projections, the heads' partials reduce-scattered) and RWKV-6 (its
mixes, whose token shift reads the previous token across a chunk
boundary, run on the sequence gathered on the home) with
``ShardingRules(seq_axis="model")`` active on meshes of the CPU. One SGD
step against the reference's one-device step, to the tolerances of
``test_torch_model_mesh_*.py`` (``LOSS_RTOL``, ``GRAD_RTOL``), and a split
prefill with greedy decode steps against the reference's one-device
``Engine`` (``_torch_mesh_serve``: tokens equal, logits within
``F32_ROW_RTOL``, the cache the reference's). Moonlight (MoE), Gemma-3
and Jamba (Mamba beside MoE) are ``test_torch_seq_parallel_moe.py``,
``_gemma.py`` and ``_jamba.py``."""

import pytest

import _torch_seq_parallel as sp

DEEPSEEK, RWKV = "deepseek-v2-236b", "rwkv6-3b"


@pytest.mark.parametrize("arch,data,model", [(DEEPSEEK, 1, 2), (RWKV, 1, 2)])
def test_a_split_step_matches_the_reference_one_device_step(arch, data, model):
    sp.split_step(arch, data, model)


@pytest.mark.parametrize("arch,kw", [
    (DEEPSEEK, dict(batch=2, cache_len=32, prompt_len=12, steps=3)),
    (RWKV, dict(batch=2, cache_len=32, prompt_len=12, steps=3)),
])
def test_a_split_prefill_gives_the_one_device_engines_tokens(arch, kw):
    sp.split_serve(arch, 2, **kw)
