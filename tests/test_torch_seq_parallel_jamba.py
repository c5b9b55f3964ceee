"""Sequence parallelism over ``model`` for Jamba's hybrid period (7 Mamba
layers, a GQA layer, 4 MoE layers): each Mamba layer gathers the sequence
on every position (its causal conv and scan run over the whole sequence,
each position its ``di/M`` channels) and reduce-scatters ``out_proj``'s
partials onto the chunks. One SGD step of the scaled-down
``jamba-v0.1-52b`` with ``ShardingRules(seq_axis="model")`` active,
against the reference's one-device step (``LOSS_RTOL``, ``GRAD_RTOL``, as
``test_torch_model_mesh_mamba.py``), and a split prefill with greedy
decode steps against the reference's one-device ``Engine``."""

from unittest import mock

from repro_torch.models import ssm

import _torch_model_mesh as mm
import _torch_seq_parallel as sp

ARCH = mm.MAMBA_ARCH


def test_a_split_jamba_step_matches_the_reference_one_device_step():
    di = 2 * mm.models(ARCH)[1].cfg.d_model
    with mock.patch.object(ssm, "_mamba_gated", wraps=ssm._mamba_gated) as spy:
        counts = sp.split_step(ARCH, 1, 2)
    # 7 Mamba layers, each once a position on its di/2 channels over the whole sequence
    assert [c.args[3]["D"].shape[-1] for c in spy.call_args_list] == [di // 2] * 7 * 2
    s = mm.masked_batch(mm.models(ARCH)[1].cfg, moe=True)["inputs"].shape[1]
    assert {c.args[1].shape[1] for c in spy.call_args_list} == {s}
    assert counts["regroup"]["bytes"] > 0


def test_a_split_jamba_prefill_gives_the_one_device_engines_tokens():
    sp.split_serve(ARCH, 2, batch=2, cache_len=32, prompt_len=12, steps=3)
