"""Sequence parallelism over ``model`` for Gemma-3's sliding windows and
post-norms: the scaled-down ``gemma3-4b`` (5 local layers of a window,
a global one; each block's post-norm on each position's chunk of the
sequence, every position attending over the whole sequence at its true
positions) with ``ShardingRules(seq_axis="model")`` active. One SGD step
on 2 × 2 against the reference's one-device step (``LOSS_RTOL``,
``GRAD_RTOL``, as ``test_torch_model_mesh_gemma.py``), and an 80-token
split prefill, its local ring wrapped, with greedy decode steps against
the reference's one-device ``Engine``."""

import _torch_seq_parallel as sp

ARCH = "gemma3-4b"


def test_a_split_gemma3_step_matches_the_reference_one_device_step():
    sp.split_step(ARCH, 2, 2)


def test_a_split_gemma3_prefill_gives_the_one_device_engines_tokens():
    sp.split_serve(ARCH, 2, batch=2, cache_len=128, prompt_len=80, steps=3)
