"""Sequence parallelism over ``model`` for an MoE: the scaled-down
Moonlight (``moonshot-v1-16b-a3b``, 4 experts over ``model``) with
``ShardingRules(seq_axis="model")`` active on 1 × 2. Its token groups are
formed from the sequence gathered on the home, so the groups, the
capacity and the routing are the unsplit path's. One SGD step against the
reference's one-device step (``LOSS_RTOL``, ``GRAD_RTOL``, as
``test_torch_model_mesh_moe.py``), and a split prefill with greedy decode
steps against the reference's one-device ``Engine``."""

import _torch_model_mesh as mm
import _torch_seq_parallel as sp


def test_a_split_moe_step_matches_the_reference_one_device_step():
    sp.split_step(mm.MOE_ARCH, 1, 2)


def test_a_split_moe_prefill_gives_the_one_device_engines_tokens():
    sp.split_serve(mm.MOE_ARCH, 2, batch=2, cache_len=32, prompt_len=12, steps=3)
