"""Shared by the sequence-parallel tests of the mixers
(``test_torch_seq_parallel_mixers.py``, ``_jamba.py``): a step and a
serve on a mesh of the CPU with ``ShardingRules(seq_axis="model")``
active, held to the reference as the model-mesh tests hold them."""

from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp

import _torch_mesh_serve as ms
import _torch_model_mesh as mm

SEQ = sh.ShardingRules(seq_axis="model")


def split_step(arch: str, data: int, model: int) -> dict:
    """The step held to the reference with the rules active; its exchange
    counts."""
    tp.reset_exchange_counts()
    with sh.activate(mm.grid(data, model), SEQ):
        mm.check_against_the_reference(arch, data, model, 1)
    counts = tp.exchange_counts()
    assert counts["seq_gather"]["bytes"] > 0 and counts["seq_reduce"]["bytes"] > 0
    return counts


def split_serve(arch: str, model: int, **kw) -> ms.Served:
    """A split prefill and greedy decode steps held to the reference's
    ``Engine``; the prefill splits, the decode steps (S = 1) do not."""
    with sh.activate(mm.grid(1, model), SEQ):
        served = ms.serve(arch, None, 1, model, **kw)
    assert served.exchanges[0]["seq_gather"]["bytes"] > 0
    assert all("seq_gather" not in c and "seq_reduce" not in c for c in served.exchanges[1:])
    ms.assert_cache_is_the_reference(served)
    return served
