"""The meta-device dry run (``repro_torch.launch.dryrun``): its counters on
``meta`` against the same counters on real CPU tensors of tiny cells
(every arch scaled down, the cells cut to a few positions) and against
``FlopCounterMode``; a hand count on a three-op toy; argument bytes
against the real tensors' ``nbytes``; per-device pod bytes against a hand
count from the specs; the records of a skipped cell, of the card and of
the pod meshes; ``main`` and ``--summary`` on a tiny cell."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.specs import skip_reason as ref_skip_reason
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro_torch.configs import SHAPE_CELLS, ShapeCell, get_config
from repro_torch.distribution.sharding import PartitionSpec as P
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import checkpoint

TINY = {"train_4k": ShapeCell("train_4k", 16, 4, "train"),
        "prefill_32k": ShapeCell("prefill_32k", 24, 2, "prefill"),
        "decode_32k": ShapeCell("decode_32k", 24, 2, "decode"),
        "long_500k": ShapeCell("long_500k", 80, 1, "decode")}
BLOCK = dryrun.ALLOC_ROUND_BYTES


@pytest.fixture
def tiny(monkeypatch):
    """Every arch at ``scaled_down()`` and the cells cut to ``TINY``."""
    def scaled(name):
        return get_config(name).scaled_down()

    monkeypatch.setattr(specs, "get_config", scaled)
    monkeypatch.setattr(dryrun, "get_config", scaled)
    for name, cell in TINY.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)


def _plan(arch, shape, **kw):
    return specs.make_plan(arch, shape, make_production_mesh(device="meta"), **kw)


CELLS = [("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
         ("llama3.2-1b", "train_4k"), ("gemma3-4b", "long_500k"), ("gemma3-4b", "prefill_32k"),
         ("deepseek-v2-236b", "prefill_32k"), ("deepseek-v2-236b", "decode_32k"),
         ("moonshot-v1-16b-a3b", "train_4k"), ("rwkv6-3b", "long_500k"),
         ("jamba-v0.1-52b", "decode_32k"), ("musicgen-large", "prefill_32k")]
# ``F.one_hot`` (the MoE dispatch) runs arange + eq on ``meta`` and zeros +
# scatter_ on a device (with a range check on the CPU): the MoE cells'
# eager bytes and peak differ from a device run's by those ops, here
# 1.3% of the eager bytes; FLOPs and argument and output bytes do not
MOE_BYTES_RTOL = 0.05


@pytest.mark.parametrize("arch,shape", CELLS)
def test_meta_trace_equals_the_counters_on_real_cpu_tensors(tiny, arch, shape):
    kw = {"microbatches": 2} if shape == "train_4k" else {}
    plan = _plan(arch, shape, **kw)
    meta = dryrun.trace(plan)
    args = dryrun.materialize(plan, device="cpu", generator=torch.Generator().manual_seed(0))
    real = dryrun.trace(plan, args)
    for key in ("flops", "argument_bytes", "output_bytes", "alias_bytes"):
        assert meta[key] == real[key], key
    if plan.model.cfg.moe is None:
        assert meta["eager_bytes"] == real["eager_bytes"]
    else:
        assert meta["eager_bytes"] == pytest.approx(real["eager_bytes"], rel=MOE_BYTES_RTOL)
        assert meta["peak_bytes"] == pytest.approx(real["peak_bytes"], rel=MOE_BYTES_RTOL)
        return
    assert meta["argument_bytes"] == sum(t.nbytes for t in checkpoint.leaves(args)
                                         if isinstance(t, torch.Tensor))
    assert meta["alias_bytes"] == (0 if shape == "train_4k" else
                                   sum(t.nbytes for t in checkpoint.leaves(args[2])))
    # the decode position and the optimizer's step (and the step's successor)
    # lie on the host: a CPU run's live bytes hold their blocks too
    host = sum(1 for t in checkpoint.leaves(plan.args) if t.device.type == "cpu")
    assert meta["peak_bytes"] <= real["peak_bytes"] <= meta["peak_bytes"] + 2 * host * BLOCK
    with FlopCounterMode(display=False) as counter:
        plan.fn(*dryrun.materialize(plan, device="cpu",
                                    generator=torch.Generator().manual_seed(0)))
    assert counter.get_total_flops() == meta["flops"]


def test_the_tracker_counts_a_three_op_toy_by_hand():
    x = torch.empty((16, 16), device="meta")  # 1 024 bytes, the argument
    with dryrun.Tracker((x,), "meta") as t:
        y = x @ x  # 2·16³ FLOPs; reads x twice, writes 1 024 bytes
        z = torch.relu(y)  # reads and writes 1 024 bytes
        del y
        s = z.sum()  # reads 1 024, writes 4 bytes (one 512-byte block)
    assert t.flops == 2 * 16 ** 3
    assert t.eager_bytes == (2048 + 1024) + (1024 + 1024) + (1024 + 4)
    assert t.peak == 3 * 1024  # x, y and z
    assert t.current == 1024 + 1024 + BLOCK  # x, z and s: y is gone
    assert s.shape == ()
    with dryrun.Tracker((x,), "meta") as t:
        x.t().contiguous()  # a view moves nothing; the copy reads and writes
        x.fill_(1.0)  # written, not read
        x.add_(1.0)  # read and written
    assert t.eager_bytes == 2048 + 1024 + 2048 and t.peak == 2048


def test_per_device_bytes_follow_the_shard_shapes():
    mesh = {"pod": 2, "data": 16, "model": 16}
    tree = {"a": torch.empty((32, 64), device="meta"),  # 8 192 bytes
            "b": torch.empty((4, 64), dtype=torch.bfloat16, device="meta"),  # 512 bytes
            "c": torch.zeros((), dtype=torch.int32)}  # the host step, 4 bytes
    specs_tree = {"a": P("data", "model"), "b": P(None, ("pod", "data")), "c": P()}
    assert dryrun.per_device_bytes(tree, specs_tree, mesh) == 8192 // 256 + 512 // 32 + 4
    # Llama-3.2-1B's decode cache on pod16x16: batch over data, positions over model
    plan = _plan("llama3.2-1b", "decode_32k")
    k_spec = checkpoint.leaves(plan.in_shardings[2])[0]
    assert tuple(k_spec) == (None, "data", "model")
    cache_bytes = sum(t.nbytes for t in checkpoint.leaves(plan.args[2]))
    positions = 16 * 32768 * 4  # int32, one row a layer, replicated
    assert dryrun.per_device_bytes(plan.args[2], plan.in_shardings[2],
                                   {"data": 16, "model": 16}) == (
        (cache_bytes - positions) // 256 + positions)


def test_a_skipped_cell_gives_the_reference_reason():
    recs = dryrun.run_cell("llama3.2-1b", "long_500k", meshes=("card", "single", "multi"))
    reason = ref_skip_reason(ref_get_config("llama3.2-1b"), REF_CELLS["long_500k"])
    assert [r["mesh"] for r in recs] == ["card", "pod16x16", "pod2x16x16"]
    assert all(r == {"arch": "llama3.2-1b", "shape": "long_500k", "mesh": r["mesh"],
                     "kind": "decode", "status": "skipped", "reason": reason} for r in recs)


def test_card_and_pod_records_come_from_one_trace(tiny, monkeypatch):
    """Each record comes from one trace: the card's from one trace of the
    one-card plan, each pod mesh's from one trace of the mesh path over
    that mesh (``mesh_trace``), never from the card's numbers."""
    traces, mesh_traces = [], []
    real_trace, real_mesh_trace = dryrun.trace, dryrun.mesh_trace
    monkeypatch.setattr(dryrun, "trace", lambda plan: traces.append(plan) or real_trace(plan))
    monkeypatch.setattr(dryrun, "mesh_trace", lambda plan, mesh, **kw: mesh_traces.append(
        (plan, mesh)) or real_mesh_trace(plan, mesh, **kw))
    card, single, multi = dryrun.run_cell("gemma3-4b", "decode_32k",
                                          meshes=("card", "single", "multi"))
    assert len(traces) == 1
    assert [dict(m.shape) for _, m in mesh_traces] == [{"data": 16, "model": 16},
                                                      {"pod": 2, "data": 16, "model": 16}]
    assert all(m.devices[0].type == "meta" for _, m in mesh_traces)
    assert (card["chips"], single["chips"], multi["chips"]) == (1, 256, 512)
    for rec in (card, single, multi):
        assert rec["status"] == "ok"
        assert set(rec["notes"]) >= {"bytes", "collectives", "trace", "donation"}
        r = rec["roofline"]
        terms = [rec["flops_per_device"] / dryrun.PEAK_FLOPS,
                 rec["bytes_per_device"] / dryrun.HBM_BW]
        if rec is not card:
            terms.append(r["t_collective_s"])
        assert r["step_time_lower_bound_s"] == max(terms)
    assert card["collectives"] is None and card["roofline"]["t_collective_s"] is None
    for rec in (card, single, multi):
        mem = rec["memory"]
        assert mem["peak_per_device_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                                + mem["temp_bytes"] - mem["alias_bytes"])
        assert mem["alias_bytes"] > 0 and mem["temp_bytes"] > 0
    assert "per_device" in single["notes"] and "per_device" not in card["notes"]
    # the pod records: the busiest position's numbers of the mesh trace, not the
    # card's over the chips
    for rec in (single, multi):
        pos = rec["per_position"]
        assert rec["flops_per_device"] == pos["flops"][rec["busiest_position"]]
        assert rec["memory"]["peak_per_device_bytes"] == max(pos["peak_bytes"])
        assert rec["flops_per_device"] * rec["chips"] != pytest.approx(card["flops_per_device"])
        assert rec["useful_flops_fraction"] == pytest.approx(
            rec["model_flops"] / sum(pos["flops"]))
        coll = rec["collectives"]
        assert coll["total_bytes"] == sum(coll["per_axis_bytes"].values()) > 0
        assert set(coll["per_axis_bytes"]) == set(rec["layout"]["axis_bytes_per_s"])
        assert rec["roofline"]["t_collective_s"] == pos["t_collective_s"][rec["busiest_position"]]


def test_main_writes_records_and_summarizes_them(tiny, tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "both",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--mesh", "card",
                        "--out", out]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["llama3.2-1b__decode_32k__pod16x16.json",
                     "llama3.2-1b__decode_32k__pod2x16x16.json",
                     "llama3.2-1b__long_500k__card.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["trace_s"] > 0
    assert {"lower_s", "compile_s"}.isdisjoint(rec)
    capsys.readouterr()
    assert dryrun.main(["--summary", "--out", out]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].split()[:4] == ["arch", "shape", "mesh", "status"]
    assert [ln.split()[2:4] for ln in table[1:]] == [["pod16x16", "ok"], ["pod2x16x16", "ok"],
                                                     ["card", "skipped"]]
