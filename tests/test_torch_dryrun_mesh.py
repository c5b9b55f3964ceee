"""The dry run through the port's own mesh path (``dryrun.mesh_trace``):
the partitioned ``meta`` trace of 2 × 2 train and decode steps against the
same steps on real CPU tensors (per-position FLOPs, eager bytes and peaks,
exchanges by kind, axis and position, all exact); the symmetry shortcut
against the full trace on 2 × 2 × 2 with ``pod``; per-position argument
bytes against ``per_device_bytes`` under the reference's pspecs; a hand
count of a one-layer toy's exchanges and collective time; an MoE decode
over ``data`` > 1, its token groups crossing data indices, recorded with
its rows gathered on position 0 and the shortcut equal to its full trace.
Under
``--seq-shard`` (``ShardingRules(seq_axis="model")``) the same holds of
the split train step and prefill: the ``meta`` trace equal to the CPU
tensors', the shortcut to the full trace, every model position carrying
about the same bytes, and no note that the split is missing."""

import dataclasses

import pytest
import torch

from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro_torch.configs import SHAPE_CELLS, ShapeCell, get_config
from repro_torch.distribution import peer
from repro_torch.distribution.sharding import PartitionSpec as P
from repro_torch.distribution.sharding import ShardingRules
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.train import checkpoint

TINY = {"train_4k": ShapeCell("train_4k", 16, 8, "train"),
        "decode_32k": ShapeCell("decode_32k", 24, 8, "decode")}
# an MoE position needs a multiple of the 256-token group: 2 rows of 128 a
# group in each of 2 microbatches
MOE_TRAIN = ShapeCell("train_4k", 128, 8, "train")
LLAMA, MOE = "llama3.2-1b", "moonshot-v1-16b-a3b"
SEQ = ShardingRules(seq_axis="model")  # --seq-shard
TINY_PREFILL = ShapeCell("prefill_32k", 16, 4, "prefill")


@pytest.fixture
def tiny(monkeypatch):
    """Every arch at ``scaled_down()`` and the cells cut to ``TINY``, in
    both packages (the reference's plans give the pspecs)."""
    monkeypatch.setattr(specs, "get_config", lambda name: get_config(name).scaled_down())
    monkeypatch.setattr(dryrun, "get_config", lambda name: get_config(name).scaled_down())
    monkeypatch.setattr(ref_specs, "get_config",
                        lambda name: ref_get_config(name).scaled_down())
    for name, cell in TINY.items():
        monkeypatch.setitem(SHAPE_CELLS, name, cell)
        monkeypatch.setitem(REF_CELLS, name, dataclasses.replace(
            REF_CELLS[name], seq_len=cell.seq_len, global_batch=cell.global_batch))


def _grid(shape: dict, device) -> Mesh:
    if "pod" not in shape:
        return make_local_mesh(shape["data"], model=shape["model"], device=device)
    return Mesh(tuple(shape), tuple(shape.values()), (torch.device(device),) * 8)


def _plan(arch, shape, mesh, mb=2, rules=None):
    return specs.make_plan(arch, shape, mesh, rules=rules,
                           microbatches=mb if shape == "train_4k" else None)


CASES = [(LLAMA, "train_4k", 2), (LLAMA, "train_4k", 1), (LLAMA, "decode_32k", None),
         (MOE, "train_4k", 2)]


@pytest.mark.parametrize("arch,shape,mb", CASES)
def test_the_meta_trace_of_a_2x2_step_equals_the_step_on_real_cpu_tensors(
        tiny, monkeypatch, arch, shape, mb):
    if arch == MOE:
        monkeypatch.setitem(SHAPE_CELLS, shape, MOE_TRAIN)
    grid = {"data": 2, "model": 2}
    meta_mesh, cpu_mesh = _grid(grid, "meta"), _grid(grid, "cpu")
    plan = _plan(arch, shape, meta_mesh, mb)
    meta = dryrun.mesh_trace(plan, meta_mesh)
    args = dryrun.materialize(plan, device="cpu", generator=torch.Generator().manual_seed(0))
    real = dryrun.mesh_trace(_plan(arch, shape, cpu_mesh, mb), cpu_mesh, args)
    assert meta["flops"] == real["flops"] > 0
    if plan.model.cfg.moe is None:
        assert meta["positions"] == real["positions"]
    else:  # F.one_hot: arange + eq on meta, zeros + scatter on a device (test_torch_dryrun)
        for key in ("flops", "argument_bytes", "output_bytes", "alias_bytes"):
            assert meta["positions"][key] == real["positions"][key], key
        for key in ("eager_bytes", "peak_bytes"):
            assert meta["positions"][key] == pytest.approx(real["positions"][key], rel=0.05)
    assert meta["links"] == real["links"] and meta["exchanges"] == real["exchanges"]
    assert sum(meta["positions"]["flops"]) == meta["flops"]
    # every axis carries exchanges: the model axis the layers', data the gathers
    # (and a train step's gradients)
    axes = {peer.axis_crossed(grid, s, d) for _, s, d in meta["links"]}
    assert axes == {"data", "model"}
    kinds = {k for k, _, _ in meta["links"]}
    assert {"gather", "fan_out", "fan_in"} <= kinds
    assert ("reduce" in kinds) == (shape == "train_4k")
    # the links add up to the collectives' own totals
    for kind, v in meta["exchanges"].items():
        assert v["bytes"] == sum(link["bytes"] for (k, _, _), link in meta["links"].items()
                                 if k == kind), kind


@pytest.mark.parametrize("shape,mb", [("train_4k", 1), ("train_4k", 2), ("decode_32k", None)])
def test_the_two_group_shortcut_equals_the_full_trace_with_a_pod_axis(tiny, shape, mb):
    mesh = _grid({"pod": 2, "data": 2, "model": 2}, "meta")
    plan = _plan(LLAMA, shape, mesh, mb)
    full = dryrun.mesh_trace(plan, mesh)
    short = dryrun.mesh_trace(plan, mesh, groups=2)
    assert (full["groups"], full["traced_groups"], short["traced_groups"]) == (4, 4, 2)
    for key in ("flops", "eager_bytes", "peak_bytes", "argument_bytes", "output_bytes",
                "alias_bytes"):
        assert short["positions"][key] == full["positions"][key], key
    assert short["links"] == full["links"] and short["exchanges"] == full["exchanges"]
    assert (short["flops"], short["eager_bytes"]) == (full["flops"], full["eager_bytes"])
    # the gradients cross pods; the parameters' gathers stay in their pod
    axes = {(k, peer.axis_crossed(mesh.shape, s, d)) for k, s, d in full["links"]}
    assert ("gather", "pod") not in axes and ("gather", "data") in axes
    assert (("reduce", "pod") in axes) == (shape == "train_4k")


def _ref_spec_leaves(tree) -> list:
    import jax

    return [P(*s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))]


@pytest.mark.parametrize("grid", [{"data": 2, "model": 2}, {"pod": 2, "data": 2, "model": 2}],
                         ids=("2x2", "2x2x2"))
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_each_positions_arguments_are_its_shards_under_the_reference_pspecs(tiny, grid,
                                                                            shape):
    mesh = _grid(grid, "meta")
    plan = _plan(LLAMA, shape, mesh)
    ref = ref_specs.make_plan(LLAMA, shape, mesh, microbatches=2 if shape == "train_4k"
                              else None)
    leaves = checkpoint.leaves(plan.args)
    spec_leaves = _ref_spec_leaves(ref.in_shardings)
    assert len(leaves) == len(spec_leaves)
    # placed: the state or the params and the cache; the step counter, the
    # batch, the tokens and the decode position stay on the host
    placed = checkpoint.leaves(dryrun.place_args(plan, mesh))
    kept = [(leaf, spec) for leaf, spec, p in zip(leaves, spec_leaves, placed)
            if not isinstance(p, torch.Tensor)]
    want = dryrun.per_device_bytes([leaf for leaf, _ in kept], [spec for _, spec in kept],
                                   mesh.shape)
    assert dryrun.mesh_trace(plan, mesh)["positions"]["argument_bytes"] == [want] * mesh.size


def test_a_one_layer_toys_exchanges_and_collective_time_by_hand(tiny):
    """Llama's one scaled-down layer decoding on 1 × 2: the tied table (V, d)
    in the compute dtype resharded from d to the vocab over model (each
    position sends the other a quarter of it), and one fan-in of (B, 1, d)
    a row-parallel product (attention's and the MLP's)."""
    mesh = make_local_mesh(1, model=2, device="meta")
    plan = _plan(LLAMA, "decode_32k", mesh)
    cfg = plan.model.cfg
    assert cfg.num_layers == 1 and cfg.tie_embeddings
    mt = dryrun.mesh_trace(plan, mesh)
    rec = dryrun.mesh_record(LLAMA, "decode_32k", plan, mt, mesh, "1x2")
    v, d, b = cfg.vocab_size, cfg.d_model, plan.cell.global_batch
    act = torch.empty((), dtype=plan.model.compute_dtype).element_size()
    table = v * d * act  # the params cast to the compute dtype
    links = mt["links"]
    assert links["reshard", 0, 1]["bytes"] == links["reshard", 1, 0]["bytes"] == table // 4
    assert links["fan_in", 1, 0] == {"calls": 2, "bytes": 2 * b * d * act}
    coll = rec["collectives"]
    assert coll["per_kind_bytes"]["reshard"] == table // 2
    assert coll["per_kind_bytes"]["fan_in"] == 2 * b * d * act
    assert set(coll["per_axis_bytes"]) == {"data", "model"} and coll["per_axis_bytes"][
        "data"] == 0
    rates = rec["layout"]["axis_bytes_per_s"]
    assert rates == {"data": dryrun.NVLINK_BW, "model": dryrun.NVLINK_BW}
    sent = {p: sum(x["bytes"] for (_, s, _), x in links.items() if s == p) for p in (0, 1)}
    received = {p: sum(x["bytes"] for (_, _, t), x in links.items() if t == p) for p in (0, 1)}
    for p in (0, 1):
        assert rec["per_position"]["t_collective_s"][p] == max(sent[p], received[p]) / 450e9
    assert coll["total_bytes"] == sent[rec["busiest_position"]] + received[
        rec["busiest_position"]]


def test_the_collective_layout_bills_each_axis_at_its_slowest_link():
    net, nv = dryrun.NETWORK_BW, dryrun.NVLINK_BW
    assert dryrun.axis_rates({"data": 16, "model": 16}) == {"data": net, "model": net}
    assert dryrun.axis_rates({"pod": 2, "data": 16, "model": 16}) == dict.fromkeys(
        ("pod", "data", "model"), net)
    assert dryrun.axis_rates({"data": 32, "model": 8}) == {"data": net, "model": nv}
    assert dryrun.axis_rates({"data": 2, "model": 2}) == {"data": nv, "model": nv}
    # 1 GB each way on the model axis, 2 GB received over data: the axes in turn
    rates = {"data": net, "model": nv}
    assert dryrun.collective_seconds({"data": 0, "model": 1e9}, {"data": 2e9, "model": 1e9},
                                     rates) == 2e9 / net + 1e9 / nv
    assert peer.axis_crossed({"pod": 2, "data": 2, "model": 2}, 1, 5) == "pod"
    assert peer.axis_crossed({"pod": 2, "data": 2, "model": 2}, 1, 3) == "data"
    assert peer.axis_crossed({"pod": 2, "data": 2, "model": 2}, 2, 3) == "model"


def test_an_moe_decode_over_data_records_ok_with_its_rows_gathered_on_position_0(
        tiny, monkeypatch):
    """32 rows, two a group of pod16x16: the whole batch's token group of 32
    crosses the 16 data indices, so the record is ``ok`` and each MoE layer
    gathers every group's rows on position 0 and hands them back, over
    ``data``."""
    monkeypatch.setitem(SHAPE_CELLS, "decode_32k", ShapeCell("decode_32k", 24, 32, "decode"))
    (rec,) = dryrun.run_cell(MOE, "decode_32k", meshes=("single",))
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["traced_groups"] == 2
    assert "moe_gather" in rec["notes"]["collectives"]
    cfg = get_config(MOE).scaled_down()
    layers = sum(s.ffn == "moe" for s in cfg.layer_specs())
    row = 2 * cfg.d_model * getattr(torch, cfg.compute_dtype).itemsize  # two rows a group
    ex = rec["collectives"]["exchange_counts"]
    for kind in ("moe_gather", "moe_return"):
        assert ex[kind] == {"calls": layers, "bytes": 15 * row * layers}, kind
    mesh = make_local_mesh(16, model=16, device="meta")
    plan = _plan(MOE, "decode_32k", mesh)
    links = dryrun.mesh_trace(plan, mesh, groups=dryrun.SHORTCUT_GROUPS)["links"]
    moves = {k: v for k, v in links.items() if k[0].startswith("moe_")}
    assert moves == {**{("moe_gather", 16 * c, 0): {"calls": layers, "bytes": row * layers}
                        for c in range(1, 16)},
                     **{("moe_return", 0, 16 * c): {"calls": layers, "bytes": row * layers}
                        for c in range(1, 16)}}
    assert {peer.axis_crossed(mesh.shape, s, d) for _, s, d in moves} == {"data"}


def test_the_two_group_shortcut_equals_the_full_trace_of_an_moe_decode_over_data(tiny):
    """The MoE runs on group 0, traced; groups 2-3 stand in with zeros of
    their rows at each MoE layer, sent and handed back as the full trace's."""
    mesh = _grid({"pod": 2, "data": 2, "model": 2}, "meta")
    plan = _plan(MOE, "decode_32k", mesh)
    full = dryrun.mesh_trace(plan, mesh)
    short = dryrun.mesh_trace(plan, mesh, groups=2)
    for key in ("flops", "eager_bytes", "peak_bytes", "argument_bytes", "output_bytes",
                "alias_bytes"):
        assert short["positions"][key] == full["positions"][key], key
    assert short["links"] == full["links"] and short["exchanges"] == full["exchanges"]
    assert (short["flops"], short["eager_bytes"]) == (full["flops"], full["eager_bytes"])
    axes = {(k, peer.axis_crossed(mesh.shape, s, d)) for k, s, d in full["links"]}
    assert {("moe_gather", "data"), ("moe_gather", "pod"), ("moe_return", "pod")} <= axes


@pytest.mark.parametrize("shape,mb", [("train_4k", 2), ("prefill_32k", None),
                                      ("decode_32k", None)])
def test_a_seq_shard_meta_trace_equals_the_step_on_real_cpu_tensors(tiny, monkeypatch, shape,
                                                                    mb):
    monkeypatch.setitem(SHAPE_CELLS, "prefill_32k", TINY_PREFILL)
    grid = {"data": 2, "model": 2}
    meta_mesh, cpu_mesh = _grid(grid, "meta"), _grid(grid, "cpu")
    plan = _plan(LLAMA, shape, meta_mesh, mb, SEQ)
    meta = dryrun.mesh_trace(plan, meta_mesh)
    args = dryrun.materialize(plan, device="cpu", generator=torch.Generator().manual_seed(0))
    real = dryrun.mesh_trace(_plan(LLAMA, shape, cpu_mesh, mb, SEQ), cpu_mesh, args)
    assert meta["flops"] == real["flops"] > 0
    assert meta["positions"] == real["positions"]
    assert meta["links"] == real["links"] and meta["exchanges"] == real["exchanges"]
    kinds = {k for k, _, _ in meta["links"]}
    # the decode step (S = 1) is never split
    assert ({"seq_gather", "seq_reduce"} <= kinds) == (shape != "decode_32k")


@pytest.mark.parametrize("shape,mb", [("train_4k", 1), ("prefill_32k", None)])
def test_the_two_group_shortcut_equals_the_full_trace_under_seq_shard(tiny, monkeypatch,
                                                                     shape, mb):
    monkeypatch.setitem(SHAPE_CELLS, "prefill_32k", TINY_PREFILL)
    mesh = _grid({"pod": 2, "data": 2, "model": 2}, "meta")
    plan = _plan(LLAMA, shape, mesh, mb, SEQ)
    full = dryrun.mesh_trace(plan, mesh)
    short = dryrun.mesh_trace(plan, mesh, groups=2)
    for key in ("flops", "eager_bytes", "peak_bytes", "argument_bytes", "output_bytes",
                "alias_bytes"):
        assert short["positions"][key] == full["positions"][key], key
    assert short["links"] == full["links"] and short["exchanges"] == full["exchanges"]
    assert "seq_gather" in full["exchanges"]


def _four_heads(cfg):
    """4 query and KV heads, so attention splits over 4 model positions."""
    return dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, num_heads=4,
                                                                  num_kv_heads=4))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_under_seq_shard_every_model_position_carries_about_the_same_bytes(tiny, monkeypatch,
                                                                          shape):
    """On 1 × 4, the unsplit step's home fans every region's input out to
    3 positions and takes their partials back (more than twice position
    1's bytes over ``model``); split, each position gathers and
    reduce-scatters its own chunk: the same sequence bytes on every
    position, and the train step's position 0 within 5% of position 1 in
    all. (A prefill still gathers the keys and values on the home and
    writes them to their slots' owners from there, as unsplit, and sends
    its last token to the home for the logits.)"""
    monkeypatch.setitem(SHAPE_CELLS, "prefill_32k", TINY_PREFILL)
    cut = lambda name: _four_heads(get_config(name).scaled_down())  # noqa: E731
    monkeypatch.setattr(specs, "get_config", cut)
    monkeypatch.setattr(dryrun, "get_config", cut)
    mesh = _grid({"data": 1, "model": 4}, "meta")
    total, seq = {}, {}
    for rules in (None, SEQ):
        mt = dryrun.mesh_trace(_plan(LLAMA, shape, mesh, 1, rules), mesh)
        ex = dryrun.exchange_bytes(mt["links"], mesh.shape)
        total[rules] = [ex["sent"][p]["model"] + ex["received"][p]["model"] for p in range(4)]
        seq[rules] = [sum(ex["kind_bytes"][p].get(k, 0) for k in ("seq_gather", "seq_reduce"))
                      for p in range(4)]
    assert total[None][0] > 2 * total[None][1] and total[SEQ][0] < total[None][0]
    # (a prefill's last token also goes from the last chunk's position to the home)
    assert seq[None] == [0] * 4 and 0 < max(seq[SEQ]) - min(seq[SEQ]) <= 0.02 * min(seq[SEQ]) \
        if shape == "prefill_32k" else seq[SEQ] == [seq[SEQ][0]] * 4 and seq[SEQ][0] > 0
    if shape == "train_4k":
        assert abs(total[SEQ][0] - total[SEQ][1]) <= 0.05 * total[SEQ][1]


def test_a_seq_shard_record_says_what_ran_and_carries_no_missing_port_note(tiny):
    mesh = _grid({"data": 2, "model": 2}, "meta")
    plan = _plan(LLAMA, "train_4k", mesh, 2, SEQ)
    rec = dryrun.mesh_record(LLAMA, "train_4k", plan, dryrun.mesh_trace(plan, mesh), mesh,
                             "2x2", rules=SEQ)
    assert rec["status"] == "ok" and rec["seq_axis"] == "model"
    assert "seq" not in rec["notes"] and "seq_gather" in rec["notes"]["collectives"]
    assert rec["collectives"]["per_kind_bytes"]["seq_gather"] > 0
    unsplit = _plan(LLAMA, "train_4k", mesh, 2)
    plain = dryrun.mesh_record(LLAMA, "train_4k", unsplit, dryrun.mesh_trace(unsplit, mesh),
                               mesh, "2x2")
    assert plain["seq_axis"] is None and "seq_gather" not in plain["collectives"][
        "per_kind_bytes"]
