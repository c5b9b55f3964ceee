"""The port's shape specs and serve fns against the reference's
``repro.launch.specs`` and ``repro.serve.engine.make_serve_fns``:
``skip_reason``, ``model_flops`` and ``input_specs`` for every arch and
cell; ``make_plan``'s name, static fields, donation, argument shapes and
dtypes, and input and output specs leaf by leaf in the reference's leaf
order, on both production mesh shapes with and without sequence
sharding (both packages read only ``mesh.shape``); the serve fns'
logits on the reference's converted weights at ``tests/_torch_models``'
tolerances; the meta production mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_models as tm
from repro.distribution.sharding import ShardingRules as RefRules
from repro.launch import specs as ref_specs
from repro.models.model import Model as RefModel
from repro.serve.engine import make_serve_fns as ref_make_serve_fns
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPE_CELLS, get_config
from repro_torch.distribution.sharding import ShardingRules
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train import checkpoint

CELLS = [(a, s) for a in ARCHS for s in SHAPE_CELLS]
MESH_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


def _ref_shapes(tree) -> list[tuple]:
    return [(tuple(x.shape), str(np.dtype(x.dtype))) for x in jax.tree.leaves(tree)]


def _shapes(tree) -> list[tuple]:
    return [(tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for x in checkpoint.leaves(tree)]


def _ref_spec_leaves(tree) -> list[tuple]:
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))]


def _spec_leaves(tree) -> list[tuple]:
    return [tuple(s) for s in checkpoint.leaves(tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reason_and_model_flops_equal_the_reference(arch, shape):
    from repro.configs import SHAPE_CELLS as REF_CELLS
    from repro.configs import get_config as ref_get_config

    assert specs.skip_reason(get_config(arch), SHAPE_CELLS[shape]) == ref_specs.skip_reason(
        ref_get_config(arch), REF_CELLS[shape])
    assert specs.model_flops(arch, shape) == ref_specs.model_flops(arch, shape)
    cut = specs.model_flops(arch, shape, global_batch=1)
    assert cut["n_active"] == ref_specs.model_flops(arch, shape)["n_active"]
    assert cut["model_flops"] * SHAPE_CELLS[shape].global_batch == pytest.approx(
        ref_specs.model_flops(arch, shape)["model_flops"], rel=1e-12)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_have_the_reference_shapes_and_dtypes(arch):
    for shape in SHAPE_CELLS:
        got = specs.input_specs(arch, shape)
        assert all(t.device.type == "meta" for t in got.values())
        assert _shapes(got) == _ref_shapes(ref_specs.input_specs(arch, shape)), shape


@pytest.mark.parametrize("mesh_shape", MESH_SHAPES, ids=("pod16x16", "pod2x16x16"))
@pytest.mark.parametrize("seq_shard", (False, True), ids=("batch", "seq"))
def test_make_plan_equals_the_reference(mesh_shape, seq_shard):
    mesh = _FakeMesh(mesh_shape)
    rules = (ShardingRules(seq_axis="model"), RefRules(seq_axis="model")) if seq_shard \
        else (None, None)
    for arch, shape in CELLS:
        if specs.skip_reason(get_config(arch), SHAPE_CELLS[shape]):
            with pytest.raises(ValueError, match="cell skipped"):
                specs.make_plan(arch, shape, mesh, rules=rules[0])
            continue
        got = specs.make_plan(arch, shape, mesh, rules=rules[0])
        ref = ref_specs.make_plan(arch, shape, mesh, rules=rules[1])
        where = (arch, shape)
        assert (got.name, got.static, got.donate_argnums) == (
            ref.name, ref.static, ref.donate_argnums), where
        assert _shapes(got.args) == _ref_shapes(ref.args), where
        assert _spec_leaves(got.in_shardings) == _ref_spec_leaves(ref.in_shardings), where
        assert _spec_leaves(got.out_shardings) == _ref_spec_leaves(ref.out_shardings), where
        devices = {t.device.type for t in checkpoint.leaves(got.args)}
        # the decode position and the optimizer's step live on the host
        assert devices == ({"meta", "cpu"} if got.static["kind"] in ("train", "decode")
                           else {"meta"}), where


def test_make_plan_cuts_the_batch_and_keeps_the_model_and_cell():
    mesh = make_production_mesh(device="meta")
    plan = specs.make_plan("llama3.2-1b", "decode_32k", mesh, global_batch=3)
    assert plan.cell == dataclasses.replace(SHAPE_CELLS["decode_32k"], global_batch=3)
    assert plan.model.cfg == get_config("llama3.2-1b")
    assert plan.args[1].shape == (3,)
    assert {t.shape[1] for t in checkpoint.leaves(plan.args[2]) if t.dim() == 5} == {3}
    train = specs.make_plan("llama3.2-1b", "train_4k", mesh, microbatches=1, global_batch=2)
    assert train.static == {"microbatches": 1, "kind": "train"}
    assert train.args[1]["inputs"].shape == (2, 4096)
    assert train.args[0].opt.step.device.type == "cpu"
    assert all(m.dtype == torch.bfloat16 for m in train.args[0].opt.mu if m.is_floating_point())


def test_production_mesh_is_made_on_meta_only():
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        assert mesh.shape == shape and mesh.size == (512 if multi_pod else 256)
        assert mesh.device == torch.device("meta")
        for device in (None, "cpu", "cuda"):
            with pytest.raises(ValueError, match="production mesh"):
                make_production_mesh(multi_pod=multi_pod, device=device)


# the serve fns on the reference's converted weights: a dense, an MoE and an
# SSM arch, at f32 and bf16 compute
SERVE_ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "rwkv6-3b")


@pytest.mark.parametrize("dtype", tm.DTYPES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_fns_give_the_reference_logits(arch, dtype):
    ref_cfg, cfg = tm.configs(arch, dtype)
    jp = tm.ref_params(RefModel(dataclasses.replace(ref_cfg, compute_dtype="float32")))
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    ref_prefill, ref_decode = ref_make_serve_fns(ref_model)
    prefill, decode = make_serve_fns(model)
    inp = tm.inputs(cfg)
    prefix, nxt = inp[:, :tm.S], inp[:, tm.S]
    jl, jc = ref_prefill(jp, jnp.asarray(prefix), ref_model.init_cache(tm.B, tm.CACHE))
    jd, _ = ref_decode(jp, jnp.asarray(nxt), jc, jnp.asarray(tm.S, jnp.int32))
    p = convert.model_params(jp, device="cpu")
    cache = model.init_cache(tm.B, tm.CACHE, device="cpu")
    pl, cache = prefill(p, torch.from_numpy(np.ascontiguousarray(prefix)), cache)
    d, _ = decode(p, torch.from_numpy(np.ascontiguousarray(nxt)), cache,
                  torch.tensor(tm.S, dtype=torch.int32))
    tm.assert_logits_match(tm.f32(jl[:, -1]), tm.f32(pl[:, -1]), dtype)
    tm.assert_logits_match(tm.f32(jd), tm.f32(d), dtype)
