"""The port's sharding rules and collectives against the reference's
``repro.distribution``: the resolver's properties on the reference
test's fake mesh shapes (divisibility fallback, no axis reused, every
leaf covered, the period axis never sharded) with the port's specs equal
to the reference's for every arch; the one-device placement, lookup and
constraint; the model axis's refusals; and the collectives over S
shards against the reference's own functions under
``jax.vmap(..., axis_name=...)``, int8 payloads exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import ARCHS
from repro.distribution import collectives as jcol
from repro.distribution import sharding as jsh
from repro.models.model import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.distribution import collectives as col
from repro_torch.distribution import sharding as sh
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.train import checkpoint

import _torch_models as tm


class _FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


MESHES = ({"data": 2, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"data": 4, "model": 2})


def _spec_leaves(tree) -> list[tuple]:
    return [tuple(s) for s in checkpoint.leaves(tree)]


def _ref_spec_leaves(tree) -> list[tuple]:
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))]


# ------------------------------ the resolver -------------------------------


@given(dim=st.integers(1, 4096), axis=st.sampled_from([2, 3, 16]))
@settings(max_examples=40, deadline=None)
def test_resolver_divisibility_fallback(dim, axis):
    mesh = _FakeMesh({"data": axis, "model": 16})
    spec = sh._resolve_spec(("fsdp",), (dim,), mesh, sh.ShardingRules())
    got = spec[0] if len(spec) else None
    assert got == ("data" if dim % axis == 0 else None)
    assert tuple(spec) == tuple(jsh._resolve_spec(("fsdp",), (dim,), mesh, jsh.ShardingRules()))


@pytest.mark.parametrize("logical,shape", [
    (("fsdp", "fsdp"), (16, 16)), (("batch", "fsdp", "tp"), (8, 16, 16)),
    (("tp", "vocab"), (16, 32)), (("row_blocks", "fsdp"), (16, 16)),
])
def test_resolver_never_reuses_axis(logical, shape):
    mesh = _FakeMesh({"data": 4, "model": 4})
    spec = sh._resolve_spec(logical, shape, mesh, sh.ShardingRules())
    flat = [a for s in spec if s is not None for a in (s if isinstance(s, tuple) else (s,))]
    assert len(flat) == len(set(flat))
    assert tuple(spec) == tuple(jsh._resolve_spec(logical, shape, mesh, jsh.ShardingRules()))


@pytest.mark.parametrize("rules", [{}, {"shard_vocab": False, "seq_axis": "model"},
                                   {"tp_axis": None, "cache_seq_axis": None}])
def test_rules_resolve_every_logical_axis_as_the_reference(rules):
    mine, ref = sh.ShardingRules(**rules), jsh.ShardingRules(**rules)
    for logical in (None, "batch", "fsdp", "tp", "vocab", "cache_seq", "seq", "row_blocks"):
        assert mine.resolve(logical) == ref.resolve(logical), logical
    with pytest.raises(ValueError, match="unknown logical axis"):
        mine.resolve("experts")


def _both_params(arch: str):
    if arch == tm.SPARSE_MLP_ID:  # pruning reads values: concrete params
        from repro_torch import convert

        ref_cfg, cfg = tm.configs(arch, "float32")
        jp = tm.ref_params(RefModel(ref_cfg))
        return cfg, jp, convert.model_params(jp, device="cpu")
    from repro.configs import get_config as ref_get_config

    ref_cfg, cfg = ref_get_config(arch).scaled_down(), get_config(arch).scaled_down()
    return cfg, jax.eval_shape(RefModel(ref_cfg).init, jax.random.key(0)), \
        Model(cfg).init(device="meta")


@pytest.mark.parametrize("arch", sorted(ARCHS) + [tm.SPARSE_MLP_ID])
def test_param_pspecs_equal_the_reference_and_cover_all_leaves(arch):
    cfg, jshapes, shapes = _both_params(arch)
    leaves = checkpoint.leaves(shapes)
    assert [tuple(x.shape) for x in leaves] == [x.shape for x in jax.tree.leaves(jshapes)]
    for shape in MESHES:
        mesh = _FakeMesh(shape)
        specs = sh.param_pspecs(cfg, shapes, mesh, sh.ShardingRules())
        got = _spec_leaves(specs)
        assert len(got) == len(leaves)
        assert all(len(s) <= leaf.ndim for s, leaf in zip(got, leaves))
        assert got == _ref_spec_leaves(jsh.param_pspecs(None, jshapes, mesh, jsh.ShardingRules()))


def test_period_leading_axis_never_sharded():
    names = ["stack", "period", "0", "ffn", "w_in"]
    axes = sh._logical_axes(names, 3)  # stacked (L, d, ff)
    assert axes[0] is None and axes == jsh._logical_axes(names, 3)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "jamba-v0.1-52b",
                                  "rwkv6-3b"])
def test_cache_and_batch_pspecs_equal_the_reference(arch):
    from repro.configs import get_config as ref_get_config

    ref_model = RefModel(ref_get_config(arch).scaled_down())
    model = Model(get_config(arch).scaled_down())
    jcache = jax.eval_shape(lambda: ref_model.init_cache(4, 32))
    cache = model.init_cache(4, 32, device="meta")
    for shape in MESHES:
        mesh = _FakeMesh(shape)
        assert (_spec_leaves(sh.cache_pspecs(model.cfg, cache, mesh))
                == _ref_spec_leaves(jsh.cache_pspecs(None, jcache, mesh)))
        for rules in ({}, {"seq_axis": "model"}):
            got = sh.batch_pspecs(mesh, sh.ShardingRules(**rules))
            want = jsh.batch_pspecs(mesh, jsh.ShardingRules(**rules))
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


# ------------------------- one device: placement -------------------------


def test_shardings_put_every_leaf_on_the_mesh_device():
    cfg = get_config("llama3.2-1b").scaled_down()
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_local_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    places = sh.shardings_for(None, mesh, sh.param_pspecs(cfg, params, mesh))
    shardings = checkpoint.leaves(places)
    assert len(shardings) == len(checkpoint.leaves(params))
    assert {s.devices for s in shardings} == {(torch.device("cpu"),)}
    assert {s.dim for s in shardings} == {None}  # one position: every leaf whole
    placed = sh.place(params, places)
    for leaf, want in zip(checkpoint.leaves(placed), checkpoint.leaves(params)):
        assert len(leaf.chunks) == 1 and torch.equal(leaf.chunks[0], want)


def test_embed_lookup_and_constrain_on_one_device():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (8, 12)).astype(np.int32))
    want = table.numpy()[ids.numpy()]
    assert sh.active_rules() is None
    np.testing.assert_array_equal(sh.embed_lookup(table, ids).numpy(), want)
    rules = sh.ShardingRules(seq_axis="model")
    with sh.activate(make_local_mesh(device="cpu"), rules):
        assert sh.active_rules() is rules
        np.testing.assert_array_equal(sh.embed_lookup(table, ids).numpy(), want)
        x = torch.ones((8, 12, 16))
        assert sh.constrain(x, ("batch", "seq", "tp")) is x
        with pytest.raises(ValueError, match="unknown logical axis"):
            sh.constrain(x, ("batch", "experts", None))
        grads = [torch.ones(3), None]
        assert sh.constrain_like_params(grads) is grads
    assert sh.active_rules() is None
    np.testing.assert_array_equal(
        np.asarray(jsh.embed_lookup(jnp.asarray(table.numpy()), jnp.asarray(ids.numpy()))), want)


def test_model_meshes_past_one_device_are_refused():
    """What the model axis still refuses: the production mesh on a host
    without its cards (and the card by default where there is none).
    Every arch's train state builds on ``data`` × ``model`` meshes, its
    leaves split over ``model`` (MLA, Mamba and RWKV-6 included:
    ``test_torch_model_mesh*.py`` trains on them), and prefill and decode
    on a group's split params run (a cache held whole on the home device;
    placed caches: ``test_torch_model_mesh_serve*.py``)."""
    from repro_torch.distribution.sharding import group_params
    from repro_torch.train import sgd
    from repro_torch.train.trainer import init_train_state

    assert make_local_mesh(device="cpu", data=2).shape == {"data": 2, "model": 1}
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (2, 5)).astype(np.int32))
    for kw in ({"model": 2}, {"data": 2, "model": 2}):
        mesh = make_local_mesh(device="cpu", **kw)
        assert mesh.shape == {"data": kw.get("data", 1), "model": 2}
        for arch in ("deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b", "llama3.2-1b"):
            model = Model(get_config(arch).scaled_down())
            state = init_train_state(model, sgd(1e-2), torch.Generator().manual_seed(0),
                                     mesh=mesh)
            owners = checkpoint.leaves(state.params)
            assert any(x.sharding.model_dim is not None for x in owners), arch
            group = group_params(state.params, owners, mesh)[0]
            logits, cache = model.prefill(group, ids, model.init_cache(2, 16, device="cpu"))
            assert logits.shape == (2, 1, 512) and bool(torch.isfinite(logits).all()), arch
            logits, _ = model.decode_step(group, ids[:, 0], cache, 5)
            assert logits.shape == (2, 512) and bool(torch.isfinite(logits).all()), arch
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match=r"production mesh .*cuda:\d+ … cuda:\d+"):
            make_production_mesh(multi_pod=multi_pod)
    assert make_production_mesh(device="meta").shape == {"data": 16, "model": 16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()  # entry points default to the card


# ------------------------------ collectives --------------------------------


def _shards(seed: int, s: int = 8, shape=(256,), scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((s, *shape)) * scale).astype(np.float32)


def _ref_vmap(fn, *args):
    return jax.vmap(fn, axis_name="d")(*[jnp.asarray(a) for a in args])


@pytest.mark.parametrize("shards,shape,scale", [(8, (256,), 1.0), (4, (16, 33), 1e-3),
                                                (3, (7,), 5e4)])
def test_quantize_int8_payloads_equal_the_reference(shards, shape, scale):
    x = _shards(1, shards, shape, scale)
    q, s = col.quantize_int8(torch.from_numpy(x))
    jq, js = _ref_vmap(lambda v: jcol.quantize_int8(v, "d"), x)
    assert q.dtype == torch.int8 and tuple(q.shape) == (shards, *shape)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    ql, _ = col.quantize_int8([torch.from_numpy(v) for v in x])  # a list of shards
    np.testing.assert_array_equal(ql.numpy(), q.numpy())


@pytest.mark.parametrize("shards", [2, 8])
def test_compressed_psum_mean_equals_the_reference_over_repeats(shards):
    x = _shards(2, shards)
    err = np.zeros_like(x)
    perr = torch.zeros(x.shape)
    # op by op: under jax.jit, XLA contracts the error's multiply-subtract
    # into one fused op and the error moves by an ulp
    fn = jax.vmap(lambda v, e: jcol.compressed_psum_mean(v, "d", e), axis_name="d")
    for _ in range(4):  # error feedback carried step to step in both
        jm, err = fn(jnp.asarray(x), jnp.asarray(err))
        m, perr = col.compressed_psum_mean(torch.from_numpy(x), perr)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(perr.numpy(), np.asarray(err))


def test_compressed_psum_mean_quantization_bound_and_error_feedback():
    """The reference's multi-device semantics on 8 shards in one process:
    the first mean within one int8 step of the exact mean, the running
    mean over 25 repeats within a fifth of a step."""
    x = torch.from_numpy(_shards(2))
    exact = x.mean(dim=0)
    step = float(x.abs().max() / 127.0)
    err = col.init_error_state(x)
    m1, err = col.compressed_psum_mean(x, err)
    assert bool((m1 == m1[0]).all())  # every shard holds the mean
    assert float((m1[0] - exact).abs().max()) <= step + 1e-6
    acc = m1[0].clone()
    for _ in range(24):
        m, err = col.compressed_psum_mean(x, err)
        acc += m[0]
    assert float((acc / 25.0 - exact).abs().max()) < step * 0.2


def test_compressed_psum_mean_tree_and_error_state_match_the_reference():
    tree = {"w": _shards(3, 4, (8, 8)), "b": [_shards(4, 4, (8,)), _shards(5, 4, (3, 2))]}
    ptree = {"w": torch.from_numpy(tree["w"]), "b": [torch.from_numpy(v) for v in tree["b"]]}
    perr = col.init_error_state(ptree)
    assert all(bool((e == 0).all()) and e.dtype == torch.float32
               for e in checkpoint.leaves(perr))
    jerr = jcol.init_error_state(jax.tree.map(jnp.asarray, tree))
    jm, jerr = jax.vmap(lambda g, e: jcol.compressed_psum_mean_tree(g, "d", e), axis_name="d")(
        jax.tree.map(jnp.asarray, tree), jerr)
    m, perr = col.compressed_psum_mean_tree(ptree, perr)
    for got, want in zip(checkpoint.leaves(m) + checkpoint.leaves(perr),
                         jax.tree.leaves(jm) + jax.tree.leaves(jerr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bucket_bytes", [1, 4096, 32 * 1024 * 1024])
def test_bucketed_keeps_the_reference_paths_and_bytes(bucket_bytes):
    jp = tm.ref_params(RefModel(tm.configs("deepseek-v2-236b", "float32")[0]))
    from repro_torch import convert

    p = convert.model_params(jp, device="cpu")
    got = col.bucketed(p, bucket_bytes)
    want = jcol.bucketed(jp, bucket_bytes)

    def name(k):
        return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))

    assert [[(path, leaf.numel() * leaf.element_size()) for path, leaf in b] for b in got] == [
        [(tuple(name(k) for k in path), leaf.size * leaf.dtype.itemsize) for path, leaf in b]
        for b in want]
