"""The port's configuration registry against the reference's: every
configuration and its ``scaled_down()`` field for field, the registry's
lookups, and the parameter trees ``Model.init`` builds (on the ``meta``
device) against the reference's ``jax.eval_shape`` — paths, shapes and
the parameter counts."""

import dataclasses
import math

import jax
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ASSIGNED_ARCHS as REF_ASSIGNED
from repro.configs import SHAPE_CELLS as REF_CELLS
from repro.configs import get_config as ref_get_config
from repro.configs import graphblas_mlp as ref_graphblas_mlp
from repro.configs.base import LayerSpec as RefLayerSpec
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models.model import Model as RefModel
from repro_torch.configs import ARCHS, ASSIGNED_ARCHS, SHAPE_CELLS, get_config, graphblas_mlp
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import Model
from repro_torch.models.layers import SPARSE

ARCH_IDS = sorted(REF_ARCHS)
MLP_GRID = [dict(), dict(m=512, inverse_sparsity=8), dict(m=8192, num_layers=8,
                                                          inverse_sparsity=16, block=128),
            dict(m=64, num_layers=2, inverse_sparsity=2, block=16), dict(inverse_sparsity=1)]


def _fields(cfg) -> dict:
    return {"type": type(cfg).__name__, **dataclasses.asdict(cfg)}


def test_registry_lists_the_same_architectures():
    assert ASSIGNED_ARCHS == REF_ASSIGNED and list(ARCHS) == list(REF_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPE_CELLS.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_CELLS.items()}
    assert _fields(get_config("graphblas-mlp-m8192")) == _fields(
        ref_get_config("graphblas-mlp-m8192"))
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_its_scaled_down_match_field_for_field(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert _fields(cfg) == _fields(ref)
    for kw in (dict(), dict(num_layers=9, d_model=32), dict(max_seq_len=128)):
        small, ref_small = cfg.scaled_down(**kw), ref.scaled_down(**kw)
        assert _fields(small) == _fields(ref_small), kw
        assert small.n_periods == ref_small.n_periods
        assert [dataclasses.asdict(s) for s in small.layer_specs()] == [
            dataclasses.asdict(s) for s in ref_small.layer_specs()]
    assert (cfg.n_periods, cfg.sub_quadratic) == (ref.n_periods, ref.sub_quadratic)


@pytest.mark.parametrize("kw", MLP_GRID)
def test_graphblas_mlp_configs_match(kw):
    assert _fields(graphblas_mlp.make_config(**kw)) == _fields(ref_graphblas_mlp.make_config(**kw))


def test_layer_counts_that_cannot_be_reached_are_refused_alike():
    for cls, spec in ((ModelConfig, LayerSpec), (RefModelConfig, RefLayerSpec)):
        with pytest.raises(ValueError):
            cls(name="x", family="dense", num_layers=5, d_model=8, d_ff=8, vocab_size=8,
                period=(spec(), spec()))


def _ref_shapes(cfg) -> dict:
    shapes = jax.eval_shape(RefModel(cfg).init, jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {jax.tree_util.keystr(path): tuple(leaf.shape) for path, leaf in flat}


def _port_shapes(cfg) -> dict:
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}['{k}']")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")
        else:
            assert not isinstance(tree, SPARSE) and tree.device.type == "meta"
            out[path] = tuple(tree.shape)

    walk(Model(cfg).init(device="meta"), "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_trees_and_counts_match(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    for c, r in ((cfg, ref), (cfg.scaled_down(), ref.scaled_down())):
        assert _port_shapes(c) == _ref_shapes(r)
    model, ref_model = Model(cfg), RefModel(ref)
    assert model.param_count() == ref_model.param_count()
    assert model.active_param_count() == ref_model.active_param_count()


def test_llama_published_width_counts():
    """The card's llm-serve phase sizes its weights from this count."""
    n = Model(get_config("llama3.2-1b")).param_count()
    assert n == 1_235_814_400 and math.isclose(4 * n / 1e9, 4.94, abs_tol=0.01)
