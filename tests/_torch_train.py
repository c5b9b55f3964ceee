"""Shared by the train-step parity tests (``test_torch_trainer.py``,
``test_torch_arch_train*.py``): one train step of the reference and of
the port on the same converted weights and the same numpy batch."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import Model as RefModel
from repro.train import adamw as ref_adamw
from repro.train import make_train_step as ref_make_train_step
from repro.train import sgd as ref_sgd
from repro.train.trainer import TrainState as RefTrainState
from repro_torch import convert
from repro_torch.models import Model
from repro_torch.train import adamw, checkpoint, make_train_step, sgd
from repro_torch.train.trainer import TrainState, loss_and_grads

import _torch_models as tm

B, S = 2, 16
LOSS_RTOL = 1e-5  # f32 compute: |port - reference| <= 1e-5 |reference|
GRAD_RTOL = 1e-4  # each float leaf: max|port - reference| <= 1e-4 max|reference|


def batch(cfg, seed: int = 0, b: int = B, s: int = S) -> dict:
    """Inputs (tokens, embeddings or features) and in-range labels, numpy."""
    rng = np.random.default_rng(seed + 100)
    shape = (b, 1) if cfg.input_mode == "features" else (b, s)
    return {"inputs": tm.inputs(cfg, seed=seed, b=b, s=s),
            "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}


def as_ref(host: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in host.items()}


def as_port(host: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}


def models(arch: str, dtype: str = "float32"):
    """(reference model, port model, reference params, port params) on the
    same weights, converted through numpy."""
    ref_cfg, cfg = tm.configs(arch, dtype)
    ref_model, model = RefModel(ref_cfg), Model(cfg)
    jp = tm.ref_params(ref_model)
    return ref_model, model, jp, convert.model_params(jp, device="cpu")


def optimizers(kind: str, **kw):
    """(reference, port) optimizer of one kind and settings."""
    return (ref_sgd(**kw), sgd(**kw)) if kind == "sgd" else (ref_adamw(**kw), adamw(**kw))


def host(leaf):
    """A leaf as a numpy array (floats as f32), or None for a leaf with no
    gradient (the port's None, the reference's ``float0``)."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return (leaf.detach().float() if leaf.is_floating_point() else leaf).numpy()
    if leaf.dtype == jax.dtypes.float0:
        return None
    return np.asarray(leaf.astype(jnp.float32) if jnp.issubdtype(leaf.dtype, jnp.floating)
                      else leaf)


def ref_grads(ref_model, jp, batch_np: dict) -> list:
    _, g = jax.value_and_grad(ref_model.loss, has_aux=True, allow_int=True)(jp, as_ref(batch_np))
    return [host(leaf) for leaf in jax.tree.leaves(g)]


def port_grads(model, p, batch_np: dict) -> list:
    return [host(leaf) for leaf in loss_and_grads(model, p, as_port(batch_np))[2]]


def steps(ref_model, model, jp, p, batch_np: dict, kind: str, *, microbatches: int = 1, **kw):
    """One train step of each package from the same weights:
    ``((reference state, metrics), (port state, metrics))``."""
    jopt, popt = optimizers(kind, **kw)
    jstep = jax.jit(ref_make_train_step(ref_model, jopt, microbatches=microbatches))
    pstep = make_train_step(model, popt, microbatches=microbatches)
    return (jstep(RefTrainState(jp, jopt.init(jp)), as_ref(batch_np)),
            pstep(TrainState(p, popt.init(checkpoint.leaves(p))), as_port(batch_np)))


def param_leaves(ref_state, port_state) -> tuple[list, list]:
    return ([host(x) for x in jax.tree.leaves(ref_state.params)],
            [host(x) for x in checkpoint.leaves(port_state.params)])


def assert_leaves_close(ref: list, got: list, rtol: float = GRAD_RTOL) -> float:
    """Leaf for leaf: float leaves within ``rtol`` of the leaf's max
    |reference|, index leaves equal, no-gradient leaves in both; returns
    the worst float leaf's error over its scale."""
    assert len(ref) == len(got)
    worst = 0.0
    for r, g in zip(ref, got):
        if r is None or g is None:
            assert r is None and g is None
            continue
        assert r.shape == g.shape and r.dtype == g.dtype, (r.shape, g.shape, r.dtype, g.dtype)
        if r.dtype.kind != "f":
            np.testing.assert_array_equal(g, r)
            continue
        assert np.isfinite(g).all()
        err = float(np.abs(g.astype(np.float64) - r).max()) / max(float(np.abs(r).max()), 1e-30)
        assert err <= rtol, (err, r.shape)
        worst = max(worst, err)
    return worst


def assert_metrics_close(jm: dict, pm: dict) -> None:
    """Loss within ``LOSS_RTOL``, ``grad_norm`` within ``GRAD_RTOL``."""
    for k, tol in (("loss", LOSS_RTOL), ("ce", LOSS_RTOL), ("grad_norm", GRAD_RTOL)):
        want, got = float(jm[k]), float(pm[k])
        assert np.isfinite(got) and abs(got - want) <= tol * abs(want), (k, got, want)
    np.testing.assert_allclose(float(pm["moe_aux"]), float(jm["moe_aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
