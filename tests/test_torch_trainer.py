"""The model API's train step (``repro_torch.train.trainer``) against the
reference's ``repro.train.trainer``: the ``Model`` cases of
``test_trainer.py`` on the port, one step from converted weights held to
the reference's jitted step (loss, gradients, SGD-updated params;
microbatched against microbatched), and ``TrainState`` checkpoints that
either package restores."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import graphblas_mlp as ref_graphblas_mlp
from repro.models.model import Model as RefModel
from repro.train import adamw as ref_adamw
from repro.train import checkpoint as jcheckpoint
from repro.train import make_train_step as ref_make_train_step
from repro.train.trainer import TrainState as RefTrainState
from repro_torch import convert
from repro_torch.configs import get_config, graphblas_mlp
from repro_torch.data import SyntheticLM
from repro_torch.models import Model
from repro_torch.train import adamw, checkpoint, make_train_step, sgd
from repro_torch.train.fault_tolerance import StragglerPolicy, Supervisor
from repro_torch.train.optimizer import warmup_cosine
from repro_torch.train.trainer import TrainState, init_train_state

import _torch_train as tt


@pytest.fixture(scope="module")
def small():
    cfg = get_config("llama3.2-1b").scaled_down()
    model = Model(cfg)
    opt = adamw(3e-3, weight_decay=0.0)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, opt, state


def _batch(cfg, i, b=8, s=32):
    return tt.as_port(SyntheticLM(cfg.vocab_size, s, b, seed=1).batch(i))


def test_loss_decreases(small):
    cfg, model, opt, state = small
    step = make_train_step(model, opt)
    losses = []
    for i in range(25):
        state, m = step(state, _batch(cfg, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses[::6]


def test_microbatch_equivalence(small):
    """Accumulated gradients match the full-batch step, under SGD (AdamW's
    m/√v is sign-like near zero: the reference's own reason)."""
    cfg, model, _, _ = small
    opt = sgd(1e-2, momentum=0.0)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0), device="cpu")
    b = _batch(cfg, 0)
    st1, m1 = make_train_step(model, opt, microbatches=1)(state, b)
    st4, m4 = make_train_step(model, opt, microbatches=4)(state, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-4)
    for a, c in zip(checkpoint.leaves(st1.params), checkpoint.leaves(st4.params)):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-3, atol=2e-4)


def test_schedule():
    sched = warmup_cosine(1.0, 10, 110, final_frac=0.1)
    assert float(sched(torch.tensor(0))) == 0.0
    assert abs(float(sched(torch.tensor(10))) - 1.0) < 1e-6
    assert float(sched(torch.tensor(110))) == pytest.approx(0.1, abs=1e-3)
    assert float(sched(torch.tensor(60))) < 1.0


def test_sgd_momentum_runs(small):
    cfg, model, _, _ = small
    opt = sgd(1e-2)
    state = init_train_state(model, opt, torch.Generator().manual_seed(1), device="cpu")
    state, m = make_train_step(model, opt)(state, _batch(cfg, 0))
    assert bool(torch.isfinite(m["loss"])) and int(state.opt.step) == 1


def test_checkpoint_roundtrip_and_retention(small):
    cfg, model, opt, state = small
    state, _ = make_train_step(model, opt)(state, _batch(cfg, 0))  # moments nonzero
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 10):
            checkpoint.save(d, s, state, metadata={"arch": cfg.name})
        checkpoint.retention(d, keep_last=2, keep_every=10)
        steps = sorted(int(x.split("_")[1]) for x in os.listdir(d) if x.startswith("step_"))
        assert steps == [4, 10]
        like = init_train_state(model, opt, torch.Generator().manual_seed(5), device="cpu")
        restored, manifest = checkpoint.restore(d, like)
        assert manifest["step"] == 10 and isinstance(restored, TrainState)
        assert isinstance(restored.opt.mu, list)
        a, b = checkpoint.leaves(state), checkpoint.leaves(restored)
        assert len(a) == len(b) == 1 + 3 * len(checkpoint.leaves(state.params))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_checkpoint_shape_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"w": torch.zeros((4, 4))})
        with pytest.raises(ValueError):
            checkpoint.restore(d, {"w": torch.zeros((8, 8))})


def test_supervisor_restores_after_fault(small):
    cfg, model, opt, state = small
    step_fn = make_train_step(model, opt)
    calls = {"n": 0}

    def step(st, i):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected failure")
        return step_fn(st, _batch(cfg, i))[0]

    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(step_fn=step, save_state=lambda s: s,
                         load_state=lambda t: TrainState(*t), ckpt_dir=d, ckpt_interval=2)
        final = sup.run(state, 8)
        assert any("fault" in h[1] for h in sup.history)
        assert int(final.opt.step) == 8


def test_supervisor_gives_up_after_max_restarts(small):
    _, _, _, state = small

    def bad_step(st, i):
        raise RuntimeError("always fails")

    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 0, state)
        sup = Supervisor(step_fn=bad_step, save_state=lambda s: s,
                         load_state=lambda t: TrainState(*t), ckpt_dir=d, max_restarts=2)
        with pytest.raises(RuntimeError, match="exceeded"):
            sup.run(state, 3)


def test_straggler_policy():
    p = StragglerPolicy(deadline_factor=2.0, evict_after=2)
    fired = [p.observe(t) for t in [1.0, 1.0, 1.0, 1.0, 1.0, 5.0, 5.0, 1.0]]
    assert fired[6] and not any(fired[:6])
    assert not fired[7]


def test_sparse_mlp_trainable():
    """The paper's sparse network retrains through ``Model``: gradients
    reach the stored blocks, pad slots keep 0, topology is untouched."""
    cfg = graphblas_mlp.make_config(m=64, num_layers=2, inverse_sparsity=2, block=16)
    model = Model(cfg)
    params = model.sparsify(model.init(torch.Generator().manual_seed(0), device="cpu"))
    opt = adamw(1e-2, weight_decay=0.0)
    state = TrainState(params, opt.init(checkpoint.leaves(params)))
    step = make_train_step(model, opt)
    g = torch.Generator().manual_seed(1)
    batch = {"inputs": torch.rand((8, 64), generator=g),
             "labels": torch.randint(0, 64, (8, 1), generator=g, dtype=torch.int32)}
    w0 = params["stack"]["period"][0]["ffn"]["w"]
    losses = []
    for _ in range(20):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.2 and np.isfinite(losses).all()
    w = state.params["stack"]["period"][0]["ffn"]["w"]
    assert w.col_idx is w0.col_idx and w.block_mask is w0.block_mask
    assert not torch.equal(w.blocks, w0.blocks)


# --------------------------- against the reference --------------------------


@pytest.mark.parametrize("arch,microbatches", [
    ("llama3.2-1b", 1), ("llama3.2-1b", 2), (tt.tm.SPARSE_MLP_ID, 1), (tt.tm.SPARSE_MLP_ID, 2),
])
def test_one_step_matches_reference(arch, microbatches):
    """Gradients, loss and the SGD update of one step, f32 compute, from the
    reference's weights; microbatched against the reference microbatched."""
    ref_model, model, jp, p = tt.models(arch)
    b = 4 if arch == tt.tm.SPARSE_MLP_ID else tt.B
    host = tt.batch(model.cfg, b=b)
    if microbatches == 1:
        tt.assert_leaves_close(tt.ref_grads(ref_model, jp, host), tt.port_grads(model, p, host))
    (js, jm), (ps, pm) = tt.steps(ref_model, model, jp, p, host, "sgd", lr=1e-2, momentum=0.0,
                                  microbatches=microbatches)
    tt.assert_metrics_close(jm, pm)
    tt.assert_leaves_close(*tt.param_leaves(js, ps))
    assert int(ps.opt.step) == int(js.opt.step) == 1


def test_topology_leaves_pass_through_a_step_unchanged():
    ref_model, model, jp, p = tt.models(tt.tm.SPARSE_MLP_ID)
    (_, _), (ps, _) = tt.steps(ref_model, model, jp, p, tt.batch(model.cfg, b=4), "adamw",
                               lr=1e-2)
    for old, new in zip(checkpoint.leaves(p), checkpoint.leaves(ps.params)):
        if not old.is_floating_point():
            assert new is old
    w = ps.params["stack"]["period"][0]["ffn"]["w"]
    assert bool((w.blocks[~w.block_mask] == p["stack"]["period"][0]["ffn"]["w"].blocks[
        ~w.block_mask]).all())


@pytest.mark.parametrize("lr", [1e-3, 3e-4])
def test_adamw_learning_rate_on_the_paper_mlp_as_the_reference(lr):
    """The learning rate of ``chip_smoke.py``'s model-train. On the
    sparsified paper MLP with 512 stored weights a row (4 blocks of 128,
    as m = 8192 at 1/16 has), AdamW's near-sign step moves every weight
    by about lr: at 1e-3 the loss climbs back above its start after its
    minimum, at 3e-4 it falls every step. The reference does the same,
    step for step, so the overshoot is the optimizer's, not the port's."""
    size = dict(m=512, num_layers=8, inverse_sparsity=1, block=128)
    ref_model = RefModel(ref_graphblas_mlp.make_config(**size))
    model = Model(graphblas_mlp.make_config(**size), use_kernel=False)
    jp = ref_model.sparsify(ref_model.init(jax.random.key(0)))
    p = convert.model_params(jp, device="cpu")
    rng = np.random.default_rng(0)
    host = {"inputs": rng.random((32, 512), dtype=np.float32),
            "labels": rng.integers(0, 512, (32, 1)).astype(np.int32)}
    jopt, opt = ref_adamw(lr, weight_decay=0.0), adamw(lr, weight_decay=0.0)
    jstep = jax.jit(ref_make_train_step(ref_model, jopt))
    step = make_train_step(model, opt)
    js, ps = RefTrainState(jp, jopt.init(jp)), TrainState(p, opt.init(checkpoint.leaves(p)))
    ref_losses, losses = [], []
    for _ in range(8):
        js, jm = jstep(js, tt.as_ref(host))
        ps, pm = step(ps, tt.as_port(host))
        ref_losses.append(float(jm["loss"]))
        losses.append(float(pm["loss"]))
    print(f"adamw({lr}): port {losses}, reference {ref_losses}")
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    for run in (losses, ref_losses):
        if lr == 1e-3:
            low = int(np.argmin(run))
            assert low < len(run) - 1 and max(run[low:]) > run[0], run
        else:
            assert (np.diff(run) < 0).all(), run


def _ref_state(ref_model, jp, jopt, host):
    jstep = jax.jit(ref_make_train_step(ref_model, jopt))
    return jstep(RefTrainState(jp, jopt.init(jp)), tt.as_ref(host))[0]


@pytest.mark.parametrize("arch", ["llama3.2-1b", tt.tm.SPARSE_MLP_ID])
def test_train_state_checkpoints_cross_packages(arch):
    """A TrainState written by either package restores in the other, leaf
    for leaf: the same keys, moments keyed like the params they follow."""
    ref_model, model, jp, p = tt.models(arch)
    host = tt.batch(model.cfg, b=4)
    jopt, popt = tt.optimizers("adamw", lr=1e-2)
    jstate = _ref_state(ref_model, jp, jopt, host)
    pstate = make_train_step(model, popt)(TrainState(p, popt.init(checkpoint.leaves(p))),
                                          tt.as_port(host))[0]
    blank = TrainState(p, popt.init(checkpoint.leaves(p)))
    with tempfile.TemporaryDirectory() as d:
        jcheckpoint.save(os.path.join(d, "ref"), 1, jstate)
        checkpoint.save(os.path.join(d, "port"), 1, pstate)
        assert (sorted(jcheckpoint._flatten(jstate))
                == sorted(checkpoint._flatten(pstate)))
        got, _ = checkpoint.restore(os.path.join(d, "ref"), blank)
        want = [tt.host(x) for x in jax.tree.leaves(jstate)]
        tt.assert_leaves_close(want, [tt.host(x) for x in checkpoint.leaves(checkpoint.state_tree(got))],
                               rtol=0)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jstate)
        back, _ = jcheckpoint.restore(os.path.join(d, "port"), like)
        tt.assert_leaves_close([tt.host(x) for x in jax.tree.leaves(back)],
                               [tt.host(x) for x in checkpoint.leaves(checkpoint.state_tree(pstate))],
                               rtol=0)
