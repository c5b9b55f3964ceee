"""The port's training slice against the reference: optimizers, the sparse
train step, and pruning, on inputs converted through numpy.

* ``train/optimizer.py``: AdamW (clipping, decay, ``state_dtype``) and
  SGD over three steps, parameters and moments within ``rtol=1e-5,
  atol=1e-6`` (f32, the step constants round on another path), integer
  topology left untouched; ``global_norm`` and ``warmup_cosine`` within
  1e-6.
* ``train/sparse.py``: three steps of ``make_sparse_train_step`` with
  SGD and with AdamW on a mixed ELL / block-CSR / dense stack against the
  reference's, parameters within ``rtol=1e-4, atol=1e-5`` (f32 through
  three layers and an update); the loss falls, the topology is frozen,
  gradients stay in the stored pattern, and a differentiable plan sorts
  nothing after its build. The paper's MLP retrains (the reference's
  ``test_sparse_mlp_trainable``, here at the stack level).
* ``core/pruning.py``: every function against the reference, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpruning
from repro.sparse.bcsr import BlockCSRMatrix as JBCSR
from repro.sparse.bsr import BlockSparseMatrix as JBSR
from repro.train import optimizer as jopt
from repro.train import sparse as jsparse
from repro_torch import convert
from repro_torch.core import dnn, pruning
from repro_torch.plan import build_plan
from repro_torch.sparse import BlockCSRMatrix, BlockSparseMatrix
from repro_torch.sparse.bcsr import reset_transpose_sort_count, transpose_sort_count
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as popt
from repro_torch.train import sparse as psparse

OPT_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _leaves_close(got, want, tol):
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(g.numpy(), w, **tol)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def _opt_inputs():
    rng = np.random.default_rng(0)
    params = [rng.standard_normal((4, 3)).astype(np.float32),
              np.arange(6, dtype=np.int32).reshape(2, 3),  # topology: frozen
              rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal((4, 3)).astype(np.float32) * s,
              np.zeros((2, 3), np.int32),
              rng.standard_normal(5).astype(np.float32) * s] for s in (0.1, 3.0, 0.5)]
    return params, grads


@pytest.mark.parametrize("name", ["adamw", "adamw_bf16_state", "adamw_schedule", "sgd"])
def test_optimizers_match_reference(name):
    make = {  # m: the reference's optimizer module or the port's
        "adamw": lambda m: m.adamw(1e-2),
        "adamw_bf16_state": lambda m: m.adamw(1e-2, state_dtype=(
            jnp.bfloat16 if m is jopt else torch.bfloat16)),
        "adamw_schedule": lambda m: m.adamw(m.warmup_cosine(0.05, 2, 3), weight_decay=0.0,
                                            grad_clip_norm=0.0),
        "sgd": lambda m: m.sgd(0.1, momentum=0.9),
    }[name]
    params, grads = _opt_inputs()
    jo, po = make(jopt), make(popt)
    jp, pp = [jnp.asarray(p) for p in params], [t(p) for p in params]
    js, ps = jo.init(jp), po.init(pp)
    for g in grads:
        jp, js = jo.update([jnp.asarray(x) for x in g], js, jp)
        pp, ps = po.update([t(x) for x in g], ps, pp)
        _leaves_close(pp, jp, OPT_TOL)
        _leaves_close([m.float() for m in ps.mu], [m.astype(jnp.float32) for m in js.mu],
                      OPT_TOL)
        assert int(ps.step) == int(js.step)
    assert pp[1].dtype == torch.int32 and torch.equal(pp[1], t(params[1]))


def test_global_norm_and_schedule_match_reference():
    _, grads = _opt_inputs()
    for g in grads:
        np.testing.assert_allclose(float(popt.global_norm([t(x) for x in g])),
                                   float(jopt.global_norm([jnp.asarray(x) for x in g])),
                                   rtol=1e-6)
    jsched, psched = jopt.warmup_cosine(0.1, 10, 100), popt.warmup_cosine(0.1, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(float(psched(torch.tensor(step))),
                                   float(jsched(jnp.asarray(step))), rtol=1e-6, atol=1e-9)


def _mixed_stack(m=32, bs=8):
    """ELL with pad slots, block-CSR with tail slots and an empty block-row,
    and a dense layer; reference and port, biases and a batch."""
    rng = np.random.default_rng(5)
    keep = rng.random((m // bs, m // bs)) < 0.5
    keep[:, 0] = True
    d0 = rng.uniform(-0.5, 0.5, (m, m)).astype(np.float32) * np.kron(keep, np.ones((bs, bs)))
    keep1 = keep.copy()
    keep1[1] = False
    d1 = rng.uniform(-0.5, 0.5, (m, m)).astype(np.float32) * np.kron(keep1, np.ones((bs, bs)))
    jws = [JBSR.from_dense(d0.astype(np.float32), (bs, bs), pad_to=m // bs),
           JBCSR.from_bsr(JBSR.from_dense(d1.astype(np.float32), (bs, bs)),
                          pad_to=int(keep1.sum()) + 3),
           jnp.asarray(rng.standard_normal((m, m)).astype(np.float32) * 0.2)]
    biases = [rng.standard_normal(m).astype(np.float32) * 0.1 for _ in jws]
    y0 = rng.random((m, 16), dtype=np.float32)
    targets = rng.random((m, 16), dtype=np.float32)
    return jws, [convert.weight(w) for w in jws], biases, y0, targets


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_sparse_train_step_matches_reference(opt):
    jws, pws, biases, y0, targets = _mixed_stack()
    jo = jopt.sgd(0.5, momentum=0.9) if opt == "sgd" else jopt.adamw(1e-2)
    po = popt.sgd(0.5, momentum=0.9) if opt == "sgd" else popt.adamw(1e-2)
    jstate = jsparse.init_sparse_mlp_state(jws, [jnp.asarray(b) for b in biases], jo)
    pstate = psparse.init_sparse_mlp_state(pws, [t(b) for b in biases], po)
    jstep = jax.jit(jsparse.make_sparse_train_step(jo, use_kernel=False))
    pstep = psparse.make_sparse_train_step(po)
    jbatch = {"y0": jnp.asarray(y0), "targets": jnp.asarray(targets)}
    pbatch = {"y0": t(y0), "targets": t(targets)}
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        pstate, pm = pstep(pstate, pbatch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        _leaves_close(checkpoint.leaves(pstate.params),
                      (jstate.weights, jstate.biases), TRAIN_TOL)
        losses.append(float(pm["loss"]))
    assert losses[-1] < losses[0], losses
    # the topology is frozen: the very same tensors, pad and tail slots still 0
    for w, w0 in zip(pstate.weights, pws):
        assert type(w) is type(w0)
        if isinstance(w, BlockSparseMatrix):
            assert w.col_idx is w0.col_idx and float(w.blocks[~w.block_mask].abs().max()) == 0
        elif isinstance(w, BlockCSRMatrix):
            assert w.row_ptr is w0.row_ptr and float(w.values[~w.valid].abs().max()) == 0


def test_sparse_train_step_decreases_loss_and_keeps_the_pattern():
    """The reference's ``test_sparse_train_step_decreases_loss``: an ELL and
    a block-CSR layer, SGD at lr 1, four steps, kernels in both passes."""
    _, pws, _, y0, targets = _mixed_stack()
    ws = pws[:2]
    bs = [torch.zeros(32) for _ in ws]
    opt = popt.sgd(1.0, momentum=0.0)
    state = psparse.init_sparse_mlp_state(ws, bs, opt)
    reset_transpose_sort_count()
    plan = build_plan(ws, bs, 16, differentiable=True)
    assert transpose_sort_count() == 2  # each sparse layer, sorted once
    step = psparse.make_sparse_train_step(opt, plan=plan)
    batch = {"y0": t(y0), "targets": t(targets)}
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert transpose_sort_count() == 2  # no backward sorted again
    assert losses[-1] < losses[0], losses
    assert torch.equal(state.weights[0].col_idx, ws[0].col_idx)
    assert torch.equal(state.weights[1].row_id, ws[1].row_id)
    _, (dws, _) = dnn.dnn_value_and_grad(state.weights, state.biases, t(y0), t(targets))
    assert psparse.grad_sparsity_preserved(state.weights, dws)
    bad = BlockSparseMatrix(torch.ones_like(ws[0].blocks), ws[0].col_idx, ws[0].block_mask,
                            ws[0].shape, ws[0].block_shape)
    assert not psparse.grad_sparsity_preserved([ws[0]], [bad])


def test_paper_mlp_retrains():
    """The reference's ``test_sparse_mlp_trainable`` at the stack level: the
    paper's MLP (graphblas_mlp m=64, 2 layers, inverse sparsity 2, block
    16) block-pruned from dense weights, 20 AdamW steps, the loss falls as
    the reference's does."""
    rng = np.random.default_rng(1)
    dense = [rng.standard_normal((64, 64)).astype(np.float32) * 0.2 for _ in range(2)]
    jws = [jpruning.block_prune(jnp.asarray(d), (16, 16), 2) for d in dense]
    pws = [pruning.block_prune(t(d), (16, 16), 2) for d in dense]
    biases = [np.zeros(64, np.float32) for _ in dense]
    y0 = rng.random((64, 8), dtype=np.float32)
    targets = rng.random((64, 8), dtype=np.float32)
    jo, po = jopt.adamw(1e-2, weight_decay=0.0), popt.adamw(1e-2, weight_decay=0.0)
    jstate = jsparse.init_sparse_mlp_state(jws, [jnp.asarray(b) for b in biases], jo)
    pstate = psparse.init_sparse_mlp_state(pws, [t(b) for b in biases], po)
    jstep = jax.jit(jsparse.make_sparse_train_step(jo, use_kernel=False))
    pstep = psparse.make_sparse_train_step(po)
    jlosses, plosses = [], []
    for _ in range(20):
        jstate, jm = jstep(jstate, {"y0": jnp.asarray(y0), "targets": jnp.asarray(targets)})
        pstate, pm = pstep(pstate, {"y0": t(y0), "targets": t(targets)})
        jlosses.append(float(jm["loss"]))
        plosses.append(float(pm["loss"]))
    assert plosses[-1] < 0.5 * plosses[0], plosses
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)


# --- pruning: exact parity --------------------------------------------------


def _w(seed, shape=(64, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("density", [0.05, 0.25, 0.3, 0.5, 1.0])
def test_magnitude_prune_and_mask_match_reference(density):
    w = _w(0)
    np.testing.assert_array_equal(pruning.magnitude_prune(t(w), density).numpy(),
                                  np.asarray(jpruning.magnitude_prune(jnp.asarray(w), density)))
    np.testing.assert_array_equal(pruning.prune_mask(t(w), density).numpy(),
                                  np.asarray(jpruning.prune_mask(jnp.asarray(w), density)))


def test_magnitude_prune_keeps_largest_and_validates():
    w = t([[1.0, -5.0], [0.1, 3.0]])
    np.testing.assert_array_equal(pruning.magnitude_prune(w, 0.5).numpy(),
                                  [[0.0, -5.0], [0.0, 3.0]])
    once = pruning.magnitude_prune(t(_w(1, (32, 32))), 0.3)
    torch.testing.assert_close(pruning.magnitude_prune(once, 0.3), once, rtol=0, atol=0)
    with pytest.raises(ValueError):
        pruning.magnitude_prune(torch.ones(2, 2), 0.0)


@pytest.mark.parametrize("norm", ["l1", "l2", "linf"])
@pytest.mark.parametrize("values", ["normal", "integer_ties"])
def test_block_prune_matches_reference(norm, values):
    """Scores within f32 rounding, masks and pruned matrices exact — also
    on integer inputs whose scores tie (both rank by a stable sort)."""
    w = _w(2) if values == "normal" else np.random.default_rng(3).integers(
        -1, 2, (64, 64)).astype(np.float32)
    np.testing.assert_allclose(pruning.block_scores(t(w), (8, 8), norm=norm).numpy(),
                               np.asarray(jpruning.block_scores(jnp.asarray(w), (8, 8), norm=norm)),
                               rtol=1e-6)
    for bpr in (1, 3, 8):
        got = pruning.block_prune_mask(t(w), (8, 8), bpr, norm=norm)
        want = np.asarray(jpruning.block_prune_mask(jnp.asarray(w), (8, 8), bpr, norm=norm))
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.sum(dim=1) == bpr).all()
        pb = pruning.block_prune(t(w), (8, 8), bpr, norm=norm)
        jb = jpruning.block_prune(jnp.asarray(w), (8, 8), bpr, norm=norm)
        assert isinstance(pb, BlockSparseMatrix) and pb.max_blocks_per_row == bpr
        for name in ("blocks", "col_idx", "block_mask"):
            np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)))
    with pytest.raises(ValueError):
        pruning.block_prune_mask(t(w), (8, 8), 9)
    with pytest.raises(ValueError, match="norm"):
        pruning.block_scores(t(w), (8, 8), norm="l3")


def test_apply_block_mask_and_schedule_match_reference():
    w = _w(4, (16, 16))
    mask = np.zeros((2, 2), bool)
    mask[0, 0] = mask[1, 1] = True
    np.testing.assert_array_equal(
        pruning.apply_block_mask(t(w), t(mask), (8, 8)).numpy(),
        np.asarray(jpruning.apply_block_mask(jnp.asarray(w), jnp.asarray(mask), (8, 8))))
    sched = pruning.PruneSchedule(steps=[10, 20], densities=[0.5, 0.25])
    jsched = jpruning.PruneSchedule(steps=[10, 20], densities=[0.5, 0.25])
    for step in (0, 9, 10, 15, 20, 25):
        assert sched.density_at(step) == jsched.density_at(step)
        assert sched.is_prune_step(step) == jsched.is_prune_step(step)
    with pytest.raises(ValueError):
        pruning.PruneSchedule(steps=[1, 2], densities=[0.2, 0.5])
    with pytest.raises(ValueError):
        pruning.PruneSchedule(steps=[1], densities=[0.2, 0.1])
