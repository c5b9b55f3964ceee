"""The model API on a ``data`` × ``model`` mesh of the CPU
(``make_local_mesh(data=D, model=M, device="cpu")``) against the
reference's one-device step: attention heads, FFN hidden columns, the
embedding's d and the head's vocab split over ``model``, each group of
M positions computing its rows with the collectives of
``distribution.tensor_parallel``. Held at f32 compute to ``LOSS_RTOL``
(loss, ce) and ``GRAD_RTOL`` of each leaf's max (gradients, SGD-updated
params, ``grad_norm``) with masked labels; the pieces (placement against
the reference's ``param_pspecs``, the collectives' model-order sums, the
d-split lookup, the vocab-split cross entropy, ``model`` = 1, checkpoints
across packages and meshes) exactly or to the stated tolerance. The
other layer kinds are ``test_torch_model_mesh_layers.py`` and the MoE
arch ``test_torch_model_mesh_moe.py`` (split so no file runs long under
``--dist loadfile``)."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.distribution import sharding as jsh
from repro.train import checkpoint as jcheckpoint
from repro.train.trainer import TrainState as RefTrainState
from repro_torch import convert
from repro_torch.distribution import peer
from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.layers import cross_entropy_loss, vocab_parallel_cross_entropy
from repro_torch.train import adamw, checkpoint, make_train_step
from repro_torch.train.optimizer import update_placed
from repro_torch.train.trainer import TrainState, loss_and_grads, state_shardings

import _torch_mesh as dm
import _torch_model_mesh as mm
import _torch_train as tt

LLAMA = "llama3.2-1b"


@pytest.mark.parametrize("data,model,microbatches", [
    (1, 2, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2),
])
def test_llama_on_a_model_mesh_matches_the_reference_one_device_step(data, model, microbatches):
    mm.check_against_the_reference(LLAMA, data, model, microbatches)


def test_chunks_are_the_reference_pspecs_slices_and_hold_their_bytes():
    """On a (2, 2) mesh every position's chunk of every leaf is the slice
    the reference's ``param_pspecs`` gives it (``data`` chunk c, ``model``
    chunk m), each position stores its chunks and nothing more, and no
    leaf the spec splits over ``model`` is held whole anywhere."""
    _, model, jp, p = mm.models(LLAMA, "kv-split")
    mesh = mm.grid(2, 2)
    placed = sh.place(p, sh.shardings_for(None, mesh, sh.param_pspecs(None, p, mesh)))
    specs = jax.tree.leaves(jsh.param_pspecs(None, jp, mesh, jsh.ShardingRules()),
                            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    leaves, want = checkpoint.leaves(placed), checkpoint.leaves(p)
    assert len(specs) == len(leaves)
    split = 0
    for leaf, whole, spec in zip(leaves, want, specs):
        for pos, got in enumerate(leaf.chunks):
            c, m = divmod(pos, 2)
            part = whole
            for dim, axis in enumerate(tuple(spec)):
                if axis is not None:
                    size = whole.shape[dim] // 2
                    part = part.narrow(dim, (c if axis == "data" else m) * size, size)
            assert torch.equal(got, part)
            assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
        if "model" in tuple(spec):
            split += 1
            assert all(c.numel() * mm.split_fraction(leaf) == whole.numel() for c in leaf.chunks)
    assert split >= 8  # embed, w_q, w_k, w_v, w_o, w_in, w_gate, w_out
    per_position = [sum(x.chunks[pos].numel() for x in leaves) for pos in range(4)]
    assert per_position == [sum(x.numel() // mm.split_fraction(x) for x in leaves)] * 4


def test_fan_out_and_fan_in_backwards_are_model_order_sums():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    gs = [g, torch.full_like(g, 1e8), torch.full_like(g, -1e8)]  # (g + 1e8) - 1e8 != g
    outs = tp.fan_out(x, ["cpu"] * 3)
    assert all(torch.equal(o, x) for o in outs)
    torch.autograd.backward(outs, gs)
    assert torch.equal(x.grad, (gs[0] + gs[1]) + gs[2])
    assert not torch.equal(x.grad, gs[0] + (gs[1] + gs[2]))  # the order shows
    parts = [g.clone().requires_grad_() for g in gs]
    total = tp.fan_in(parts, "cpu")
    assert torch.equal(total, (gs[0] + gs[1]) + gs[2])
    total.backward(x.detach())
    assert all(torch.equal(q.grad, x.detach()) for q in parts)
    # the exact ones: a gather and a scatter, a reshard and back, and their gradients
    chunks = [torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
              .requires_grad_() for _ in range(2)]
    cat = tp.all_gather(chunks, 1, "cpu")
    assert torch.equal(cat, torch.cat(chunks, 1))
    back = tp.scatter(cat, 1, ["cpu", "cpu"])
    assert all(torch.equal(a, b) for a, b in zip(back, chunks))
    rows = tp.reshard(chunks, 1, 0)
    assert all(torch.equal(r, cat[3 * m:3 * m + 3]) for m, r in enumerate(rows))
    torch.autograd.backward(rows, [r.detach() * 2 for r in rows])
    assert all(torch.equal(c.grad, c.detach() * 2) for c in chunks)


def test_the_d_split_lookup_is_table_ids_bit_for_bit():
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 64, (4, 9)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    whole = table.clone().requires_grad_()
    whole[ids.long()].backward(g)
    for m in (2, 4):
        chunks = [c.clone().requires_grad_() for c in table.chunk(m, 1)]
        rows = tp.embed_lookup(tp.Split(tuple(chunks), 1), ids)
        assert torch.equal(rows, table[ids.long()])
        rows.backward(g)
        assert torch.equal(torch.cat([c.grad for c in chunks], 1), whole.grad)


@pytest.mark.parametrize("m", [2, 4])
def test_the_vocab_split_cross_entropy_is_the_whole_ones(m):
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((3, 10, 64)).astype(np.float32) * 4)
    labels = torch.from_numpy(rng.integers(0, 64, (3, 10)).astype(np.int32))
    labels[1, :4] = -1
    want = logits.clone().requires_grad_()
    loss = cross_entropy_loss(want, labels, z_loss=1e-4)
    loss.backward()
    chunks = [c.clone().requires_grad_() for c in logits.chunk(m, -1)]
    got = vocab_parallel_cross_entropy(chunks, labels, z_loss=1e-4)
    want_loss = float(loss.detach())
    assert abs(float(got.detach()) - want_loss) <= tt.LOSS_RTOL * abs(want_loss)
    got.backward()
    grad = torch.cat([c.grad for c in chunks], -1)
    assert float((grad - want.grad).abs().max()) <= tt.GRAD_RTOL * float(want.grad.abs().max())


def test_model_1_is_the_data_mesh_step_bit_for_bit():
    """``model`` = 1 runs no collective of the model axis: the step is the
    data mesh's, each position's ``loss_and_grads`` on whole leaves, the
    gradients added onto the owners in card order (``peer.reduce_scatter``)
    and one AdamW update of the chunks, bit for bit."""
    _, model, _, p = tt.models(LLAMA)
    opt = adamw(1e-2)
    mesh = mm.grid(2, 1)
    state = mm.placed_state(model, p, mesh, opt)
    host = tt.as_port(dm.masked_batch(model.cfg, LLAMA))
    tp.reset_exchange_counts()
    got, gm = make_train_step(model, opt)(state, host)
    assert tp.exchange_counts() == {}
    owners = checkpoint.leaves(state.params)
    whole = checkpoint.with_leaves(state.params, [x.gather("cpu") for x in owners])
    labels = host["labels"].reshape(2, -1)
    share = (labels >= 0).sum(1).float() / (labels >= 0).sum().float()
    terms, losses = [], []
    for c in range(2):
        rows = {k: v[4 * c:4 * c + 4] for k, v in host.items()}
        loss, _, g = loss_and_grads(model, whole, rows, shares=(share[c], 0.5))
        terms.append(g)
        losses.append(loss)
    grads = [None if t[0] is None else sh.Placed(tuple(peer.reduce_scatter(t, x.sharding)),
                                                 x.sharding)
             for t, x in zip(zip(*terms), owners)]
    leaves, new_opt, norm = update_placed(opt, grads, state.opt, owners)
    assert float(gm["loss"]) == float(losses[0] + losses[1])
    assert float(gm["grad_norm"]) == float(norm)
    for a, b in zip(checkpoint.leaves(got.params) + got.opt.mu + got.opt.nu,
                    leaves + new_opt.mu + new_opt.nu):
        assert all(torch.equal(x, y) for x, y in zip(a.chunks, b.chunks))


def test_a_model_mesh_checkpoint_restores_onto_one_position_and_the_reference():
    """A 2 × 2 state after a step: saved, restored onto one position, onto
    4 data positions and onto the reference, bit for bit; the reference's
    save restored onto the 2 × 2 placement, and the reference's state
    converted onto it (``convert.train_state``), hold the same chunks."""
    _, model, jp, p = mm.models(LLAMA, "kv-split")
    jopt, opt = tt.optimizers("adamw", lr=1e-2)
    mesh = mm.grid(2, 2)
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    shardings = state_shardings(model.cfg, state, mesh)
    placed, _ = make_train_step(model, opt)(sh.place(state, shardings),
                                            tt.as_port(mm.masked_batch(model.cfg)))
    flat = [x.gather("cpu") if isinstance(x, sh.Placed) else x
            for x in checkpoint.leaves(checkpoint.state_tree(placed))]
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(os.path.join(d, "grid"), 1, placed)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            RefTrainState(jp, jopt.init(jp)))
        ref_state, _ = jcheckpoint.restore(os.path.join(d, "grid"), like)
        jcheckpoint.save(os.path.join(d, "ref"), 1, ref_state)
        back, _ = checkpoint.restore(os.path.join(d, "ref"), placed)
        one, _ = checkpoint.restore(os.path.join(d, "grid"), state,
                                    shardings=state_shardings(model.cfg, state, mm.grid(1, 1)))
        four, _ = checkpoint.restore(os.path.join(d, "grid"), state,
                                     shardings=state_shardings(model.cfg, state, mm.grid(4, 1)))
    converted = convert.train_state(ref_state, mesh=mesh)
    for got in (back, converted):
        for a, b in zip(checkpoint.leaves(checkpoint.state_tree(got)),
                        checkpoint.leaves(checkpoint.state_tree(placed))):
            if isinstance(b, sh.Placed):
                assert isinstance(a, sh.Placed) and a.sharding == b.sharding
                assert all(torch.equal(x, y) for x, y in zip(a.chunks, b.chunks))
            else:
                assert torch.equal(a, b)
    for got in (one, four):
        for a, b in zip(checkpoint.leaves(checkpoint.state_tree(got)), flat):
            assert torch.equal(a.gather("cpu") if isinstance(a, sh.Placed) else a, b)
    tt.assert_leaves_close([tt.host(x) for x in jax.tree.leaves(ref_state)],
                           [tt.host(x) for x in flat], rtol=0)


def test_forward_on_a_groups_split_params_gathers_the_logits_and_serving_is_refused():
    """``Model.forward`` on one group's params (leaves split over ``model``
    as ``Split``s) gives the whole model's logits, the vocab chunks
    gathered in model order; prefill with split weights, once refused,
    now serves: its last logits are the one-device prefill's, gathered
    the same way (placed caches: ``test_torch_model_mesh_serve.py``)."""
    _, model, _, p = mm.models(LLAMA, "kv-split")
    mesh = mm.grid(1, 2)
    placed = sh.place(p, sh.shardings_for(None, mesh, sh.param_pspecs(None, p, mesh)))
    (group,) = sh.group_params(placed, checkpoint.leaves(placed), mesh)
    assert isinstance(group["embed"], tp.Split)
    ids = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32))
    want, got = model.forward(p, ids), model.forward(group, ids)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tt.GRAD_RTOL * float(want.abs().max())
    want, _ = model.prefill(p, ids, model.init_cache(2, 16, device="cpu"))
    got, _ = model.prefill(group, ids, model.init_cache(2, 16, device="cpu"))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tt.GRAD_RTOL * float(want.abs().max())
