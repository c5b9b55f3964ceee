"""The model API on a data mesh of 4 positions on the CPU
(``make_local_mesh(data=4, device="cpu")``) against the reference's
one-device step: the train state placed as ``param_pspecs`` says, each
position computing its rows, gradients added onto the owners in card
order. Held at f32 compute to ``LOSS_RTOL`` (loss, ce) and ``GRAD_RTOL``
of each leaf's max (gradients, SGD-updated params, ``grad_norm``) for a
dense arch and the sparse paper MLP (a MoE arch in
``test_torch_data_mesh_moe.py``), with masked labels spread unevenly
over the positions; the pieces (placement, gather and
card-order sums, the collectives over positions, checkpoints across
packages and meshes) exactly."""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jcheckpoint
from repro.train.trainer import TrainState as RefTrainState
from repro_torch.distribution import collectives as col
from repro_torch.distribution import peer
from repro_torch.distribution import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import adamw, checkpoint, make_train_step, sgd
from repro_torch.train.trainer import TrainState, init_train_state, state_shardings

import _torch_mesh as tm
import _torch_train as tt
from _torch_mesh import N, four_positions, masked_batch

@pytest.mark.parametrize("arch,microbatches", [
    ("llama3.2-1b", 1), ("llama3.2-1b", 2), (tm.SPARSE_MLP_ID, 1), (tm.SPARSE_MLP_ID, 2),
])
def test_a_4_position_step_matches_the_reference_one_device_step(arch, microbatches):
    tm.check_against_the_reference(arch, microbatches)


def test_masked_labels_give_the_global_mean_not_a_mean_of_means():
    """Positions that mask different counts of labels: the loss is the
    reference's one mean over the unmasked labels (each position's ce
    weighted by its share n_c / n), which a plain mean of the positions'
    means misses; a microbatch with every label masked gives ce 0."""
    arch = "llama3.2-1b"
    ref_model, model, jp, p = tt.models(arch)
    host = masked_batch(model.cfg, arch)
    want = float(ref_model.loss(jp, tt.as_ref(host))[0])
    state = TrainState(p, sgd(1e-2).init(checkpoint.leaves(p)))
    placed = sh.place(state, state_shardings(None, state, four_positions()))
    _, pm = make_train_step(model, sgd(1e-2))(placed, tt.as_port(host))
    assert abs(float(pm["loss"]) - want) <= tt.LOSS_RTOL * abs(want)
    per_position = [float(model.loss(p, {k: v[2 * c:2 * c + 2]
                                         for k, v in tt.as_port(host).items()})[0])
                    for c in range(N)]
    assert abs(np.mean(per_position) - want) > 100 * tt.LOSS_RTOL * abs(want)
    host["labels"][:] = -1
    _, pm = make_train_step(model, sgd(1e-2))(placed, tt.as_port(host))
    assert float(pm["ce"]) == 0.0 == float(ref_model.loss(jp, tt.as_ref(host))[1]["ce"])


def test_leaves_every_position_holds_stay_the_same_bits_over_steps():
    arch = tm.SPARSE_MLP_ID
    _, model, _, p = tt.models(arch)
    opt = adamw(1e-2)
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    placed = sh.place(state, state_shardings(None, state, four_positions()))
    step = make_train_step(model, opt, microbatches=2)
    for seed in range(3):
        placed, _ = step(placed, tt.as_port(tt.batch(model.cfg, seed=seed, b=8)))
        whole = [x for x in checkpoint.leaves(checkpoint.state_tree(placed))
                 if isinstance(x, sh.Placed) and x.sharding.dim is None]
        assert len(whole) > 10  # norms, biases, every sparse FFN tensor and their moments
        for leaf in whole:
            assert all(torch.equal(c, leaf.chunks[0]) for c in leaf.chunks[1:])


@pytest.mark.parametrize("arch", ["llama3.2-1b", tm.SPARSE_MLP_ID])
def test_chunks_are_placed_as_param_pspecs_says(arch):
    _, model, _, p = tt.models(arch)
    mesh, opt = four_positions(), adamw(1e-3)
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    state = sh.place(state, state_shardings(None, state, mesh))
    specs = checkpoint.leaves(sh.param_pspecs(None, p, mesh))
    n_split = 0
    for leaf, spec, want in zip(checkpoint.leaves(state.params), specs, checkpoint.leaves(p)):
        assert leaf.sharding.spec == spec and tuple(leaf.shape) == tuple(want.shape)
        dims = [d for d, e in enumerate(spec) if e == "data"]
        assert leaf.sharding.dim == (dims[0] if dims else None)
        for c, chunk in enumerate(leaf.chunks):
            if dims:
                size = want.shape[dims[0]] // N
                assert torch.equal(chunk, want.narrow(dims[0], c * size, size))
            else:
                assert torch.equal(chunk, want)
            assert chunk.is_contiguous()
        assert len({c.data_ptr() for c in leaf.chunks}) == N  # one tensor a position
        n_split += bool(dims)
    # the sparse MLP's only leaves are its sparse weight's tensors (whole on
    # every position, as in the reference) and a bias too short to split
    assert n_split > 0 if arch == "llama3.2-1b" else n_split == 0
    # each position stores its chunks of the params and both moments
    every = [x for x in checkpoint.leaves(checkpoint.state_tree(state)) if isinstance(x, sh.Placed)]
    per_position = [sum(x.chunks[c].numel() * x.element_size() for x in every) for c in range(N)]
    whole = sum(x.numel() * x.element_size() for x in every if x.sharding.dim is not None)
    held = sum(x.numel() * x.element_size() for x in every if x.sharding.dim is None)
    assert per_position == [whole // N + held] * N


def test_init_train_state_on_a_mesh_places_the_drawn_params():
    _, cfg = tt.tm.configs("llama3.2-1b", "float32")
    from repro_torch.models import Model

    model, mesh, opt = Model(cfg), four_positions(), adamw(1e-3)
    drawn = model.init(torch.Generator().manual_seed(0), device="cpu")
    state = init_train_state(model, opt, torch.Generator().manual_seed(0), mesh=mesh)
    for leaf, want in zip(checkpoint.leaves(state.params), checkpoint.leaves(drawn)):
        assert torch.equal(leaf.gather("cpu"), want)
    for m in state.opt.mu + state.opt.nu:
        assert isinstance(m, sh.Placed) and all(not c.any() for c in m.chunks)
    assert int(state.opt.step) == 0 and state.opt.step.device.type == "cpu"


def test_all_gather_and_reduce_scatter_are_concatenation_and_the_card_order_sum():
    rng = np.random.default_rng(3)
    mesh = four_positions()
    terms = [torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)) for _ in range(N)]
    for spec, dim in ((sh.PartitionSpec("data"), 0), (sh.PartitionSpec(None, "data"), 1),
                      (sh.PartitionSpec(), None)):
        sharding = sh.Sharding(mesh, spec)
        assert sharding.dim == dim
        got = peer.reduce_scatter(terms, sharding)
        total = ((terms[0] + terms[1]) + terms[2]) + terms[3]
        for c in range(N):
            assert torch.equal(got[c], sharding.part(total, c))
        if dim is not None:
            assert torch.equal(peer.all_gather(got, dim, "cpu"), total)
        placed = sh.place_leaf(terms[0], sharding)
        assert torch.equal(placed.gather("cpu"), terms[0])
    acc = None  # the step's form: one position's whole term at a time
    owners = [sh.place_leaf(terms[0], sh.Sharding(mesh, sh.PartitionSpec("data")))]
    for t in terms:
        acc = sh.constrain_like_params([t], owners=owners, into=acc)
    assert all(torch.equal(a, b) for a, b in zip(acc[0], peer.reduce_scatter(
        terms, owners[0].sharding)))
    grads = [torch.ones(3), None]
    assert sh.constrain_like_params(grads) is grads


def test_compressed_psum_mean_over_positions_is_the_leading_dim_form_bit_for_bit():
    rng = np.random.default_rng(4)
    mesh = four_positions()
    x = torch.from_numpy(rng.standard_normal((N, 33, 7)).astype(np.float32) * 3e-2)
    err, perr = torch.zeros_like(x), [torch.zeros_like(v) for v in x]
    for _ in range(3):  # the error carried step to step
        m, err = col.compressed_psum_mean(x, err)
        pm, perr = col.compressed_psum_mean(list(x), perr, mesh=mesh)
        assert all(torch.equal(a, b) for a, b in zip(m, pm))
        assert all(torch.equal(a, b) for a, b in zip(err, perr))
    tree = {"w": x, "b": [torch.from_numpy(rng.standard_normal((N, 5)).astype(np.float32))]}
    per = [{"w": tree["w"][c], "b": [tree["b"][0][c]]} for c in range(N)]
    m, e = col.compressed_psum_mean_tree(tree, col.init_error_state(tree))
    pm, pe = col.compressed_psum_mean_tree(per, [col.init_error_state(t) for t in per], mesh=mesh)
    for c in range(N):
        for a, b in zip(checkpoint.leaves(pm[c]) + checkpoint.leaves(pe[c]),
                        checkpoint.leaves(m) + checkpoint.leaves(e)):
            assert torch.equal(a, b[c])
    with pytest.raises(ValueError, match="one tensor a position"):
        col.compressed_psum_mean(list(x)[:3], perr[:3], mesh=mesh)


def test_bucketed_over_a_placed_tree_is_the_unplaced_trees():
    _, model, _, p = tt.models("llama3.2-1b")
    mesh = four_positions()
    placed = sh.place(p, sh.shardings_for(None, mesh, sh.param_pspecs(None, p, mesh)))
    for bucket_bytes in (1, 4096, 32 * 1024 * 1024):
        assert ([[(path, leaf.numel() * leaf.element_size()) for path, leaf in b]
                 for b in col.bucketed(placed, bucket_bytes)]
                == [[(path, leaf.numel() * leaf.element_size()) for path, leaf in b]
                    for b in col.bucketed(p, bucket_bytes)])


def test_checkpoints_cross_packages_and_meshes_exactly():
    """4 positions → the reference on one device → 4 positions, and a
    4-position checkpoint restored on one device and the reverse, bit for
    bit."""
    _, model, jp, p = tt.models(tm.SPARSE_MLP_ID)
    jopt, opt = tt.optimizers("adamw", lr=1e-2)
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    mesh = four_positions()
    shardings = state_shardings(None, state, mesh)
    placed, _ = make_train_step(model, opt)(sh.place(state, shardings),
                                            tt.as_port(tt.batch(model.cfg, b=8)))
    flat = [x.gather("cpu") if isinstance(x, sh.Placed) else x
            for x in checkpoint.leaves(checkpoint.state_tree(placed))]
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(os.path.join(d, "port4"), 1, placed)
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                            RefTrainState(jp, jopt.init(jp)))
        ref_state, _ = jcheckpoint.restore(os.path.join(d, "port4"), like)
        jcheckpoint.save(os.path.join(d, "ref"), 1, ref_state)
        back, manifest = checkpoint.restore(os.path.join(d, "ref"), placed)  # onto 4 positions
        assert manifest["step"] == 1
        one, _ = checkpoint.restore(os.path.join(d, "port4"), state)  # onto one device
        checkpoint.save(os.path.join(d, "port1"), 1, one)
        again, _ = checkpoint.restore(os.path.join(d, "port1"), state, shardings=shardings)
    for got in (back, again):
        for a, b in zip(checkpoint.leaves(checkpoint.state_tree(got)),
                        checkpoint.leaves(checkpoint.state_tree(placed))):
            if isinstance(b, sh.Placed):
                assert isinstance(a, sh.Placed) and a.sharding == b.sharding
                assert all(torch.equal(x, y) for x, y in zip(a.chunks, b.chunks))
            else:
                assert torch.equal(a, b)
    for a, b in zip(checkpoint.leaves(checkpoint.state_tree(one)), flat):
        assert torch.equal(a, b)
    want = [tt.host(x) for x in jax.tree.leaves(ref_state)]
    tt.assert_leaves_close(want, [tt.host(x) for x in flat], rtol=0)


def test_one_position_is_the_unplaced_step_bit_for_bit():
    _, model, _, p = tt.models("llama3.2-1b")
    opt = adamw(1e-2)
    state = TrainState(p, opt.init(checkpoint.leaves(p)))
    mesh = make_local_mesh(data=1, device="cpu")
    host = tt.as_port(masked_batch(model.cfg, "llama3.2-1b"))
    for k in (1, 2):
        step = make_train_step(model, opt, microbatches=k)
        s0, m0 = step(state, host)
        s1, m1 = step(sh.place(state, state_shardings(None, state, mesh)), host)
        assert {q: float(v) for q, v in m0.items()} == {q: float(v) for q, v in m1.items()}
        for a, b in zip(checkpoint.leaves(checkpoint.state_tree(s0)),
                        checkpoint.leaves(checkpoint.state_tree(s1))):
            assert torch.equal(a, b.chunks[0] if isinstance(b, sh.Placed) else b)


def test_the_local_mesh_and_its_refusals():
    mesh = four_positions()
    assert mesh.shape == {"data": 4, "model": 1} and mesh.cards == (torch.device("cpu"),)
    assert make_local_mesh(device="cpu").shape == {"data": 1, "model": 1}
    grid = make_local_mesh(data=2, model=2, device="cpu")
    assert grid.shape == {"data": 2, "model": 2} and grid.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="data=2 but 2 devices for model=2"):
        make_local_mesh(2, model=2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="data=3 but 2 devices"):
        make_local_mesh(3, devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="this host has|CUDA"):
        make_local_mesh(devices=[f"cuda:{i}" for i in range(torch.cuda.device_count() + 1)])
    spec = sh.param_pspecs(None, {"embed": torch.zeros(512, 64)}, mesh)["embed"]
    assert tuple(spec) == ("data", "model") and sh.Sharding(mesh, spec).dim == 0
