"""Sequence parallelism over ``model`` (the reference's
``ShardingRules(seq_axis="model")``): the scaled-down Llama on
``data`` × ``model`` meshes of the CPU with the rules active
(``sharding.activate``). Between the tensor-parallel regions each model
position holds its chunk of the sequence (a ``tensor_parallel.Split``
along dim 1); a region takes it in by ``seq_gather`` and hands its
partials back by ``seq_reduce``. Held: one SGD step against the
reference's one-device step (``LOSS_RTOL``, ``GRAD_RTOL``, as
``test_torch_model_mesh.py``); the loss equal to the unsplit 2 × 2 step's
bits and every gradient within 1e-6 of its leaf's max (only the norms'
scales, whose partials are added across the chunks, move); the new
collectives' backwards as model-order sums; a one-layer toy's exchanges by
hand; a sequence that does not divide over ``model`` running unsplit,
bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.distribution import sharding as sh
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.train import checkpoint, make_train_step, sgd

import _torch_mesh as dm
import _torch_model_mesh as mm
import _torch_train as tt

LLAMA = "llama3.2-1b"
SEQ = sh.ShardingRules(seq_axis="model")
SPLIT_RTOL = 1e-6  # a gradient of the split step against the unsplit one, of its leaf's max


def _step(mesh, host, rules):
    """One SGD step of the scaled-down Llama on ``mesh`` under ``rules``:
    (metrics, the gradients each position's update got, the exchange
    counts, the logged exchanges)."""
    _, model, _, p = mm.models(LLAMA)
    opt = sgd(1e-2, momentum=0.0)
    state = mm.placed_state(model, p, mesh, opt)
    rec, seen = dm.recording(opt)
    tp.reset_exchange_counts()
    with sh.activate(mesh, rules), tp.logging_exchanges() as logged:
        _, metrics = make_train_step(model, rec)(state, tt.as_port(host))
    return metrics, seen, tp.exchange_counts(), list(logged)


@pytest.mark.parametrize("data,model,microbatches", [(1, 2, 1), (2, 2, 1), (2, 2, 2)])
def test_a_split_llama_step_matches_the_reference_one_device_step(data, model, microbatches):
    tp.reset_exchange_counts()
    with sh.activate(mm.grid(data, model), SEQ):
        mm.check_against_the_reference(LLAMA, data, model, microbatches)
    counts = tp.exchange_counts()
    assert counts["seq_gather"]["bytes"] > 0 and counts["seq_reduce"]["bytes"] > 0


def test_the_split_loss_is_the_unsplit_bits_and_gradients_within_1e6():
    _, model, _, _ = mm.models(LLAMA)
    host = mm.masked_batch(model.cfg)
    mesh = mm.grid(2, 2)
    m0, g0, c0, unsplit = _step(mesh, host, None)
    m1, g1, c1, logged = _step(mesh, host, SEQ)
    assert float(m1["loss"]) == float(m0["loss"]) and float(m1["ce"]) == float(m0["ce"])
    paths = checkpoint.leaves(checkpoint.map_with_path(lambda k, _: k, mm.models(LLAMA)[3]))
    moved = set()
    for j, path in enumerate(paths):
        for a, b in zip(g0, g1):  # each position's gradients
            if a[j] is None:
                continue
            err = float((a[j] - b[j]).abs().max()) / float(a[j].abs().max())
            assert err <= SPLIT_RTOL, (path, err)
            if err:
                moved.add(path.split("//")[-1])
    assert moved <= {"mixer_norm", "ffn_norm", "final_norm"}
    # the residual never leaves the home whole: no fan-out or fan-in of (B, S, d)
    rows, s = host["inputs"].shape[0] // 2, host["inputs"].shape[1]
    residual = (rows, s, model.cfg.d_model)
    assert any(meta.get("shape") == residual for kind, meta in unsplit if kind == "fan_out")
    for kind, meta in logged:
        if kind in ("fan_out", "fan_in"):
            assert meta.get("shape") != residual and residual not in meta.get("shapes", ())
    assert {"seq_gather", "seq_reduce", "param_copy"} <= set(c1) and "seq_gather" not in c0


def test_the_sequence_collectives_backwards_are_model_order_sums():
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    chunks = [t(2, 3, 5).requires_grad_() for _ in range(3)]
    x = tp.Split(tuple(chunks), 1)
    outs = tp.seq_gather(x)
    whole = torch.cat([c.detach() for c in chunks], 1)
    assert all(torch.equal(o, whole) for o in outs)
    g = t(2, 9, 5)
    gs = [g, torch.full_like(g, 1e8), torch.full_like(g, -1e8)]  # (g + 1e8) - 1e8 != g
    torch.autograd.backward(outs, gs)
    want = (gs[0] + gs[1]) + gs[2]
    assert not torch.equal(want, gs[0] + (gs[1] + gs[2]))  # the order shows
    for m, c in enumerate(chunks):
        assert torch.equal(c.grad, want[:, 3 * m:3 * m + 3])
    parts = [p.clone().requires_grad_() for p in gs]
    got = tp.seq_reduce(parts, 1, ["cpu"] * 3)
    assert torch.equal(torch.cat(got.chunks, 1), want) and got.dim == 1
    h = t(2, 9, 5)
    torch.autograd.backward(got.chunks, list(h.split(3, 1)))
    assert all(torch.equal(p.grad, h) for p in parts)
    # one partial is a scatter, and a whole leaf copied to the chunks' positions
    # adds their gradients in model order
    one = tp.seq_reduce([whole], 1, ["cpu"] * 3)
    assert all(torch.equal(a, b) for a, b in zip(one.chunks, whole.split(3, 1)))
    scale = t(5).requires_grad_()
    copies = tp.fan_out(scale, ["cpu"] * 3, kind="param_copy")
    torch.autograd.backward(copies, [u[0, 0] for u in gs])
    assert torch.equal(scale.grad, (gs[0][0, 0] + gs[1][0, 0]) + gs[2][0, 0])
    # the d-split lookup resharded to the sequence is table[ids]'s rows, exactly
    table = t(64, 8)
    ids = torch.from_numpy(rng.integers(0, 64, (3, 6)).astype(np.int32))
    rows = tp.embed_lookup(tp.Split(tuple(table.chunk(2, 1)), 1), ids, by_sequence=True)
    assert torch.equal(torch.cat(rows.chunks, 1), table[ids.long()])


def test_a_one_layer_toys_sequence_exchanges_by_hand():
    """Llama's one scaled-down layer on 1 × 2, one microbatch: each of the
    three gathers (attention's and the MLP's input, the head's) and the
    two reduce-scatters (their outputs) moves, forward and backward, half
    of the residual (B, S, d) from each position to the other; the norms'
    scales (d, f32) go to position 1 and their partials come back."""
    _, model, _, _ = mm.models(LLAMA)
    cfg = model.cfg
    assert cfg.num_layers == 1
    host = mm.masked_batch(cfg)
    b, s = host["inputs"].shape
    half = b * s * cfg.d_model * 4 // 2  # f32 compute
    from repro_torch.distribution import peer

    mesh = mm.grid(1, 2)
    peer.reset_link_counts()
    with peer.distinct_positions():
        _, _, counts, _ = _step(mesh, host, SEQ)
    links = peer.link_counts()
    for src, dst in ((0, 1), (1, 0)):
        assert links["seq_gather", src, dst] == {"calls": 6, "bytes": 6 * half}
        assert links["seq_reduce", src, dst] == {"calls": 4, "bytes": 4 * half}
    assert links["param_copy", 0, 1] == {"calls": 3, "bytes": 3 * cfg.d_model * 4}
    assert links["param_copy", 1, 0] == links["param_copy", 0, 1]
    assert counts["seq_gather"]["bytes"] == 12 * half
    assert counts["seq_reduce"]["bytes"] == 8 * half


def test_a_sequence_that_does_not_divide_runs_unsplit_bit_for_bit():
    """15 tokens over 2 positions: the reference's divisibility fallback
    leaves the sequence whole, and the step is the unsplit one's bits."""
    _, model, _, _ = mm.models(LLAMA)
    host = tt.batch(model.cfg, b=4, s=15)
    mesh = mm.grid(2, 2)
    m0, g0, c0, _ = _step(mesh, host, None)
    m1, g1, c1, _ = _step(mesh, host, SEQ)
    assert c1 == c0 and "seq_gather" not in c1
    assert float(m1["loss"]) == float(m0["loss"])
    for a, b in zip(g0, g1):
        assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(a, b))


def test_constrain_splits_only_inside_a_group_under_the_rules():
    from repro_torch.distribution import peer

    mesh = mm.grid(1, 2)
    x = torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3)
    with sh.activate(mesh, SEQ):
        assert sh.constrain(x, ("batch", "seq", None)) is x  # no group
        with peer.in_group(mesh, 0):
            got = sh.constrain(x, ("batch", "seq", None))
            assert isinstance(got, tp.Split) and got.dim == 1
            assert torch.equal(torch.cat(got.chunks, 1), x)
            assert sh.constrain(got, ("batch", "seq", None)) is got
            odd = torch.ones(2, 5, 3)
            assert sh.constrain(odd, ("batch", "seq", None)) is odd
    with sh.activate(mesh), peer.in_group(mesh, 0):
        assert sh.constrain(x, ("batch", "seq", None)) is x  # default rules: no seq axis
