"""Training a MoE whose token groups cross data indices: the scaled-down
Moonlight (``moonshot-v1-16b-a3b``) on 8 rows of 16 tokens, 32 tokens a
position on the 4-position data mesh (groups of 32) against the batch's
groups of 128, and 64 a data index on the 2 × 2 model mesh. The groups
run one forward together, each MoE layer once on the first data index's
home over every index's rows, and one backward; held to the reference's
one-device step (loss, ``moe_aux`` and every gradient, ``LOSS_RTOL`` and
``GRAD_RTOL``), where each position's own groups give another
``moe_aux``. And the two exchanges on their own: their backwards hand
each data index its rows bit for bit, and a logged call replays with its
counts."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp

import _torch_model_mesh as mm
import _torch_train as tt

MOE = mm.MOE_ARCH
SEQ = 16  # 8 rows: 32 tokens a position of the data mesh, the batch's groups of 128


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)], ids=("data4", "2x2"))
@pytest.mark.parametrize("microbatches", [1, 2])
def test_a_step_whose_groups_cross_matches_the_reference(data, model, microbatches):
    """Also: the one backward of every group bills each group's
    collectives to that group's positions, forward and backward."""
    peer.reset_link_counts()
    mm.check_against_the_reference(MOE, data, model, microbatches, s=SEQ)
    links = peer.link_counts()
    for home in range(0, data * model, model):
        assert ("moe_gather", home, 0) in links or home == 0
        if model > 1:  # the attention's fan-out to model index 1, and its gradient back
            assert {("fan_out", home, home + 1), ("fan_out", home + 1, home)} <= set(links)


def test_each_positions_own_groups_give_another_moe_aux():
    """The reference's ``moe_aux`` (E · mean over the batch's groups) is not
    the mean of the 4 positions' own, beyond the loss tolerance."""
    host, _, jm, _ = mm.reference_step(MOE, None, 1, SEQ)
    assert host["inputs"].shape == (8, SEQ)
    _, model, _, p = mm.models(MOE)
    own = np.mean([float(model.loss(p, tt.as_port({k: v[r:r + 2] for k, v in host.items()}))[1]
                         ["moe_aux"]) for r in range(0, 8, 2)])
    assert abs(own - jm["moe_aux"]) > 10 * tt.LOSS_RTOL * abs(jm["moe_aux"]), (own, jm)


@pytest.mark.parametrize("distinct", [False, True])
def test_the_moe_exchanges_backwards_hand_each_index_its_rows_bit_for_bit(distinct):
    g = torch.Generator().manual_seed(0)
    sizes, positions = (2, 1, 3), (0, 2, 4)
    xs = [torch.randn(r, 3, 8, generator=g, requires_grad=True) for r in sizes]
    tp.reset_exchange_counts()
    peer.reset_link_counts()
    with peer.distinct_positions() if distinct else contextlib.nullcontext():
        y = tp.moe_gather(xs, positions, "cpu")
        assert torch.equal(y, torch.cat(xs).detach())
        z = y.detach().requires_grad_()
        outs = tp.moe_return(z, sizes, ["cpu"] * 3, positions)
        assert all(torch.equal(o, r) for o, r in zip(outs, z.detach().split(sizes)))
        grads = [torch.randn(o.shape, generator=g) for o in outs]
        torch.autograd.backward(outs, grads)
        assert torch.equal(z.grad, torch.cat(grads))  # the return's backward gathers
        y.backward(z.grad)
    for x, want in zip(xs, grads):  # the gather's backward hands back the rows
        assert torch.equal(x.grad, want)
    row = 3 * 8 * 4
    assert tp.exchange_counts() == {k: {"calls": 2, "bytes": 2 * 4 * row}
                                    for k in ("moe_gather", "moe_return")}
    assert peer.link_counts() == {
        ("moe_gather", 2, 0): {"calls": 1, "bytes": row}, ("moe_gather", 4, 0):
        {"calls": 1, "bytes": 3 * row}, ("moe_gather", 0, 2): {"calls": 1, "bytes": row},
        ("moe_gather", 0, 4): {"calls": 1, "bytes": 3 * row},
        ("moe_return", 0, 2): {"calls": 1, "bytes": row}, ("moe_return", 0, 4):
        {"calls": 1, "bytes": 3 * row}, ("moe_return", 2, 0): {"calls": 1, "bytes": row},
        ("moe_return", 4, 0): {"calls": 1, "bytes": 3 * row}}


def test_a_logged_moe_gather_and_return_replay_with_their_counts():
    xs = [torch.ones(r, 4, requires_grad=True) for r in (2, 2)]
    tp.reset_exchange_counts()
    with tp.logging_exchanges() as log:
        outs = tp.moe_return(tp.moe_gather(xs, (0, 1), "cpu") * 2, (2, 2), ("cpu", "cpu"),
                             (0, 1))
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
    want = tp.exchange_counts()
    assert [kind for kind, _ in log] == ["moe_gather", "moe_return"]
    tp.reset_exchange_counts()
    for entry in log:
        tp.replay(entry)
    assert tp.exchange_counts() == want
