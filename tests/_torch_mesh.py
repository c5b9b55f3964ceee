"""Shared by the data-mesh tests (``test_torch_data_mesh*.py``): the
port's 4-position step against the reference's one-device step on the
same converted weights and the same numpy batch."""

import jax
import torch

from repro.train.trainer import TrainState as RefTrainState
from repro_torch import convert
from repro_torch.distribution import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train import checkpoint, make_train_step, sgd
from repro_torch.train.optimizer import Optimizer

import _torch_train as tt

SPARSE_MLP_ID = tt.tm.SPARSE_MLP_ID
N = 4
MOE_ARCH = "moonshot-v1-16b-a3b"
# (arch, rows, sequence): a MoE position needs a multiple of the group
# size (256 tokens here) to keep the reference's token groups
SIZES = {"llama3.2-1b": (8, 16), MOE_ARCH: (8, 128), SPARSE_MLP_ID: (8, 1)}


def four_positions():
    return make_local_mesh(data=N, device="cpu")


def masked_batch(cfg, arch: str, masked: bool = True) -> dict:
    """numpy inputs and labels; with ``masked``, labels -1 spread unevenly
    over the positions' rows (none on the first rows, every label of the
    last two rows, a few in between)."""
    b, s = SIZES[arch]
    host = tt.batch(cfg, b=b, s=s)
    if masked:
        labels = host["labels"]
        labels[-2:] = -1
        labels[2, : max(1, labels.shape[1] // 2)] = -1
        labels[4, :1] = -1
    return host


def recording(opt: Optimizer):
    """``opt`` whose update keeps the gradients it is given (one list a
    position on a placed state)."""
    seen: list = []

    def update(grads, state, params, *, gnorm=None):
        seen.append(grads)
        return opt.update(grads, state, params, gnorm=gnorm)

    return Optimizer(opt.init, update), seen


def whole(chunks_by_position: list, owners: list) -> list:
    """Each leaf's gradient put together from the positions' chunks; a
    leaf every position holds must be the same bits on all of them."""
    out = []
    for j, leaf in enumerate(owners):
        parts = [per[j] for per in chunks_by_position]
        if parts[0] is None:
            out.append(None)
        elif leaf.sharding.dim is None:
            assert all(torch.equal(p, parts[0]) for p in parts)
            out.append(parts[0])
        else:
            out.append(torch.cat(parts, leaf.sharding.dim))
    return out


def gathered(tree) -> list:
    return [tt.host(leaf.gather("cpu")) for leaf in checkpoint.leaves(tree)]


def placed_step(arch: str, host: dict, microbatches: int, opt):
    """(reference state and metrics after one jitted step of the
    reference, the port's placed state and metrics on 4 positions, the
    port's gradients as each leaf's whole) from the same weights."""
    ref_model, model, jp, _ = tt.models(arch)
    jopt, _ = tt.optimizers("sgd", lr=1e-2, momentum=0.0)
    jstate = RefTrainState(jp, jopt.init(jp))
    jstep = jax.jit(tt.ref_make_train_step(ref_model, jopt, microbatches=microbatches))
    js, jm = jstep(jstate, tt.as_ref(host))
    state = convert.train_state(jstate, mesh=four_positions())
    ropt, seen = recording(opt)
    ps, pm = make_train_step(model, ropt, microbatches=microbatches)(state, tt.as_port(host))
    return (js, jm), (state, ps, pm), whole(seen, checkpoint.leaves(state.params)), \
        (ref_model, jp)


def check_against_the_reference(arch: str, microbatches: int) -> None:
    """One SGD step on 4 positions against the reference's one-device step,
    masked labels spread unevenly: loss, ce, ``grad_norm``, the updated
    params (gathered) and, with one microbatch, each leaf's gradient put
    together from its owners' chunks; topology passes through."""
    _, cfg = tt.tm.configs(arch, "float32")
    host = masked_batch(cfg, arch)
    (js, jm), (state, ps, pm), grads, (ref_model, jp) = placed_step(
        arch, host, microbatches, sgd(1e-2, momentum=0.0))
    tt.assert_metrics_close(jm, pm)
    tt.assert_leaves_close([tt.host(x) for x in jax.tree.leaves(js.params)], gathered(ps.params))
    if microbatches == 1:
        tt.assert_leaves_close(tt.ref_grads(ref_model, jp, host), [tt.host(g) for g in grads])
    assert int(ps.opt.step) == 1
    for old, new in zip(checkpoint.leaves(state.params), checkpoint.leaves(ps.params)):
        assert isinstance(new, sh.Placed) and new.sharding == old.sharding
        if not old.is_floating_point():
            assert new is old  # topology passes through as the same tensors
