"""Train step of the model API — counterpart of ``repro/train/trainer.py``:
autograd, microbatch gradient accumulation and the optimizer update.

The params tree (``Model.init``) is flattened into the leaves of
``jax.tree_util``'s order (:func:`repro_torch.train.checkpoint.leaves`),
the flat list the optimizers work on, so ``opt.mu``/``opt.nu`` line up
leaf for leaf with the reference's parameter-shaped moment trees (and a
checkpoint writes them as those trees). Float leaves are differentiated;
index leaves (a sparse FFN weight's int32 block columns and bool mask)
pass through with no gradient, as the reference drops their ``float0``
cotangents, and come out of every step as the same tensors.

Microbatching splits the leading batch dim into ``microbatches`` chunks
run one after another: live activation memory is 1/microbatches of the
full batch's, the arithmetic unchanged. Gradients accumulate in f32.

On the card a sparse FFN weight runs on the SpMM kernels forward and
backward (``models.layers.linear`` → ``kernels.autodiff``): a
``bsr_spmm`` launch forward and, for an input that needs a gradient, a
``bcsr_spmm`` launch on the ELL transpose backward.

On the model's mesh (``launch.mesh.make_local_mesh(data=D, model=M)``)
the state is placed (``init_train_state(..., mesh=)``, or
``distribution.sharding.place`` with :func:`state_shardings`): each leaf
stored as ``param_pspecs`` says, one chunk a position. The M positions of
a data index form its group. The same ``train_step`` then computes the
reference's step as GSPMD runs it, from one process, in a fixed order:

1. each group gathers its leaves once a step (``sharding.group_params``,
   which serving shares): each position its ``model`` chunk of every leaf
   split over ``model``, whole along ``data`` (``tensor_parallel.Split``),
   and the group's home position (model index 0) every other leaf whole
   (positions on one device share the copy);
2. for each data index in order, its group runs :func:`loss_and_grads`
   once on its rows of each microbatch (``sharding.split_batch``): heads,
   hidden columns, experts and vocab on their positions, the collectives
   of ``distribution.tensor_parallel`` in the forward and autograd
   through them, layers whose weights are whole once on the home device.
   Its ce is weighted by its share of the microbatch's unmasked labels and
   its MoE aux loss by its share of the token groups (1/D), so the groups'
   losses add up to the global mean. Where a data index's rows make
   smaller MoE token groups than the microbatch's
   (``sharding.moe_groups_cross``), the groups run one forward together,
   layer by layer, each MoE layer once on group 0's home over every
   group's rows (``Model.loss_groups``), its aux loss entering the loss
   once, and one backward of their losses summed in data order;
3. each group's gradients are added onto the owners at once, in card
   order, per ``model`` chunk (``sharding.constrain_like_params``), one
   group's gradients alive at a time;
4. the optimizer updates each position's chunks with one global norm
   (``optimizer.update_placed``).

So D × M positions on one device and D × M cards give the same bits, and
``model`` = 1 gives the data mesh's step, one position the unplaced
step's bits. Under ``ShardingRules(seq_axis="model")`` active around the
step (``sharding.activate``), each group holds its residual split along
the sequence over its M positions (``sharding.constrain``); a leaf whole
along ``model`` that scales the chunks (a norm's scale) is copied to
their positions and its M partial gradients come back added in model
order (``tensor_parallel.fan_out``, ``kind="param_copy"``) before step
3. Every mixer the configs name runs split over ``model``: GQA
and MLA over heads, Mamba over its inner channels, RWKV-6's time mix over
heads and its channel mix over ``d_ff``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.distribution.sharding import (
    GroupRun,
    Placed,
    constrain_like_params,
    group_params,
    moe_groups_cross,
    param_pspecs,
    place,
    shardings_for,
    split_batch,
)
from repro_torch.models.model import Model
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import (
    Optimizer,
    OptState,
    global_norm,
    init_placed,
    update_placed,
)


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(model: Model, optimizer: Optimizer, generator: torch.Generator | None,
                     *, device=None, mesh=None, rules=None) -> TrainState:
    """Params drawn from ``generator`` on ``device`` (``None``: the card,
    or the home device of ``mesh``) and the optimizer's state over their
    leaves. With ``mesh``: the params placed by ``param_pspecs`` under
    ``rules``, the moments made on each position like the chunk they
    follow."""
    if mesh is None:
        params = model.init(generator, device=device)
        return TrainState(params, optimizer.init(checkpoint.leaves(params)))
    params = model.init(generator, device=mesh.device if device is None else device)
    params = place(params, shardings_for(None, mesh, param_pspecs(model.cfg, params, mesh,
                                                                  rules)))
    return TrainState(params, init_placed(optimizer, checkpoint.leaves(params)))


def state_shardings(cfg, state: TrainState, mesh, rules=None) -> TrainState:
    """Where each leaf of a training state lives on ``mesh``: the params'
    ``Sharding`` by ``param_pspecs``, each moment its param's, and None
    (left on the host) for the step and SGD's unused scalar moment. The
    ``shardings=`` of ``checkpoint.restore``."""
    ps = shardings_for(None, mesh, param_pspecs(cfg, state.params, mesh, rules))
    flat = checkpoint.leaves(ps)

    def moments(m):
        return list(flat) if isinstance(m, list) else None

    return TrainState(ps, OptState(None, moments(state.opt.mu), moments(state.opt.nu)))


def _is_float(leaf) -> bool:
    return leaf.is_floating_point()


def loss_and_grads(model: Model, params, batch, *, shares=None) -> tuple[torch.Tensor, dict,
                                                                         list]:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``: the
    counterpart of ``jax.value_and_grad(model.loss, has_aux=True,
    allow_int=True)``, with the gradients as the flat list of
    :func:`checkpoint.leaves` (``None`` for an index leaf, zeros for a
    float leaf the loss does not reach). ``shares``: ``model.loss``'s, a
    group's shares of a global batch. A leaf split over ``model``
    (``tensor_parallel.Split``) gets its gradient as a ``Split`` of its
    chunks' gradients, each on its chunk's device."""
    flat, live = _differentiable(params)
    with torch.enable_grad():
        loss, metrics = model.loss(checkpoint.with_leaves(params, flat), batch, shares=shares)
        got = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _gradients(flat, got)


def _differentiable(params) -> tuple[list, list]:
    """(the flat leaves of ``params``, each float leaf, or each chunk of a
    ``Split``, a fresh tensor that requires grad; those tensors in order)."""
    def fresh(t):
        return t.detach().requires_grad_()

    flat = [(leaf.map(fresh) if isinstance(leaf, tp.Split) else fresh(leaf))
            if _is_float(leaf) else leaf for leaf in checkpoint.leaves(params)]
    live = [t for leaf in flat if _is_float(leaf)
            for t in (leaf.chunks if isinstance(leaf, tp.Split) else (leaf,))]
    return flat, live


def _gradients(flat: list, got) -> list:
    """The gradients ``got`` of :func:`_differentiable`'s tensors as the
    flat leaves' (zeros where the loss does not reach, None for an index
    leaf)."""
    got = iter(got)

    def grad(t):
        g = next(got)
        return torch.zeros_like(t) if g is None else g

    return [(leaf.map(grad) if isinstance(leaf, tp.Split) else grad(leaf))
            if _is_float(leaf) else None for leaf in flat]


def _shares(labels: torch.Tensor, microbatches: int, n: int) -> torch.Tensor:
    """(microbatches, n) ce shares: each position's unmasked labels over its
    microbatch's (all 0 in a microbatch with none, whose ce is 0)."""
    counts = (labels.reshape(microbatches, n, -1) >= 0).sum(-1).float()
    return counts / torch.clamp_min(counts.sum(1, keepdim=True), 1.0)


def _placed_step(model: Model, optimizer: Optimizer, microbatches: int, state: TrainState,
                 batch) -> tuple[TrainState, dict]:
    """The train step on a placed state (the module docstring's 1-4)."""
    owners = checkpoint.leaves(state.params)
    mesh = owners[0].sharding.mesh
    m_size = mesh.shape.get("model", 1)
    homes = mesh.devices[::m_size]
    n = len(homes)
    split = split_batch(batch, mesh, microbatches)
    run = GroupRun(mesh, n) if moe_groups_cross(model.cfg, split[0][0], n) else None
    shares = _shares(batch["labels"], microbatches, n)
    # every group's rows and shares on its home device before any work is queued
    staged = [[({k: peer.send(v, d, None, c * m_size) for k, v in split[i][c].items()},
                (peer.send(shares[i, c], d, None, c * m_size), 1.0 / n))
               for c, d in enumerate(homes)]
              for i in range(microbatches)]
    groups = group_params(state.params, owners, mesh)
    acc, loss, metrics = None, None, None
    for i in range(microbatches):
        if run is not None:
            acc, terms = _crossing_microbatch(model, run, groups, staged[i], owners, acc)
        else:  # one group's forward and backward at a time: one group's activations alive
            terms = []
            for c in range(n):
                rows, sh = staged[i][c]
                with peer.in_group(mesh, c):
                    if peer.computes(c):
                        loss_c, metrics_c, g = loss_and_grads(model, groups[c], rows, shares=sh)
                        like = _skeleton((loss_c, metrics_c, g))
                    else:
                        loss_c, metrics_c, g = _stand_in(like, c * m_size)
                    acc = constrain_like_params(g, owners=owners, into=acc)
                    del g
                    terms.append((peer.send(loss_c, homes[0], c * m_size, 0, "metrics"),
                                  {k: peer.send(v, homes[0], c * m_size, 0, "metrics")
                                   for k, v in metrics_c.items()}))
        loss_i = peer.shard_order_sum([t[0] for t in terms])
        metrics_i = {k: peer.shard_order_sum([t[1][k] for t in terms]) for k in terms[0][1]}
        loss = loss_i if loss is None else loss + loss_i
        metrics = metrics_i if metrics is None else {k: metrics[k] + metrics_i[k]
                                                     for k in metrics}
    del groups
    grads = [None if a is None else Placed(tuple(a), leaf.sharding)
             for a, leaf in zip(acc, owners)]
    if microbatches > 1:
        inv = 1.0 / microbatches
        grads = [None if g is None else g.map(lambda x: x * inv) for g in grads]
        loss, metrics = loss * inv, {k: v * inv for k, v in metrics.items()}
    with torch.no_grad():
        new_leaves, new_opt, gnorm = update_placed(optimizer, grads, state.opt, owners)
    metrics = dict(metrics)
    metrics["loss"] = loss
    metrics["grad_norm"] = gnorm
    return TrainState(checkpoint.with_leaves(state.params, new_leaves), new_opt), metrics


def _crossing_microbatch(model: Model, run: GroupRun, groups: list, staged: list, owners: list,
                         acc) -> tuple[list, list]:
    """One microbatch whose MoE token groups cross data indices: one forward
    of every group together (``Model.loss_groups``, layer by layer), their
    losses sent to position 0 and summed in data order, one
    ``torch.autograd.grad`` of that sum, then each group's gradients added
    onto the owners in card order (``constrain_like_params``). A MoE
    layer's weights get their gradient on group 0's copy alone; the other
    groups' copies get zeros. Returns (the sums, each group's loss and
    metrics on position 0)."""
    mesh = run.mesh
    m_size = mesh.shape.get("model", 1)
    home0 = mesh.devices[0]
    diffs = [_differentiable(groups[c]) if run.computes(c) else None for c in range(run.groups)]
    with torch.enable_grad():
        out = model.loss_groups(
            run, [None if d is None else checkpoint.with_leaves(groups[c], d[0])
                  for c, d in enumerate(diffs)],
            [rows for rows, _ in staged], [shares[0] for _, shares in staged])
        terms = []
        for c in range(run.groups):
            with peer.in_group(mesh, c):
                if out[c] is None:
                    out[c] = _stand_in(out_like, c * m_size)
                out_like = _skeleton(out[c])
                loss_c, metrics_c = out[c]
                terms.append((peer.send(loss_c, home0, c * m_size, 0, "metrics"),
                              {k: peer.send(v, home0, c * m_size, 0, "metrics")
                               for k, v in metrics_c.items()}))
        live = [t for d in diffs if d is not None for t in d[1]]
        got = torch.autograd.grad(peer.shard_order_sum([t[0] for t in terms]), live,
                                  allow_unused=True)
    k = 0
    for c, d in enumerate(diffs):
        with peer.in_group(mesh, c):
            if d is None:
                g = _stand_in(grads_like, c * m_size)
            else:
                g, k = _gradients(d[0], got[k:k + len(d[1])]), k + len(d[1])
                grads_like = _skeleton(g)
            acc = constrain_like_params(g, owners=owners, into=acc)
            del g
    return acc, [(loss.detach(), {name: v.detach() for name, v in metrics.items()})
                 for loss, metrics in terms]


class _Like(NamedTuple):
    shape: torch.Size
    dtype: torch.dtype


def _skeleton(tree):
    """``tree`` with each tensor, a ``Split``'s chunks too, as its shape
    and dtype: no storage held."""
    if isinstance(tree, torch.Tensor):
        return _Like(tree.shape, tree.dtype)
    if isinstance(tree, tp.Split):
        return tp.Split(tuple(_Like(c.shape, c.dtype) for c in tree.chunks), tree.dim)
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return tree


def _stand_in(skeleton, home: int, m: int = 0):
    """Zeros of a :func:`_skeleton`'s shapes, each made for position
    ``home + m`` of its model index (``peer.traced_groups``)."""
    if isinstance(skeleton, _Like):
        with peer.at(home + m):
            return torch.zeros(skeleton.shape, dtype=skeleton.dtype,
                               device=peer.device_of(home + m))
    if isinstance(skeleton, tp.Split):
        return tp.Split(tuple(_stand_in(c, home, k) for k, c in enumerate(skeleton.chunks)),
                        skeleton.dim)
    if isinstance(skeleton, dict):
        return {k: _stand_in(v, home, m) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_stand_in(v, home, m) for v in skeleton)
    return skeleton


def make_train_step(model: Model, optimizer: Optimizer, *, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves are tensors with leading dim = global batch, on the
    params' device; with microbatching that dim must split evenly into
    ``microbatches`` chunks. ``metrics``: ``ce``, ``moe_aux``, ``loss``
    and ``grad_norm`` (over float gradients) as device scalars. A placed
    state (the data mesh) takes the batch on any device, the host
    included; each position's rows go to its device, and the metrics
    come back on the home device.
    """

    def single(params, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch)
        return loss, metrics, constrain_like_params(grads)

    def accumulated(params, batch):
        def split(x):
            return x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])

        mb = {k: split(v) for k, v in batch.items()}
        loss_sum, metrics_sum, acc = None, None, None
        for i in range(microbatches):
            loss, metrics, g = loss_and_grads(model, params, {k: v[i] for k, v in mb.items()})
            g = constrain_like_params(g)
            if acc is None:  # f32 accumulators; index leaves carry no gradient
                loss_sum, metrics_sum = loss, metrics
                acc = [None if x is None else x.float() for x in g]
            else:
                loss_sum = loss_sum + loss
                metrics_sum = {k: metrics_sum[k] + metrics[k] for k in metrics_sum}
                acc = [a if a is None else a.add_(x.float()) for a, x in zip(acc, g)]
            acc = constrain_like_params(acc)
        inv = 1.0 / microbatches
        grads = [None if a is None else a * inv for a in acc]
        return loss_sum * inv, {k: v * inv for k, v in metrics_sum.items()}, grads

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if isinstance(checkpoint.leaves(state.params)[0], Placed):
            return _placed_step(model, optimizer, microbatches, state, batch)
        if microbatches > 1:
            loss, metrics, grads = accumulated(state.params, batch)
        else:
            loss, metrics, grads = single(state.params, batch)
        with torch.no_grad():
            new_leaves, new_opt = optimizer.update(grads, state.opt,
                                                   checkpoint.leaves(state.params))
            metrics = dict(metrics)
            metrics["loss"] = loss
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(checkpoint.with_leaves(state.params, new_leaves), new_opt), metrics

    return train_step
