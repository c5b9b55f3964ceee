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
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distribution.sharding import constrain_like_params
from repro_torch.models.model import Model
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import Optimizer, OptState, global_norm


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def init_train_state(model: Model, optimizer: Optimizer, generator: torch.Generator | None,
                     *, device=None) -> TrainState:
    """Params drawn from ``generator`` on ``device`` (``None``: the card)
    and the optimizer's state over their leaves."""
    params = model.init(generator, device=device)
    return TrainState(params, optimizer.init(checkpoint.leaves(params)))


def _is_float(leaf) -> bool:
    return leaf.is_floating_point()


def loss_and_grads(model: Model, params, batch) -> tuple[torch.Tensor, dict, list]:
    """``(loss, metrics, grads)`` of ``model.loss`` at ``params``: the
    counterpart of ``jax.value_and_grad(model.loss, has_aux=True,
    allow_int=True)``, with the gradients as the flat list of
    :func:`checkpoint.leaves` (``None`` for an index leaf, zeros for a
    float leaf the loss does not reach)."""
    flat = [leaf.detach().requires_grad_() if _is_float(leaf) else leaf
            for leaf in checkpoint.leaves(params)]
    live = [leaf for leaf in flat if _is_float(leaf)]
    with torch.enable_grad():
        loss, metrics = model.loss(checkpoint.with_leaves(params, flat), batch)
        got = iter(torch.autograd.grad(loss, live, allow_unused=True))
    grads = []
    for leaf in flat:
        g = next(got) if _is_float(leaf) else None
        grads.append(torch.zeros_like(leaf) if g is None and _is_float(leaf) else g)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, optimizer: Optimizer, *, microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves are tensors with leading dim = global batch, on the
    params' device; with microbatching that dim must split evenly into
    ``microbatches`` chunks. ``metrics``: ``ce``, ``moe_aux``, ``loss``
    and ``grad_norm`` (over float gradients) as device scalars.
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
