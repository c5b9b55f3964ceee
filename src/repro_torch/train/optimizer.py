"""Optimizers over flat lists of tensors — counterpart of ``repro/train/optimizer.py``.

AdamW with decoupled weight decay, global-norm gradient clipping and an
optional lower-precision moment type (``state_dtype``); SGD with
momentum; a linear-warmup cosine schedule. Each works on a flat list of
parameter tensors (``repro_torch.train.checkpoint.leaves`` flattens a
params tree or a sparse stack into one) and returns new tensors, as the reference's pure updates do.
Tensors that are not floating point (a sparse weight's topology) are
skipped by dtype: they pass through unchanged, whatever their gradient.

Not ``torch.optim``: the reference clips by the global norm of every
float gradient and decays every float parameter, biases included, and
these follow it step for step.

On the model's mesh the leaves are ``distribution.sharding.Placed``, one
chunk a position: :func:`global_norm` of placed gradients is one scalar
added in card order, each distinct chunk counted once, and
:func:`update_placed` runs the update position by position on the chunks
with that one norm. The updates are elementwise, so a chunk's update is
the whole update's slice, and the copies of a leaf held whole along an
axis (over ``data``, ``model`` or both) stay the same bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: list  # first moment, one tensor per parameter
    nu: list | torch.Tensor  # second moment (AdamW) or an unused scalar (SGD)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], OptState]
    update: Callable[..., tuple[list, OptState]]
    # update(grads, state, params, *, gnorm=None) -> (new_params, new_state);
    # gnorm: the gradients' global norm when they are one position's chunks


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


def _lr_at(lr, step: torch.Tensor) -> float:
    """The learning rate at ``step`` (a host scalar: the step lives on the CPU)."""
    return float(lr(step)) if callable(lr) else float(lr)


def global_norm(tensors: Sequence) -> torch.Tensor:
    """sqrt of the sum of squares of every floating-point tensor. Of
    placed gradients (``Placed`` leaves): each position's sum of squares
    over its own chunks, each distinct chunk counted once (a leaf whole
    along ``data`` on data index 0, one whole along ``model`` on model
    index 0), the positions' sums added in card order on position 0's
    device; the same bits on one device or across cards."""
    from repro_torch.distribution import peer
    from repro_torch.distribution.sharding import Placed

    live = [t for t in tensors if t is not None and t.is_floating_point()]
    if not any(isinstance(t, Placed) for t in live):
        sq = [torch.sum(t.float() ** 2) for t in live]
        return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())
    devices = live[0].sharding.devices
    m_size = live[0].sharding.model_size
    sums = []
    for p, device in enumerate(devices):
        c, m = divmod(p, m_size)
        with peer.at(p):
            sq = [torch.sum(t.chunks[p].float() ** 2) for t in live
                  if (c == 0 or t.sharding.data_dim is not None)
                  and (m == 0 or t.sharding.model_dim is not None)]
            total = torch.stack(sq).sum() if sq else torch.zeros((), device=device)
        sums.append(peer.send(total, devices[0], p, 0, "metrics"))
    with peer.at(0):
        return torch.sqrt(peer.shard_order_sum(sums))


def adamw(
    lr: float | Schedule,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: torch.dtype = torch.float32,
    grad_clip_norm: float = 1.0,
) -> Optimizer:
    """AdamW with the reference's defaults; moments kept in ``state_dtype``."""

    def init(params) -> OptState:
        zeros = [torch.zeros(p.shape, dtype=state_dtype if _is_float(p) else p.dtype,
                             device=p.device) for p in params]
        return OptState(torch.zeros((), dtype=torch.int32), zeros, [z.clone() for z in zeros])

    def update(grads, state: OptState, params, *, gnorm=None):
        step = state.step + 1
        grads = [g.float() if g is not None and _is_float(g) else g for g in grads]
        if grad_clip_norm:
            if gnorm is None:
                gnorm = global_norm(grads)
            scale = torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)
            grads = [g * scale.to(g.device) if g is not None and _is_float(g) else g
                     for g in grads]
        lr_t = _lr_at(lr, step)
        c1, c2 = 1.0 - b1 ** int(step), 1.0 - b2 ** int(step)
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            if not _is_float(p):  # frozen topology
                new_p.append(p), new_m.append(m), new_v.append(v)
                continue
            m32 = b1 * m.float() + (1.0 - b1) * g
            v32 = b2 * v.float() + (1.0 - b2) * g * g
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) + weight_decay * p.float()
            new_p.append((p.float() - lr_t * delta).to(p.dtype))
            new_m.append(m32.to(state_dtype))
            new_v.append(v32.to(state_dtype))
        return new_p, OptState(step, new_m, new_v)

    return Optimizer(init, update)


def sgd(lr: float | Schedule, *, momentum: float = 0.9) -> Optimizer:
    """SGD with (heavy-ball) momentum."""

    def init(params) -> OptState:
        return OptState(torch.zeros((), dtype=torch.int32),
                        [torch.zeros_like(p) for p in params], torch.zeros(()))

    def update(grads, state: OptState, params, *, gnorm=None):
        del gnorm  # no clipping
        step = state.step + 1
        lr_t = _lr_at(lr, step)
        new_p, new_m = [], []
        for g, m, p in zip(grads, state.mu, params):
            if not _is_float(p):  # frozen topology: its gradient is not applied
                new_p.append(p), new_m.append(m)
                continue
            m = momentum * m + g.to(m.dtype)
            new_p.append((p.float() - lr_t * m).to(p.dtype))
            new_m.append(m)
        return new_p, OptState(step, new_m, state.nu)

    return Optimizer(init, update)


def _chunks(leaves: Sequence, c: int) -> list:
    """Position ``c``'s chunk of each placed leaf (None stays None)."""
    return [None if x is None else x.chunks[c] for x in leaves]


def _placed(per_position: list[list], like: Sequence) -> list:
    """Per-position lists of chunks back into placed leaves of ``like``'s
    shardings; a leaf whose chunks all come back as they were (topology)
    is ``like``'s own."""
    from repro_torch.distribution.sharding import Placed

    return [x if all(a is b for a, b in zip(chunks, x.chunks)) else Placed(tuple(chunks),
                                                                            x.sharding)
            for x, chunks in zip(like, zip(*per_position))]


def init_placed(optimizer: Optimizer, params: Sequence) -> OptState:
    """``optimizer.init`` of placed params (a flat list of ``Placed``),
    position by position: moments placed like the params, each made on
    its position's device; SGD's unused scalar ``nu`` stays on the host."""
    per = [optimizer.init(_chunks(params, c)) for c in range(len(params[0].chunks))]
    nu = _placed([s.nu for s in per], params) if isinstance(per[0].nu, list) else per[0].nu
    return OptState(per[0].step, _placed([s.mu for s in per], params), nu)


def update_placed(optimizer: Optimizer, grads: Sequence, state: OptState,
                  params: Sequence) -> tuple[list, OptState, torch.Tensor]:
    """``optimizer.update`` of placed gradients, state and params: the
    global norm once (:func:`global_norm`, card order), copied to every
    position, then the update of each position's chunks with it. Returns
    ``(new placed params, new state, the norm on position 0's device)``."""
    from repro_torch.distribution import peer

    gnorm = global_norm(grads)
    devices = params[0].sharding.devices
    per = []
    for c, device in enumerate(devices):
        nu = _chunks(state.nu, c) if isinstance(state.nu, list) else state.nu
        with peer.at(c):
            per.append(optimizer.update(_chunks(grads, c),
                                        OptState(state.step, _chunks(state.mu, c), nu),
                                        _chunks(params, c),
                                        gnorm=peer.send(gnorm, device, 0, c, "metrics")))
    new_nu = (_placed([s.nu for _, s in per], params) if isinstance(state.nu, list)
              else per[0][1].nu)
    return (_placed([p for p, _ in per], params),
            OptState(per[0][1].step, _placed([s.mu for _, s in per], params), new_nu), gnorm)


def warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine decay to
    ``final_frac · peak_lr`` at ``total_steps``."""

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
