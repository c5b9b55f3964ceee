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
    update: Callable[[Sequence, OptState, Sequence[torch.Tensor]], tuple[list, OptState]]
    # update(grads, state, params) -> (new_params, new_state)


def _is_float(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


def _lr_at(lr, step: torch.Tensor) -> float:
    """The learning rate at ``step`` (a host scalar: the step lives on the CPU)."""
    return float(lr(step)) if callable(lr) else float(lr)


def global_norm(tensors: Sequence[torch.Tensor | None]) -> torch.Tensor:
    """sqrt of the sum of squares of every floating-point tensor."""
    sq = [torch.sum(t.float() ** 2) for t in tensors if t is not None and _is_float(t)]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


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

    def update(grads, state: OptState, params):
        step = state.step + 1
        grads = [g.float() if g is not None and _is_float(g) else g for g in grads]
        if grad_clip_norm:
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

    def update(grads, state: OptState, params):
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
