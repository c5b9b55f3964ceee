"""Fault-tolerant sparse training — counterpart of ``repro/train/resilience.py``.

``run_resilient_training`` drives the port's
:func:`~repro_torch.train.sparse.make_sparse_train_step` (eagerly, over a
differentiable plan when one is given) under
:class:`~repro_torch.train.fault_tolerance.Supervisor`, with
:mod:`~repro_torch.train.checkpoint` as the restore source:

* sparse layouts checkpoint and restore exactly: f32 values round-trip
  bit for bit, integer and bool topology keeps its dtypes;
* a non-finite loss raises :class:`NonFiniteLossError` before the
  poisoned update is committed; the supervisor restores the last good
  checkpoint and replays. Batches are a deterministic function of the
  step and an injected fault fires once, so the replay is clean, and
  because every kernel of the step (the ELL backward included) adds in
  a fixed order, it gives the unfailed run's losses bit for bit;
* every restore validates the restored layouts
  (:func:`validate_sparse_state`), so a corrupt checkpoint fails at the
  restore, not as garbage steps later.

Kill and resume: call again on a directory that holds checkpoints
(``resume=True``, the default) and training continues from the latest
one.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.testing import faults as _faults
from repro_torch.train import checkpoint
from repro_torch.train.fault_tolerance import StragglerPolicy, Supervisor
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.sparse import SparseMLPState, make_sparse_train_step


class NonFiniteLossError(RuntimeError):
    """The loss went NaN or Inf: the in-flight update must not be committed."""


def validate_sparse_state(state: SparseMLPState, *, name: str = "SparseMLPState") -> SparseMLPState:
    """Check every layer of a sparse training state: the layout invariants
    of sparse weights (``validate()``, which also requires finite values),
    finite dense weights and biases. Returns ``state``; raises ValueError
    naming the layer at fault. Called on every restore."""
    for i, w in enumerate(state.weights):
        if hasattr(w, "validate"):
            w.validate(name=f"{name} layer {i} weight")
        elif not bool(torch.isfinite(w).all()):
            raise ValueError(f"{name} layer {i} weight has non-finite entries")
    for i, b in enumerate(state.biases):
        if not bool(torch.isfinite(b).all()):
            raise ValueError(f"{name} layer {i} bias has non-finite entries")
    return state


def _state_on(state: SparseMLPState, device: torch.device) -> SparseMLPState:
    """``state`` with its tensors on ``device`` (layers that share a matrix
    stay shared); the optimizer's step counter stays on the host."""

    def moments(m):
        return m.to(device) if isinstance(m, torch.Tensor) else list(to_device(m, device))

    opt = state.opt
    return SparseMLPState(to_device(state.weights, device), to_device(state.biases, device),
                          opt._replace(mu=moments(opt.mu), nu=moments(opt.nu)))


def run_resilient_training(
    state: SparseMLPState,
    batch_fn: Callable[[int], dict],
    optimizer: Optimizer,
    num_steps: int,
    ckpt_dir: str,
    *,
    ckpt_interval: int = 10,
    max_restarts: int = 3,
    use_kernel: bool = True,
    plan: Any = None,
    fault_injector: Any = None,
    straggler: StragglerPolicy | None = None,
    resume: bool = True,
    metadata: dict | None = None,
    device: Any = None,
) -> tuple[SparseMLPState, dict]:
    """Train the sparse stack for ``num_steps`` with checkpoint and restart.

    ``batch_fn(step) -> {"y0": ..., "targets": ...}`` must be
    deterministic in ``step``: a restart replays the same batches, so a
    restored run matches one that never failed. ``plan``: a
    differentiable StackPlan for the state's topology, whose cached
    transposes keep the backward free of sorts. The state and batches run
    on ``device`` (default: the GPU; the CPU only when asked for).

    ``fault_injector`` is polled at ``SITE_TRAIN_NAN_LOSS`` each step; a
    fire poisons that step's batch (a copy with ``y0[0, 0] = nan``), which
    surfaces as a non-finite loss → restore and replay. Returns
    ``(final_state, report)``: ``losses`` (step → loss; a replayed step's
    entry is overwritten with the same value), ``skipped`` (steps whose
    poisoned attempt was discarded), ``restarts`` (the supervisor's fault
    history), ``start_step`` and ``final_step``. ``float(loss)`` is the
    step's one synchronisation, so a straggler policy sees device time.
    """
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    device = resolve_device(device)
    state = validate_sparse_state(_state_on(state, device))
    train_step = make_sparse_train_step(optimizer, use_kernel=use_kernel, plan=plan)

    losses: dict[int, float] = {}
    poisoned: set[int] = set()

    def step_fn(st: SparseMLPState, step: int) -> SparseMLPState:
        batch = {k: v.to(device) for k, v in batch_fn(step).items()}
        if fault_injector is not None and fault_injector.fires(
                _faults.SITE_TRAIN_NAN_LOSS, step) is not None:
            poisoned.add(step)
            y0 = batch["y0"].clone()
            y0[0, 0] = float("nan")
            batch["y0"] = y0
        new_st, metrics = train_step(st, batch)
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            # raised before the supervisor commits new_st: the poisoned
            # update dies here and the restore path takes over
            raise NonFiniteLossError(f"loss={loss} at step {step}")
        losses[step] = loss
        return new_st

    def load_state(tree: SparseMLPState) -> SparseMLPState:
        return validate_sparse_state(tree, name="restored SparseMLPState")

    start_step = 0
    last = checkpoint.latest_step(ckpt_dir)
    if resume and last is not None:
        restored, manifest = checkpoint.restore(ckpt_dir, state)
        state = load_state(restored)
        start_step = int(manifest["step"])
    elif last is None:
        # a fault in the first steps needs a step-0 checkpoint to restore
        checkpoint.save(ckpt_dir, 0, state, metadata={**(metadata or {}), "initial": True})

    sup = Supervisor(
        step_fn=step_fn,
        save_state=lambda st: st,
        load_state=load_state,
        ckpt_dir=ckpt_dir,
        ckpt_interval=ckpt_interval,
        max_restarts=max_restarts,
        straggler=straggler,
        metadata=metadata,
    )
    final = sup.run(state, num_steps, start_step=start_step)
    report = {
        "losses": dict(sorted(losses.items())),
        "skipped": sorted(poisoned),
        "restarts": [h for h in sup.history if h[1].startswith("fault")],
        "start_step": start_step,
        "final_step": num_steps,
    }
    return final, report


__all__ = ["NonFiniteLossError", "run_resilient_training", "validate_sparse_state"]
