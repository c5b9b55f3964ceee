"""Checkpoint-and-restart supervisor and straggler rule — counterpart of
``repro/train/fault_tolerance.py`` (host code only).

``Supervisor`` wraps a step function with checkpoint/restart: a step
that raises restores the last good checkpoint and training continues
from its step, up to ``max_restarts`` times. Because the batches are a
deterministic function of the step, a restart replays the same stream.

``StragglerPolicy``: a step slower than ``deadline_factor`` × the
rolling median of the last ``window`` steps is marked; after
``evict_after`` marks in a row the supervisor's ``on_straggler`` hook
fires.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train import checkpoint


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0
    evict_after: int = 2
    window: int = 16

    def __post_init__(self):
        self._times: list[float] = []
        self._consecutive = 0

    def observe(self, step_time: float) -> bool:
        """True when the straggler action should fire."""
        self._times.append(step_time)
        self._times = self._times[-self.window:]
        if len(self._times) < 4:
            return False
        median = sorted(self._times)[len(self._times) // 2]
        if step_time > self.deadline_factor * median:
            self._consecutive += 1
        else:
            self._consecutive = 0
        return self._consecutive >= self.evict_after


@dataclasses.dataclass
class Supervisor:
    step_fn: Callable[[Any, int], Any]  # (state, step) -> state
    save_state: Callable[[Any], Any]  # state -> checkpointable tree
    load_state: Callable[[Any], Any]  # tree -> state
    ckpt_dir: str
    ckpt_interval: int = 50
    max_restarts: int = 3
    straggler: StragglerPolicy | None = None
    on_straggler: Callable[[int], None] | None = None
    metadata: dict | None = None

    def run(self, state: Any, num_steps: int, *, start_step: int = 0) -> Any:
        step = start_step
        restarts = 0
        self._history: list[tuple[int, str]] = []
        while step < num_steps:
            try:
                t0 = time.monotonic()
                state = self.step_fn(state, step)
                dt = time.monotonic() - t0
                if self.straggler and self.straggler.observe(dt):
                    self._history.append((step, "straggler"))
                    if self.on_straggler:
                        self.on_straggler(step)
                step += 1
                if step % self.ckpt_interval == 0 or step == num_steps:
                    checkpoint.save(self.ckpt_dir, step, self.save_state(state),
                                    metadata={**(self.metadata or {}), "supervised": True})
                    checkpoint.retention(self.ckpt_dir, keep_last=3)
            except Exception as e:  # noqa: BLE001 — any step fault restarts
                restarts += 1
                self._history.append((step, f"fault: {type(e).__name__}"))
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts at step {step}") from e
                if checkpoint.latest_step(self.ckpt_dir) is None:
                    raise  # nothing to restore from
                restored, manifest = checkpoint.restore(self.ckpt_dir, self.save_state(state))
                state = self.load_state(restored)
                step = manifest["step"]
        return state

    @property
    def history(self) -> list[tuple[int, str]]:
        return list(getattr(self, "_history", []))
