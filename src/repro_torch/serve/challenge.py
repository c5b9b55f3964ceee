"""GraphChallenge-shaped streaming inference run — counterpart of
``repro/serve/challenge.py``.

Pushes a seeded sparse input set through :class:`SparseDNNEngine` in
width-classed panels: a ``neurons × layers`` RadiX-net topology
(``repro_torch.data.radixnet``), a {0, 1} input panel with the
challenge's 60 000 inputs as columns, and the official rate metric

    edges × inputs / second,   edges = layers · neurons · 32

Each step's output panel is reduced to its per-column activity on the
spot; the run's answer is the challenge category set (inputs with any
positive final activation), bit-comparable against
``radixnet_reference``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.data import radixnet as rx
from repro_torch.device import resolve_device
from repro_torch.serve.engine import SparseDNNEngine


@dataclasses.dataclass(frozen=True)
class ChallengeResult:
    """One challenge run's scorecard."""

    spec: rx.RadixNetSpec
    n_inputs: int
    categories: np.ndarray  # ground-truth-comparable answer set
    seconds: float  # timed serving loop (post-warmup)
    edge_inputs_per_sec: float  # the official challenge metric
    steps: int  # engine steps dispatched (warmup excluded)
    served: int  # input columns served (== n_inputs)
    routes: tuple[str, ...]  # distinct plan routes seen, in order
    levels: tuple[str, ...]  # distinct ladder levels seen, in order
    width_classes: tuple[int, ...]  # distinct padded widths seen
    grid_steps: int  # summed launch bill

    @property
    def edges(self) -> int:
        return self.spec.edges


def _ordered_unique(values) -> tuple:
    seen: dict[Any, None] = {}
    for v in values:
        seen.setdefault(v)
    return tuple(seen)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_challenge(
    spec: rx.RadixNetSpec,
    *,
    n_inputs: int = 60000,
    panel_width: int = 512,
    batch_align: int = 32,
    density: float = 0.3,
    seed: int = 0,
    use_resident: bool | None = None,
    device: Any = None,
) -> ChallengeResult:
    """Stream ``n_inputs`` seeded inputs through the engine, panelwise.

    It builds the engine from ``radixnet_weights`` on ``device``
    (default: the GPU, raising if there is none) and first runs one
    untimed panel of the serving width, so the metric bills steady-state
    serving, not kernel builds and plan construction.
    """
    device = resolve_device(device)
    weights, biases = rx.radixnet_weights(spec, device=device)
    engine = SparseDNNEngine(
        weights,
        biases,
        batch_align=batch_align,
        use_resident=use_resident,
        device=device,
    )
    panel = torch.from_numpy(
        rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=seed)
    ).to(device)
    engine.submit(panel[:, : min(panel_width, n_inputs)])
    engine.step(pad_to=panel_width)
    _sync(device)

    active = torch.zeros((n_inputs,), dtype=torch.bool, device=device)
    step_stats: list[dict] = []
    t0 = time.perf_counter()
    for start in range(0, n_inputs, panel_width):
        chunk = panel[:, start : start + panel_width]
        engine.submit(chunk)
        out, stats = engine.step(pad_to=panel_width)
        active[start : start + chunk.shape[1]] = (out > 0).any(dim=0)
        step_stats.append(stats)
    _sync(device)
    seconds = time.perf_counter() - t0

    return ChallengeResult(
        spec=spec,
        n_inputs=n_inputs,
        categories=np.flatnonzero(active.cpu().numpy()).astype(np.int64),
        seconds=seconds,
        edge_inputs_per_sec=spec.edges * n_inputs / max(seconds, 1e-9),
        steps=len(step_stats),
        served=sum(s["batch"] for s in step_stats),
        routes=_ordered_unique(s["plan"]["route"] for s in step_stats),
        levels=_ordered_unique(s["plan"]["level"] for s in step_stats),
        width_classes=_ordered_unique(s["padded_batch"] for s in step_stats),
        grid_steps=sum(s["grid_steps"] for s in step_stats),
    )
