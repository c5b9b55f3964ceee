"""GraphChallenge-shaped streaming inference run — counterpart of
``repro/serve/challenge.py``.

Pushes a seeded sparse input set through :class:`SparseDNNEngine` in
width-classed panels: a ``neurons × layers`` RadiX-net topology
(``repro_torch.data.radixnet``), a {0, 1} input panel with the
challenge's 60 000 inputs as columns, and the official rate metric

    edges × inputs / second,   edges = layers · neurons · 32

A mesh makes this the sharded engine's run. Each step's output panel is
reduced to its per-column activity on the spot; the run's answer is the
challenge category set (inputs with any positive final activation),
bit-comparable against ``radixnet_reference``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.data import radixnet as rx
from repro_torch.device import resolve_device, synchronize
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


def run_challenge(
    spec: rx.RadixNetSpec,
    *,
    n_inputs: int = 60000,
    panel_width: int = 512,
    batch_align: int = 32,
    density: float = 0.3,
    seed: int = 0,
    mesh: Any = None,
    use_resident: bool | None = None,
    engine: SparseDNNEngine | None = None,
    warmup: bool = True,
    block_size: int = 16,
    tuning_table: Any = None,
    panel_dtype=None,
    device: Any = None,
) -> ChallengeResult:
    """Stream ``n_inputs`` seeded inputs through the engine, panelwise.

    ``engine``: a prebuilt engine (with a fault injector, a shared plan
    cache, ...) that serves the spec's topology; it brings its own
    device. By default ``run_challenge`` builds one from ``radixnet_weights``
    (``block_size``) on ``device`` (default: the mesh's device, else the
    GPU, raising if there is none) with ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`: serve sharded), ``use_resident``,
    ``tuning_table`` (a hit on this spec's
    fingerprint retunes every panel's plan) and ``panel_dtype``
    (``"bfloat16"`` panels for the fused routes, over any hit's).
    ``warmup`` first runs one untimed
    panel of the serving width, so the metric bills steady-state serving
    (on the card: replays), not kernel builds, plan construction and
    the CUDA graph capture.
    """
    if engine is None:
        device = resolve_device(mesh.device if device is None and mesh is not None else device)
        weights, biases = rx.radixnet_weights(spec, block_size=block_size, device=device)
        engine = SparseDNNEngine(
            weights,
            biases,
            batch_align=batch_align,
            mesh=mesh,
            use_resident=use_resident,
            device=device,
            tuning_table=tuning_table,
            panel_dtype=panel_dtype,
        )
    device = engine.device
    panel = torch.from_numpy(
        rx.radixnet_input_panel(spec.neurons, n_inputs, density=density, seed=seed)
    ).to(device)
    if warmup:
        engine.submit(panel[:, : min(panel_width, n_inputs)])
        engine.step(pad_to=panel_width)
        synchronize(device)

    active = torch.zeros((n_inputs,), dtype=torch.bool, device=device)
    step_stats: list[dict] = []
    t0 = time.perf_counter()
    for start in range(0, n_inputs, panel_width):
        chunk = panel[:, start : start + panel_width]
        engine.submit(chunk)
        out, stats = engine.step(pad_to=panel_width)
        if out is None or stats["failed"]:
            raise RuntimeError(
                f"challenge panel at column {start} failed: "
                f"{stats.get('error', 'no output')}"
            )
        active[start : start + chunk.shape[1]] = (out > 0).any(dim=0)
        step_stats.append(stats)
    synchronize(device)
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
