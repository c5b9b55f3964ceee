"""The deterministic kernel-config sweep behind the tuning table —
counterpart of ``repro/tune/sweep.py``.

``sweep_stack`` builds one :class:`~repro_torch.plan.StackPlan` per
candidate :class:`~repro_torch.tune.table.TunedConfig`, scores each with
the port's own launch bill (``repro_torch.plan.cost``), gates its
numerics against the default plan's output, and picks a winner
deterministically, by the reference's score:

1. ``stack_block_work`` — each layer's bill × its block area, summed:
   a re-blocked candidate cannot win by coarsening the grid, and forcing
   block-CSR on a skewed stack drops the bill.
2. route rank — ``fused`` < ``fused-tiled`` < ``layered`` < ``xla``.
3. the resident kernel's shared-memory bytes
   (``fused_mlp_smem_bytes``): at equal work and route, bf16 panels win.
4. enumeration order — the default config comes first, so a candidate
   must strictly improve something to displace it.

Wall-clock is measured (the best of ``reps`` timed forwards, on the card
ended by ``torch.cuda.synchronize()``) and recorded, never used to pick.
Accuracy is a gate: every candidate's probe output must stay within
``accuracy_rtol × max|default output|`` of the default plan's.

Candidates whose plan cannot be built are recorded with ``error``: on
the port that is a ``block_n`` outside the wrappers' column tiles (8,
16), or a shared-memory budget above ``SMEM_LIMIT_BYTES``.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize, to_device
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.tune.table import TunedConfig, TuningTable, default_backend

_ROUTE_RANK = {"fused": 0, "fused-tiled": 1, "layered": 2, "xla": 3}


def default_candidates(
    *,
    layouts: Sequence[str | None] = (None, "ell", "bcsr"),
    panel_dtypes: Sequence[str | None] = (None, "bfloat16"),
    block_ns: Sequence[int | None] = (None,),
    block_sizes: Sequence[int | None] = (None,),
    vmem_limits: Sequence[int | None] = (None,),
) -> list[TunedConfig]:
    """The sweep's candidate grid, the all-``None`` default config first
    (ties go to it), one candidate per distinct token."""
    out: list[TunedConfig] = []
    seen: set[str] = set()
    for bn in block_ns:
        for pdt in panel_dtypes:
            for lay in layouts:
                for bs in block_sizes:
                    for vl in vmem_limits:
                        cfg = TunedConfig(block_size=bs, block_n=bn, layout=lay,
                                          panel_dtype=pdt, vmem_limit_bytes=vl)
                        if cfg.token() not in seen:
                            seen.add(cfg.token())
                            out.append(cfg)
    out.sort(key=lambda c: not c.is_default)  # stable: default first
    return out


def _probe_panel(weights, width: int, device) -> torch.Tensor:
    """The reference's probe: standard normals from numpy's
    ``default_rng(0)``, the same values in both packages."""
    k = weights[0].shape[1]
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal((k, width)).astype(np.float32)).to(device)


def _timed_forward(plan, probe, reps: int) -> float:
    """Best host seconds of ``reps`` forwards; the first forward (the
    warm-up and, on the card, the CUDA graph capture) runs outside the
    clock."""
    plan.forward(probe)
    synchronize(probe.device)
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        plan.forward(probe)
        synchronize(probe.device)
        best = min(best, time.perf_counter() - t0)
    return best


def sweep_stack(
    weights,
    biases,
    width: int,
    *,
    candidates: Sequence[TunedConfig] | None = None,
    reps: int = 2,
    accuracy_rtol: float = 0.02,
    time_forwards: bool = True,
    probe=None,
    device=None,
) -> tuple[TunedConfig, list[dict]]:
    """Sweep candidate configs over one stack; return (winner, records).

    One record per candidate: ``token``, ``config``, ``route``,
    ``grid_steps``, ``block_work``, ``vmem_bytes`` (the resident kernel's
    shared-memory bytes; the reference's name), ``wall_s``,
    ``max_abs_err``, ``ok`` (the accuracy gate), ``selected``; a
    candidate whose plan cannot be built gets ``error`` and is skipped.
    ``time_forwards=False`` skips the timed forwards. ``probe`` replaces
    the seeded normal probe panel (pass workload-shaped inputs, such as
    the challenge's {0, 1} panel, so the gate judges what is served).
    The stack runs on ``device`` (default: the GPU; the CPU only when
    asked for).
    """
    from repro_torch import plan as _plan
    from repro_torch.kernels import fused_mlp as _fmlp

    device = resolve_device(device)
    if candidates is None:
        candidates = default_candidates()
    candidates = list(candidates)
    if not any(c.is_default for c in candidates):
        # the default config is the accuracy reference and the baseline
        candidates.insert(0, TunedConfig())
    moved = to_device((*weights, *biases), device)
    weights, biases = moved[:len(weights)], moved[len(weights):]
    probe = (_probe_panel(weights, width, device) if probe is None
             else torch.as_tensor(probe, dtype=torch.float32).to(device))

    default_plan = _plan.build_plan(weights, biases, width)
    ref = default_plan.forward(probe)
    err_bound = accuracy_rtol * max(float(ref.abs().max()), 1e-6)

    records: list[dict] = []
    best_idx: int | None = None
    best_score: tuple | None = None
    for idx, cand in enumerate(candidates):
        rec: dict = {"token": cand.token(), "config": cand.to_dict()}
        try:
            plan = (default_plan if cand.is_default
                    else _plan.build_plan(weights, biases, width, tuned=cand))
        except ValueError as e:  # a knob combination the port refuses
            rec.update(error=f"{type(e).__name__}: {e}", ok=False)
            records.append(rec)
            continue
        bn = cand.block_n or DEFAULT_BLOCK_N
        block_work = _plan.stack_block_work(plan.weights, width, block_n=bn)
        route_rank = _ROUTE_RANK.get(plan.route, len(_ROUTE_RANK))
        smem = (_fmlp.fused_mlp_smem_bytes(plan.weights[0].shape[0], cand.panel_dtype,
                                           plan.weights[0].block_shape[0])
                if plan.is_fused_route else 0)
        err = float((plan.forward(probe) - ref).abs().max())
        ok = err <= err_bound
        rec.update(route=plan.route, grid_steps=int(plan.grid_steps),
                   block_work=int(block_work), vmem_bytes=int(smem), max_abs_err=err, ok=ok)
        if time_forwards:
            rec["wall_s"] = _timed_forward(plan, probe, reps)
        records.append(rec)
        if not ok:
            continue
        score = (block_work, route_rank, smem, idx)
        if best_score is None or score < best_score:
            best_score, best_idx = score, idx
    if best_idx is None:
        raise RuntimeError(
            "tuning sweep found no candidate passing the accuracy gate "
            "(the default config always should: bad probe?)")
    for i, rec in enumerate(records):
        rec["selected"] = i == best_idx
    return candidates[best_idx], records


def tune_stack(
    weights,
    biases,
    width: int,
    *,
    table: TuningTable | None = None,
    backend: str | None = None,
    dtype: str | None = None,
    fingerprint: str | None = None,
    sweep: tuple[TunedConfig, list] | None = None,
    device=None,
    **sweep_kw,
) -> tuple[TunedConfig, TuningTable]:
    """Sweep one stack and record the winner in a tuning table; returns
    ``(winner, table)``. The entry carries the tuned and the default
    bills side by side, so a committed table can be audited. ``sweep``
    reuses a :func:`sweep_stack` result; ``backend`` defaults to the
    device type the sweep runs on (``"cuda"`` or ``"cpu"``)."""
    from repro_torch import plan as _plan

    device = resolve_device(device)
    if table is None:
        table = TuningTable()
    if backend is None:
        backend = default_backend(device)
    if dtype is None:
        dtype = str(weights[0].dtype).removeprefix("torch.")
    if fingerprint is None:
        fingerprint = _plan.topology_fingerprint(weights)
    if sweep is None:
        winner, records = sweep_stack(weights, biases, width, device=device, **sweep_kw)
    else:
        winner, records = sweep
    default_rec = next(r for r in records if r["token"] == "default")
    winner_rec = next(r for r in records if r.get("selected"))
    evidence = {
        "width": width,
        "route": winner_rec["route"],
        "default_route": default_rec["route"],
        "grid_steps": winner_rec["grid_steps"],
        "default_grid_steps": default_rec["grid_steps"],
        "block_work": winner_rec["block_work"],
        "default_block_work": default_rec["block_work"],
        "max_abs_err": winner_rec["max_abs_err"],
        "candidates": len(records),
    }
    if "wall_s" in winner_rec:
        evidence["wall_s"] = winner_rec["wall_s"]
        evidence["default_wall_s"] = default_rec["wall_s"]
    table.put(fingerprint, backend, dtype, winner, evidence)
    return winner, table
