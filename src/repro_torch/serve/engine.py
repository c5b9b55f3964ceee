"""Batched serving of the sparse DNN — counterpart of ``SparseDNNEngine``
in ``repro/serve/engine.py``.

Requests are feature columns. ``submit(cols)`` stages columns,
``step(limit=..., pad_to=...)`` dispatches one right-padded panel over
what is staged, ``drain()`` steps until the stage is empty and
``infer(y0)`` is the one-shot form. Every step fetches a
:class:`~repro_torch.plan.StackPlan` for its padded width from the
engine's plan cache through the degradation ladder (resident → layered),
runs it, and reports exact launch accounting. Output columns that are
not finite fail only their own request ids (NaN quarantine), and the
weights' layout invariants are validated once, at construction.

``differentiable=True`` serves a forward that autograd can go through:
the plans route around the fused kernels (they have no backward), dense
layers take the plain fused form, and block-CSR layers carry their
cached transposes. The reference engine's ``mesh=``, ``fault_injector=``,
``tuning_table=`` and ``panel_dtype=`` are not taken.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.dnn import Weight
from repro_torch.device import resolve_device
from repro_torch.plan import routes as _routes
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.degrade import DegradationLadder
from repro_torch.plan.stack_plan import topology_fingerprint


@dataclasses.dataclass
class SparseDNNEngine:
    """Serve batched inference through the paper's deep sparse MLP.

    ``weights``/``biases``: the L-layer stack (BSR or block-CSR per
    layer), moved to ``device`` (default: the GPU; with no GPU and no
    explicit device the constructor raises). Panels are padded to
    ``batch_align`` columns so a few width classes serve every request.
    ``use_resident``: None serves the fused whole-stack kernels when the
    stack is eligible, True demands them, False forces the layered
    kernels. ``differentiable``: serve only routes autograd can go
    through (never the fused kernels; ``use_resident=True`` is refused).
    """

    weights: Sequence[Weight]
    biases: Sequence[torch.Tensor]
    batch_align: int = 64
    use_resident: bool | None = None  # None = auto-detect eligibility
    device: Any = None
    differentiable: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.n_layers = len(self.weights)
        if len(self.biases) != self.n_layers:
            raise ValueError("weights/biases length mismatch")
        if self.differentiable and self.use_resident:
            raise ValueError(
                "use_resident=True is incompatible with differentiable=True: the "
                "fused whole-stack kernels have no backward (no VJP). Use "
                "use_resident=None/False to route through the layered kernels, "
                "whose autograd Functions support torch.autograd."
            )
        # Layers that share one matrix object (RadiX-net phases) stay
        # shared: moved, validated and fingerprinted once each.
        moved: dict[int, Any] = {}
        for obj in (*self.weights, *self.biases):
            if id(obj) not in moved:
                moved[id(obj)] = obj.to(self.device)
        self.weights = tuple(moved[id(w)] for w in self.weights)
        self.biases = tuple(moved[id(b)] for b in self.biases)
        seen = set()
        for i, w in enumerate(self.weights):
            if id(w) not in seen and hasattr(w, "validate"):
                seen.add(id(w))
                w.validate(name=f"SparseDNNEngine layer {i} weight")
        self._fingerprint = topology_fingerprint(self.weights)
        resident_ok = (not self.differentiable
                       and _routes.fused_route(self.weights) is not None)
        if self.use_resident and not resident_ok:
            raise ValueError(
                "use_resident=True but the stack is not eligible for the "
                "fused whole-stack kernels (needs a homogeneous square "
                "BSR stack); pass use_resident=None to auto-detect"
            )
        self._resident = (
            resident_ok if self.use_resident is None else self.use_resident
        )
        self._ladder = DegradationLadder(
            PlanCache(max_size=16), use_resident=self._resident
        )
        self._served = 0
        self._steps = 0
        self._next_rid = 0
        # Staged work as contiguous (request_ids, panel) chunks — a chunk
        # is split only when a step's limit lands inside it.
        self._staged: list[tuple[list, torch.Tensor]] = []
        self._staged_count = 0

    # ------------------------------------------------------------------
    # step-level API
    # ------------------------------------------------------------------

    @property
    def staged(self) -> int:
        """Feature columns submitted but not yet dispatched."""
        return self._staged_count

    def submit(self, cols, request_ids: Sequence[Any] | None = None) -> list:
        """Stage (m, k) feature columns for the next ``step``; returns the
        request ids assigned to them (monotonic ints unless named)."""
        cols = torch.as_tensor(cols, dtype=torch.float32, device=self.device)
        m, k = cols.shape
        if request_ids is None:
            request_ids = list(range(self._next_rid, self._next_rid + k))
            self._next_rid += k
        elif len(request_ids) != k:
            raise ValueError(f"{len(request_ids)} request ids for {k} columns")
        if k:
            self._staged.append((list(request_ids), cols))
            self._staged_count += k
        return list(request_ids)

    def _idle_stats(self) -> dict:
        return {
            "batch": 0,
            "padded_batch": 0,
            "pad_slots": 0,
            "grid_steps": 0,
            "request_ids": [],
            "resident": self._resident,
            "differentiable": self.differentiable,
            "kernel_launches": 0,
            "served_total": self._served,
            "engine_steps": self._steps,
            "plan": None,
            "quarantined_request_ids": [],
        }

    def step(
        self, limit: int | None = None, *, pad_to: int | None = None
    ) -> tuple[torch.Tensor | None, dict]:
        """Dispatch ONE padded forward pass over up to ``limit`` staged
        columns (FIFO). Returns ``(Y[L] (m, batch), stats)``, or
        ``(None, stats)`` when nothing is staged. ``pad_to`` pads the
        panel further (aligned to ``batch_align``) so panels share one
        width class."""
        if limit is not None and limit < 1:
            raise ValueError(f"step limit must be >= 1, got {limit}")
        if pad_to is not None and pad_to < 1:
            raise ValueError(f"pad_to must be >= 1, got {pad_to}")
        batch = (
            self._staged_count if limit is None else min(limit, self._staged_count)
        )
        if batch == 0:
            return None, self._idle_stats()
        need = batch
        take: list[tuple[list, torch.Tensor]] = []
        while need:
            rids, arr = self._staged[0]
            k = arr.shape[1]
            if k <= need:
                take.append(self._staged.pop(0))
                need -= k
            else:  # split the chunk at the step boundary
                take.append((rids[:need], arr[:, :need]))
                self._staged[0] = (rids[need:], arr[:, need:])
                need = 0
        self._staged_count -= batch
        ids = [rid for rids, _ in take for rid in rids]
        width = batch + (-batch) % self.batch_align
        if pad_to is not None:
            width = max(width, pad_to + (-pad_to) % self.batch_align)
        yp = take[0][1] if len(take) == 1 else torch.cat([a for _, a in take], dim=1)
        plan, level, cache_hit = self._ladder.get_plan(
            self.weights, self.biases, width, fingerprint=self._fingerprint,
            differentiable=self.differentiable,
        )
        res = plan.forward(yp)[:, :batch]
        self._served += batch
        self._steps += 1
        quarantined: list = []
        col_ok = torch.isfinite(res).all(dim=0)
        if not bool(col_ok.all()):
            quarantined = [ids[j] for j in torch.nonzero(~col_ok).flatten().tolist()]
        stats = {
            "batch": batch,
            "padded_batch": width,
            "pad_slots": width - batch,
            "grid_steps": plan.grid_steps,
            "request_ids": ids,
            "resident": self._resident,
            "differentiable": self.differentiable,
            "kernel_launches": plan.kernel_launches,
            "served_total": self._served,
            "engine_steps": self._steps,
            "plan": {
                "width_class": width,
                "cache_hit": cache_hit,
                "route": plan.route,
                "level": level,
                "degraded": level != self._ladder.preferred_level,
            },
            "quarantined_request_ids": quarantined,
        }
        return res, stats

    def drain(self, limit: int | None = None) -> list[tuple[torch.Tensor, dict]]:
        """Step until the stage is empty (≤ ``limit`` columns per step)."""
        results = []
        while self._staged:
            results.append(self.step(limit))
        return results

    def infer(self, y0) -> tuple[torch.Tensor, dict]:
        """One-shot API: y0 (m, batch) feature columns → (Y[L], stats)."""
        y0 = torch.as_tensor(y0, dtype=torch.float32, device=self.device)
        if y0.shape[1] == 0:
            return y0, self._idle_stats()
        if self._staged:
            raise RuntimeError(
                "infer() on an engine with staged columns would reorder "
                "them past the step API's FIFO; call drain() first"
            )
        self.submit(y0)
        return self.step()
