"""Build-once execution plans for sparse DNN stacks.

Counterpart of ``repro/plan/stack_plan.py``. A :class:`StackPlan` does
the per-topology analysis ONCE per ``(topology fingerprint, panel-width
class, residency request, differentiable?)`` key and carries:

* the chosen execution layout per layer (the ELL-pad waste heuristic of
  ``repro_torch.plan.layout``, applied at build time);
* the route — fused / fused-tiled / layered (``repro_torch.plan.routes``);
* the exact launch bill for the plan's panel width (``plan.cost``);
* the bound weights: the relayouted layers, or the stacked weight and
  bias tensors of the fused routes;
* for a differentiable plan, each block-CSR layer's cached transpose
  (:class:`~repro_torch.sparse.bcsr.BcsrTransposePlan`), so no backward
  sorts the frozen topology again.

The reference jits one executable per plan; PyTorch runs eagerly, so a
plan's forward calls the kernel wrappers directly (capturing it as a
CUDA graph is later work, ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.dnn import Weight, stack_bsr
from repro_torch.kernels import ops as kernel_ops
from repro_torch.plan import cost as _cost
from repro_torch.plan import layout as _layout
from repro_torch.plan import routes as _routes
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

# Panel-width classes serving quantizes to by default.
DEFAULT_WIDTH_CLASSES = (8, 16, 32, 64, 128, 256, 512)


def quantize_width(n: int, classes: Sequence[int] | None = None) -> int:
    """Smallest width class covering an ``n``-column panel.

    ``classes=None`` → identity (no quantization). Widths beyond the
    largest class round up to a multiple of it.
    """
    if not classes:
        return n
    for c in sorted(classes):
        if n <= c:
            return c
    top = max(classes)
    return -(-n // top) * top


def _layer_digest(w: Weight) -> bytes:
    h = hashlib.sha1()
    if isinstance(w, BlockCSRMatrix):
        h.update(b"bcsr")
        h.update(repr((w.shape, w.block_shape, w.total_blocks)).encode())
        arrays = (w.row_ptr, w.row_id, w.col_idx, w.valid)
    elif isinstance(w, BlockSparseMatrix):
        h.update(b"ell")
        h.update(repr((w.shape, w.block_shape, w.max_blocks_per_row)).encode())
        arrays = (w.col_idx, w.block_mask)
    else:
        h.update(b"dense")
        h.update(repr(tuple(w.shape)).encode())
        arrays = ()
    for arr in arrays:
        h.update(arr.cpu().numpy().tobytes())
    return h.digest()


def topology_fingerprint(weights: Sequence[Weight]) -> str:
    """Hash of the stack's *topology*: per-layer layout class, shapes and
    index/mask arrays — NOT the stored values. Host-side; each distinct
    layer object is copied to the host and hashed once, so a stack that
    repeats a few phase matrices over many layers costs a few copies."""
    digests: dict[int, bytes] = {}
    h = hashlib.sha1()
    for w in weights:
        if id(w) not in digests:
            digests[id(w)] = _layer_digest(w)
        h.update(digests[id(w)])
    return h.hexdigest()


class PlanKey(NamedTuple):
    """What a plan is keyed on: same topology + width class + residency
    request + semiring + differentiability → the same plan, hence a
    cache hit.

    ``semiring`` is the ⊕.⊗ algebra the plan computes: DNN stack plans
    are ``plus_times``; the GraphBLAS ``mxm``/``mxv`` plans
    (:mod:`repro_torch.plan.mxm`) key theirs here, so a ``plus_times``
    and a ``min_plus`` plan over one topology never collide."""

    fingerprint: str
    width: int
    resident: bool | None  # the use_resident tri-state the caller asked
    semiring: str = "plus_times"  # the plan's ⊕.⊗ algebra
    differentiable: bool = False  # autograd-compatible routes only


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's precomputed execution decisions."""

    layout: str  # execution layout after the waste heuristic
    path: str  # routes.layer_path value, or "fused"/"fused-tiled"
    grid_steps: int  # exact bill at the plan's width
    transpose_plan: BcsrTransposePlan | None = None  # cached backward transpose


@dataclasses.dataclass
class StackPlan:
    """An execution plan for one sparse stack at one width class. The
    plan binds the (frozen) serving weights it was built from."""

    key: PlanKey
    route: str  # routes.ROUTE_FUSED / ROUTE_FUSED_TILED / ROUTE_LAYERED
    layers: tuple[LayerPlan, ...]
    width: int
    grid_steps: int  # exact forward bill for one width-wide panel
    weights: tuple  # execution weights (post-relayout)
    biases: tuple
    source_weights: tuple  # caller's objects — cache identity check
    stacked: tuple | None = None  # (stacked_w, stacked_b) for fused

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def differentiable(self) -> bool:
        """Built for autograd: no fused route, dense layers ``xla-dense``,
        cached transposes on the block-CSR layers."""
        return self.key.differentiable

    @property
    def is_fused_route(self) -> bool:
        """Single-launch whole-stack route (resident or tiled)."""
        return self.route in (_routes.ROUTE_FUSED, _routes.ROUTE_FUSED_TILED)

    @property
    def kernel_launches(self) -> int:
        """Kernel launches one forward of this plan performs."""
        if self.is_fused_route:
            return 1
        return sum(1 for lp in self.layers if lp.path != "xla-dense")

    @property
    def layouts(self) -> tuple[str, ...]:
        return tuple(lp.layout for lp in self.layers)

    @property
    def transpose_plans(self) -> tuple[BcsrTransposePlan | None, ...]:
        return tuple(lp.transpose_plan for lp in self.layers)

    def forward(self, y0: torch.Tensor) -> torch.Tensor:
        """One forward pass of the bound stack over an (m, k) panel,
        k ≤ the plan's width; the panel is padded to the width class."""
        m, k = y0.shape
        if k > self.width:
            raise ValueError(
                f"panel width {k} exceeds this plan's width class "
                f"{self.width}; fetch a plan for the wider class"
            )
        y = F.pad(y0, (0, self.width - k)) if k < self.width else y0
        if self.route == _routes.ROUTE_FUSED:
            y = kernel_ops.fused_mlp_forward(*self.stacked, y)
        elif self.route == _routes.ROUTE_FUSED_TILED:
            y = kernel_ops.fused_mlp_tiled_forward(*self.stacked, y)
        else:
            for lp, w, b in zip(self.layers, self.weights, self.biases):
                if lp.path == "kernel-bcsr":
                    y = kernel_ops.bcsr_spmm(w, y, b, lp.transpose_plan, fuse_bias_relu=True)
                elif lp.path == "kernel-ell":
                    y = kernel_ops.bsr_spmm(w, y, b, fuse_bias_relu=True)
                elif lp.path == "kernel-dense":
                    y = kernel_ops.semiring_matmul(w, y, b, fuse_bias_relu=True)
                else:  # xla-dense: the plain fused form autograd differentiates
                    y = sparse_ops.dense_matmul_fused_relu(w, y, b)
        return y[:, :k]

    def forward_trainable(
        self,
        weights: Sequence[Weight],
        biases: Sequence[torch.Tensor],
        y0: torch.Tensor,
        *,
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Differentiable forward with the caller's (fresh) values: the
        plan lends only its frozen-topology pieces, the cached block-CSR
        transposes, so a train step built on it never sorts again."""
        from repro_torch.core import dnn as _dnn

        if not self.differentiable:
            raise ValueError(
                "forward_trainable needs a differentiable plan; rebuild with "
                "differentiable=True"
            )
        return _dnn.dnn_forward_trainable(weights, biases, y0, use_kernel=use_kernel, plan=self)


def build_plan(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    width: int,
    *,
    use_resident: bool | None = None,
    fingerprint: str | None = None,
    donor: "StackPlan | None" = None,
    differentiable: bool = False,
) -> StackPlan:
    """Build one :class:`StackPlan` (all the per-topology analysis).

    ``use_resident``: None picks a fused route when the stack is
    eligible, True demands one (ValueError when ineligible), False
    forces the layered route — the ``SparseDNNEngine`` tri-state.
    Layered plans apply the ELL→CSR waste heuristic to their bound
    weights.

    ``differentiable``: only routes autograd can go through — never a
    fused one, dense layers ``xla-dense`` — with the caller's layouts
    kept (no relayout, so gradients line up with the caller's weights)
    and each distinct block-CSR layer's transpose sorted here, once.

    ``donor``: a plan for the SAME stack and key at another width class;
    its width-independent pieces (relayouted weights, the fused weight
    stack) are shared by reference, only the bill is rebuilt.
    """
    weights = tuple(weights)
    biases = tuple(biases)
    if len(weights) != len(biases):
        raise ValueError("weights/biases length mismatch")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if fingerprint is None:
        fingerprint = topology_fingerprint(weights)
    key = PlanKey(fingerprint, width, use_resident, differentiable=differentiable)

    fused_ok = None if differentiable else _routes.fused_route(weights)
    if use_resident and fused_ok is None:
        raise ValueError(
            "use_resident=True but the stack is not eligible for the fused "
            "whole-stack kernels "
            + ("(differentiable plans route around them: they have no backward)"
               if differentiable else "(needs a homogeneous square BSR stack)")
        )
    if use_resident is None or use_resident:
        route = fused_ok or _routes.ROUTE_LAYERED
    else:
        route = _routes.ROUTE_LAYERED
    fused_family = route != _routes.ROUTE_LAYERED

    stacked = None
    if donor is not None:
        if donor.key._replace(width=width) != key or donor.n_layers != len(weights):
            raise ValueError("donor plan does not match this stack's plan key")
        route, exec_weights, stacked = donor.route, list(donor.weights), donor.stacked
        layer_plans = [
            dataclasses.replace(lp, grid_steps=_cost.layer_grid_steps(ew, width))
            for lp, ew in zip(donor.layers, exec_weights)
        ]
    else:
        relaid: dict[int, Weight] = {}  # one relayout per distinct layer object
        transposes: dict[int, BcsrTransposePlan] = {}  # one sort per distinct layer object
        exec_weights, layer_plans = [], []
        for w in weights:
            ew = w
            if not fused_family and not differentiable:
                if id(w) not in relaid:
                    relaid[id(w)] = _layout.to_preferred_layout(w)
                ew = relaid[id(w)]
            tp = None
            if differentiable and isinstance(ew, BlockCSRMatrix):
                if id(ew) not in transposes:
                    transposes[id(ew)] = ew.transpose_plan()
                tp = transposes[id(ew)]
            exec_weights.append(ew)
            layer_plans.append(
                LayerPlan(
                    layout=_layout.layer_layout(ew),
                    path=(route if fused_family
                          else _routes.layer_path(ew, differentiable=differentiable)),
                    grid_steps=_cost.layer_grid_steps(ew, width),
                    transpose_plan=tp,
                )
            )
        if fused_family:
            stacked = (stack_bsr(list(exec_weights)), torch.stack(list(biases)))
        elif all(lp.path == "xla-dense" for lp in layer_plans):
            route = _routes.ROUTE_XLA

    return StackPlan(
        key=key,
        route=route,
        layers=tuple(layer_plans),
        width=width,
        grid_steps=sum(lp.grid_steps for lp in layer_plans),
        weights=tuple(exec_weights),
        biases=biases,
        source_weights=weights,
        stacked=stacked,
    )
