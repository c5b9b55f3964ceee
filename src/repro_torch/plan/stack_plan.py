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
* for a differentiable plan, each sparse layer's cached block-CSR
  transpose (:class:`~repro_torch.sparse.bcsr.BcsrTransposePlan`; for an
  ELL layer, of its stored slots), so no backward sorts the frozen
  topology again.

The reference jits one executable per plan and counts its traces; the
port's executable is a CUDA graph. On a CUDA device a plan's first
``forward`` runs eagerly — the warm-up that builds the kernel libraries,
piece tables, re-tiled blocks and launch geometries, none of which may
be built inside a capture — and then captures the whole forward into a
``torch.cuda.CUDAGraph`` over a static input panel of the plan's width;
every later ``forward`` copies its panel in, replays, and returns a
fresh copy of the graph's output (the next replay overwrites the static
one, and callers keep views of what they were given). ``compile_count``
counts captures. A bound tensor changed in place is seen at the next
``forward``, which warms up and captures again (one more compile).

Plans that stay eager, and say so in :meth:`StackPlan.describe`:

* on the CPU, where the executable is the wrapper loop itself, built
  once (its one compile);
* differentiable plans: autograd records no nodes inside a replayed
  graph, so ``forward`` and :meth:`StackPlan.forward_trainable` run the
  differentiable wrappers eagerly.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.dnn import Weight, stack_bsr
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels.fused_mlp import BLOCK_NS
from repro_torch.kernels import ops as kernel_ops
from repro_torch.plan import cost as _cost
from repro_torch.plan import layout as _layout
from repro_torch.plan import routes as _routes
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix, ell_transpose_plan
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.tensor_cache import cached_on

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


def _hash_arrays(header: bytes, arrays: tuple[torch.Tensor, ...]) -> bytes:
    """SHA-1 of ``header`` and the arrays' bytes: one host copy each."""
    h = hashlib.sha1(header)
    for arr in arrays:
        h.update(arr.cpu().numpy().tobytes())
    return h.digest()


def _layer_digest(w: Weight) -> bytes:
    """One layer's topology digest. It is cached on the index tensors (and
    their in-place versions), so a matrix that the layered loops or
    ``mxm`` meet again costs a dictionary lookup, not a host copy."""
    if isinstance(w, BlockCSRMatrix):
        header = b"bcsr" + repr((w.shape, w.block_shape, w.total_blocks)).encode()
        arrays = (w.row_ptr, w.row_id, w.col_idx, w.valid)
    elif isinstance(w, BlockSparseMatrix):
        header = b"ell" + repr((w.shape, w.block_shape, w.max_blocks_per_row)).encode()
        arrays = (w.col_idx, w.block_mask)
    else:
        return hashlib.sha1(b"dense" + repr(tuple(w.shape)).encode()).digest()
    return cached_on(arrays, ("digest", header), lambda: _hash_arrays(header, arrays))


def topology_fingerprint(weights: Sequence[Weight]) -> str:
    """Hash of the stack's *topology*: per-layer layout class, shapes and
    index/mask arrays — NOT the stored values. Host-side: the index
    arrays of a layer are copied to the host once, the first time they
    are fingerprinted (:func:`_layer_digest`)."""
    digests: dict[int, bytes] = {}
    h = hashlib.sha1()
    for w in weights:
        if id(w) not in digests:
            digests[id(w)] = _layer_digest(w)
        h.update(digests[id(w)])
    return h.hexdigest()


class PlanKey(NamedTuple):
    """What a plan is keyed on: same topology + width class + residency
    request + semiring + differentiability + tuned config + mesh → the
    same plan, hence a cache hit.

    ``semiring`` is the ⊕.⊗ algebra the plan computes: DNN stack plans
    are ``plus_times``; the GraphBLAS ``mxm``/``mxv`` plans
    (:mod:`repro_torch.plan.mxm`) key theirs here, so a ``plus_times``
    and a ``min_plus`` plan over one topology never collide. ``mesh`` is
    the fingerprint of a sharded plan's mesh, so a sharded and a
    single-device plan over one topology never collide either."""

    fingerprint: str
    width: int
    resident: bool | None  # the use_resident tri-state the caller asked
    semiring: str = "plus_times"  # the plan's ⊕.⊗ algebra
    differentiable: bool = False  # autograd-compatible routes only
    tuned: str | None = None  # TunedConfig.token(), None = default constants
    mesh: str | None = None  # plan.sharded.mesh_fingerprint, None = one device unsharded


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's precomputed execution decisions."""

    layout: str  # execution layout after the waste heuristic
    path: str  # routes.layer_path value, or "fused"/"fused-tiled"
    grid_steps: int  # exact bill at the plan's width
    transpose_plan: BcsrTransposePlan | None = None  # cached backward transpose


def graph_kernel_names(graph: "torch.cuda.CUDAGraph") -> list[str]:
    """The device function names of a captured graph's kernel nodes, read
    from the graph through libcuda's graph API: the kernels each replay
    launches, known apart from the wrappers' launch accounting. The graph
    must have been made with ``keep_graph=True``."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")

    def call(fn: str, *args) -> None:
        err = getattr(cu, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} failed with CUresult {err}")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    *[(f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                                   "block_y", "block_z", "shared_bytes")],
                    ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(count))
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node), ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:  # a context-independent kernel handle (lazy module loading)
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return names


class PlanCaptureError(RuntimeError):
    """A plan's forward could not be captured as a CUDA graph: a plan
    compile failure, which the serving ladder records as one."""


def _tensors_of(w) -> tuple[torch.Tensor, ...]:
    """The tensors a captured forward reads of one bound weight."""
    if isinstance(w, BlockCSRMatrix):
        return (w.values, w.row_ptr, w.row_id, w.col_idx, w.valid)
    if isinstance(w, BlockSparseMatrix):
        return (w.blocks, w.col_idx, w.block_mask)
    return (w,)


@dataclasses.dataclass
class _Captured:
    """A plan's forward as a CUDA graph over static panels, the launches its
    capture recorded, and the versions of the bound tensors it read."""

    graph: "torch.cuda.CUDAGraph"
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: kernel_ops.LaunchRecord
    versions: tuple[int, ...]


class CapturedForward:
    """The executable of a plan: its wrapper loop (``_run``), called
    eagerly, or captured as a CUDA graph at the first ``forward`` on the
    card and replayed after. The plan class supplies ``_run``,
    ``_bound_objects`` (what a capture reads), ``in_rows``, ``width``,
    ``route``, ``device``, ``differentiable`` and the counters
    (``calls``, ``replays``, ``warmups``, ``pool``, ``_compiles``,
    ``_captured``, ``_bound``)."""

    @property
    def compile_count(self) -> int:
        """Executables built so far: CUDA graph captures on the card; on
        the CPU or for a differentiable plan, the one eager executable."""
        return self._compiles

    @property
    def eager_because(self) -> str | None:
        """Why this plan runs eagerly, or None when it captures a graph."""
        if self.differentiable:
            return ("differentiable: autograd records no nodes inside a replayed "
                    "CUDA graph")
        if self.device.type != "cuda":
            return f"no CUDA graphs on {self.device.type}: the wrapper loop runs as it is"
        return None

    @property
    def captured_launches(self) -> dict[str, int] | None:
        """Per-kernel launches one replay runs (what the capture recorded)."""
        return None if self._captured is None else dict(self._captured.launches.counts)

    @property
    def graph_launches(self) -> dict[str, int] | None:
        """Per wrapper, the port's kernels among the captured graph's kernel
        nodes (:func:`graph_kernel_names`): what one replay launches, read
        from the graph itself."""
        if self._captured is None:
            return None
        counts = dict.fromkeys(kernel_ops.KERNELS, 0)
        for name in graph_kernel_names(self._captured.graph):
            wrapper = kernel_ops.wrapper_of(name)
            if wrapper is not None:
                counts[wrapper] += 1
        return counts

    def _eager(self, y0: torch.Tensor) -> torch.Tensor:
        k = y0.shape[1]
        y = F.pad(y0, (0, self.width - k)) if k < self.width else y0
        return self._run(y)[:, :k]

    def _bound_versions(self) -> tuple[int, ...]:
        """The in-place versions of every tensor a captured forward reads."""
        if self._bound is None:
            objs = {id(o): o for o in self._bound_objects()}
            self._bound = tuple({id(t): t for o in objs.values() for t in _tensors_of(o)}.values())
        return tuple(t._version for t in self._bound)

    def _capture(self, versions: tuple[int, ...]) -> _Captured:
        """Record :meth:`_run` into a CUDA graph (no kernel runs now)."""
        static_in = torch.zeros((self.in_rows, self.width), dtype=torch.float32,
                                device=self.device)
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for graph_launches
        try:
            with kernel_ops.recording_launches() as launches:
                with torch.cuda.graph(graph, pool=self.pool):
                    static_out = self._run(static_in)
            graph.instantiate()
        except Exception as e:  # noqa: BLE001 — any capture failure is a compile failure
            raise PlanCaptureError(
                f"capturing the {self.route} plan at width {self.width} as a CUDA graph "
                f"failed: {type(e).__name__}: {e}") from e
        return _Captured(graph, static_in, static_out, launches, versions)

    def forward(self, y0: torch.Tensor) -> torch.Tensor:
        """One forward pass of the bound stack over an (m, k) panel,
        k ≤ the plan's width; the panel is padded to the width class.

        On a CUDA device (not differentiable) the first call, and the
        first after a bound tensor changed in place, runs eagerly and
        captures; the others replay. A call that autograd must record
        (grad enabled, and the panel or a bound tensor requires it) runs
        the wrappers eagerly: a replayed graph records no autograd nodes.
        The result is the caller's own tensor either way: a replay returns
        a copy of the graph's output, which the next replay overwrites."""
        m, k = y0.shape
        if k > self.width:
            raise ValueError(
                f"panel width {k} exceeds this plan's width class "
                f"{self.width}; fetch a plan for the wider class"
            )
        self.calls += 1
        if self.eager_because is not None:
            self._compiles = max(self._compiles, 1)  # the eager executable, built once
            return self._eager(y0)
        versions = self._bound_versions()
        if torch.is_grad_enabled() and (y0.requires_grad
                                        or any(t.requires_grad for t in self._bound)):
            return self._eager(y0)
        cap = self._captured
        if cap is None or cap.versions != versions:
            # the warm-up: builds what a capture must find built, and is
            # this call's answer
            self._captured = None
            self.warmups += 1
            out = self._eager(y0)
            self._captured = self._capture(versions)
            self._compiles += 1
            return out
        cap.static_in[:, :k].copy_(y0)
        if k < self.width:
            cap.static_in[:, k:].zero_()
        cap.graph.replay()
        self.replays += 1
        kernel_ops.add_replayed(cap.launches)
        return cap.static_out[:, :k].clone()


@dataclasses.dataclass
class StackPlan(CapturedForward):
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
    tuned: object | None = None  # the TunedConfig the plan was built under
    calls: int = 0  # forwards run
    replays: int = 0  # forwards served by replaying the captured graph
    warmups: int = 0  # eager forwards run before a capture
    # the CUDA graph memory pool of a plan that captures, shared with the
    # plans of this stack at other width classes (build_plan's donor)
    pool: tuple | None = dataclasses.field(default=None, repr=False)
    _compiles: int = 0
    _captured: _Captured | None = dataclasses.field(default=None, repr=False)
    _bound: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def differentiable(self) -> bool:
        """Built for autograd: no fused route, dense layers ``xla-dense``,
        cached transposes on the block-CSR layers."""
        return self.key.differentiable

    @property
    def device(self) -> torch.device:
        return self.biases[0].device

    @property
    def is_fused_route(self) -> bool:
        """Single-launch whole-stack route (resident or tiled)."""
        return self.route in (_routes.ROUTE_FUSED, _routes.ROUTE_FUSED_TILED)

    @property
    def kernel_launches(self) -> int:
        """Kernel launches one forward of this plan performs (the
        reference's ``pallas_calls``)."""
        if self.is_fused_route:
            return 1
        return sum(1 for lp in self.layers if lp.path != "xla-dense")

    @property
    def layouts(self) -> tuple[str, ...]:
        return tuple(lp.layout for lp in self.layers)

    @property
    def transpose_plans(self) -> tuple[BcsrTransposePlan | None, ...]:
        return tuple(lp.transpose_plan for lp in self.layers)

    def describe(self) -> dict:
        """JSON-ready summary: the reference's keys (``kernel_launches`` in
        place of ``pallas_calls``) and the executable's kind."""
        return {
            "fingerprint": self.key.fingerprint[:12],
            "width": self.width,
            "differentiable": self.differentiable,
            "route": self.route,
            "layouts": list(self.layouts),
            "paths": [lp.path for lp in self.layers],
            "grid_steps": self.grid_steps,
            "kernel_launches": self.kernel_launches,
            "cached_transposes": sum(1 for lp in self.layers if lp.transpose_plan is not None),
            "compiles": self.compile_count,
            "calls": self.calls,
            "tuned": self.key.tuned,
            "executable": "eager" if self.eager_because else "cuda-graph",
            "eager_because": self.eager_because,
            "replays": self.replays,
            "warmups": self.warmups,
        }

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    @property
    def block_n(self) -> int:
        """The column tile every wrapper call pads to and the bill counts in."""
        return _tuned_attr(self.tuned, "block_n") or DEFAULT_BLOCK_N

    def _run(self, y: torch.Tensor) -> torch.Tensor:
        """The wrapper loop over a width-wide panel: what a capture records."""
        bn = self.block_n
        if self.is_fused_route:
            fused = (kernel_ops.fused_mlp_forward if self.route == _routes.ROUTE_FUSED
                     else kernel_ops.fused_mlp_tiled_forward)
            return fused(*self.stacked, y, block_n=bn,
                         panel_dtype=_tuned_attr(self.tuned, "panel_dtype"))
        for lp, w, b in zip(self.layers, self.weights, self.biases):
            if lp.path == "kernel-bcsr":
                y = kernel_ops.bcsr_spmm(w, y, b, lp.transpose_plan, fuse_bias_relu=True,
                                         block_n=bn)
            elif lp.path == "kernel-ell":
                y = kernel_ops.bsr_spmm(w, y, b, lp.transpose_plan, fuse_bias_relu=True,
                                        block_n=bn)
            elif lp.path == "kernel-dense":
                y = kernel_ops.semiring_matmul(w, y, b, fuse_bias_relu=True, block_n=bn)
            else:  # xla-dense: the plain fused form autograd differentiates
                y = sparse_ops.dense_matmul_fused_relu(w, y, b)
        return y

    def _bound_objects(self) -> tuple:
        return self.stacked or (*self.weights, *self.biases)

    @property
    def in_rows(self) -> int:
        """Rows of the input panel."""
        return self.weights[0].shape[1]

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
        transposes, so a train step built on it never sorts again. Runs
        eagerly: autograd records no nodes inside a replayed graph."""
        from repro_torch.core import dnn as _dnn

        if not self.differentiable:
            raise ValueError(
                "forward_trainable needs a differentiable plan; rebuild with "
                "differentiable=True"
            )
        return _dnn.dnn_forward_trainable(weights, biases, y0, use_kernel=use_kernel, plan=self)


def _tuned_attr(tuned, name: str):
    """One knob of a TunedConfig-shaped object (None when untuned)."""
    return None if tuned is None else getattr(tuned, name, None)


def _reblock(w: Weight, block_size: int) -> Weight:
    """Re-block a sparse execution weight through its dense form, in its
    own layout family (plan-build time only)."""
    if isinstance(w, (BlockCSRMatrix, BlockSparseMatrix)):
        return type(w).from_dense(w.to_dense(), (block_size, block_size))
    return w


def _force_layout(w: Weight, layout: str) -> Weight:
    """The tuner's override of the ELL-waste heuristic: this sparse
    weight's execution layout forced (a dense weight is kept)."""
    if layout == "bcsr" and isinstance(w, BlockSparseMatrix):
        return BlockCSRMatrix.from_bsr(w)
    if layout == "ell" and isinstance(w, BlockCSRMatrix):
        return w.to_bsr()
    return w


def _transpose_plan(w: Weight) -> BcsrTransposePlan | None:
    """A sparse layer's backward transpose, sorted once (None for dense)."""
    if isinstance(w, BlockCSRMatrix):
        return w.transpose_plan()
    if isinstance(w, BlockSparseMatrix):
        return ell_transpose_plan(w)
    return None


def build_plan(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    width: int,
    *,
    use_resident: bool | None = None,
    relayout: bool | None = None,
    fingerprint: str | None = None,
    donor: "StackPlan | None" = None,
    differentiable: bool = False,
    tuned=None,
) -> StackPlan:
    """Build one :class:`StackPlan` (all the per-topology analysis).

    ``use_resident``: None picks a fused route when the stack is
    eligible, True demands one (ValueError when ineligible), False
    forces the layered route — the ``SparseDNNEngine`` tri-state.
    ``relayout`` applies the ELL→CSR waste heuristic (or the tuned
    layout and block size) to the bound weights of a layered plan:
    default on for inference plans, off for differentiable ones, which
    refuse it (their gradients must line up with the caller's weights).

    ``differentiable``: only routes autograd can go through — never a
    fused one, dense layers ``xla-dense`` — and each distinct sparse
    layer's backward transpose sorted here, once.

    ``donor``: a plan for the SAME stack and key at another width class;
    its width-independent pieces (relayouted weights, the fused weight
    stack, cached transposes, the CUDA graph memory pool) are shared by
    reference, only the bill is rebuilt.

    ``tuned``: a :class:`repro_torch.tune.TunedConfig` read before the
    defaults: ``block_n`` feeds every wrapper call and the bill (the
    column tile the wrappers pad to: 8 or 16, another is refused),
    ``panel_dtype`` and ``vmem_limit_bytes`` (the resident kernel's
    shared-memory budget, at most ``SMEM_LIMIT_BYTES``) move the
    resident↔tiled boundary, ``layout`` overrides the ELL-waste
    heuristic and ``block_size`` re-blocks the layered execution
    weights (shapes the kernels refuse are re-tiled at launch, as any
    other). Its token keys the plan.
    """
    weights = tuple(weights)
    biases = tuple(biases)
    if len(weights) != len(biases):
        raise ValueError("weights/biases length mismatch")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if relayout is None:
        relayout = not differentiable
    if differentiable and relayout:
        raise ValueError(
            "relayout converts bound weights; a differentiable plan must keep the "
            "caller's layouts so gradients line up"
        )
    if fingerprint is None:
        fingerprint = topology_fingerprint(weights)
    key = PlanKey(fingerprint, width, use_resident, differentiable=differentiable,
                  tuned=None if tuned is None else tuned.token())
    block_n = _tuned_attr(tuned, "block_n") or DEFAULT_BLOCK_N
    if block_n not in BLOCK_NS:
        raise ValueError(
            f"block_n={block_n}: the port's wrappers pad panels to column tiles of "
            f"{BLOCK_NS} and bill in them; no launch takes another")
    t_layout = _tuned_attr(tuned, "layout")
    t_block_size = _tuned_attr(tuned, "block_size")

    fused_ok = (None if differentiable or use_resident is False
                else _routes.fused_route(weights, block_n=block_n,
                                         panel_dtype=_tuned_attr(tuned, "panel_dtype"),
                                         smem_limit=_tuned_attr(tuned, "vmem_limit_bytes")))
    if use_resident and fused_ok is None:
        raise ValueError(
            "use_resident=True but the stack is not eligible for the fused "
            "whole-stack kernels "
            + ("(differentiable plans route around them: they have no backward)"
               if differentiable else "(needs a homogeneous square BSR stack)")
        )
    route = fused_ok or _routes.ROUTE_LAYERED
    fused_family = route != _routes.ROUTE_LAYERED

    stacked = None
    if donor is not None:
        if donor.key._replace(width=width) != key or donor.n_layers != len(weights):
            raise ValueError(
                "donor plan does not match this stack's plan key "
                "(fingerprint / residency / differentiable / tuned / layers)")
        route, exec_weights, stacked = donor.route, list(donor.weights), donor.stacked
        pool = donor.pool
        layer_plans = [
            dataclasses.replace(lp, grid_steps=_cost.layer_grid_steps(ew, width,
                                                                      block_n=block_n))
            for lp, ew in zip(donor.layers, exec_weights)
        ]
    else:
        pool = (torch.cuda.graph_pool_handle()
                if biases[0].device.type == "cuda" and not differentiable else None)
        relaid: dict[int, Weight] = {}  # one relayout per distinct layer object
        transposes: dict[int, BcsrTransposePlan | None] = {}  # one sort per distinct layer
        exec_weights, layer_plans = [], []
        for w in weights:
            ew = w
            if not fused_family and relayout:
                if id(w) not in relaid:
                    rw = (_force_layout(w, t_layout) if t_layout is not None
                          else _layout.to_preferred_layout(w))
                    if t_block_size is not None and getattr(rw, "block_shape", (
                            t_block_size,))[0] != t_block_size:
                        rw = _reblock(rw, t_block_size)
                    relaid[id(w)] = rw
                ew = relaid[id(w)]
            tp = None
            if differentiable:
                if id(ew) not in transposes:
                    transposes[id(ew)] = _transpose_plan(ew)
                tp = transposes[id(ew)]
            exec_weights.append(ew)
            layer_plans.append(
                LayerPlan(
                    layout=_layout.layer_layout(ew),
                    path=(route if fused_family
                          else _routes.layer_path(ew, differentiable=differentiable)),
                    grid_steps=_cost.layer_grid_steps(ew, width, block_n=block_n),
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
        tuned=tuned,
        pool=pool,
    )
