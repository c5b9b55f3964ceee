"""Mesh-sharded execution plans — counterpart of ``repro/plan/sharded.py``.

A :class:`ShardedStackPlan`:

* partitions every sparse layer's block-CSR segment across the mesh's
  ``row_blocks`` axes with near-equal nnz per shard
  (``repro_torch.sparse.partition``), once per distinct layer object:
  RadiX-net's 120 layers share a few matrices, and so do their
  partitions;
* runs each layer as one ``bcsr_spmm`` launch per shard, without the
  epilogue (each writes its partial rows at their global positions,
  other rows 0), then sums the S partial panels in shard order
  (``z_0 + z_1 + …``, the same order on the CPU and on the card, no
  atomics), then ``relu(z + b)`` — the reference's ``psum`` and
  post-collective epilogue. The sum is done band by band: position c
  owns a band of row blocks (``distribution.sharding.row_bands``), sums
  every shard's rows of it and applies the epilogue to it, and the bands
  are gathered into the next panel on every card;
* bills per shard: a shard's bill is its valid blocks × column tiles
  (the port's block-CSR rule), so the per-shard bills sum to the
  unsharded bill whatever the shard count (the reference's sum to it
  only when S divides nnz; :meth:`ShardedStackPlan.shard_pad_blocks`
  counts the padding slots it bills and the port does not);
* stays differentiable: :meth:`ShardedStackPlan.forward_trainable`
  re-shards fresh values through the frozen partition
  (``ShardedBlockCSR.rescatter_values``, whose backward writes each
  cotangent back to its one source slot) and the backward launches
  ``bcsr_spmm`` on each shard's transpose, sorted once at build.

The reference runs the shards as one SPMD program on a mesh of devices
(``shard_map``); the port runs them from one process, on the one device
of a one-device :class:`~repro_torch.launch.mesh.Mesh` or with shard s
on card s of a multi-card mesh. There each shard's sub-layout (and
backward transpose) is copied to its card once, at build; each card
receives every shard's rows of its band by peer copy
(``repro_torch.distribution.peer``), adds them in shard order and sends
its finished band to every other card: the same elementwise adds in the
same order as on one card, so the same bits. Dense layers run once, on
the home card (position 0), and their panel is sent out. On one device
the "peer copies" are slices, so the CPU runs the same code path.

On a one-device mesh on the card ``forward`` is captured as a CUDA graph
at the first panel of each width class, after an eager warm-up, like
:class:`~repro_torch.plan.StackPlan`; on a multi-card mesh it runs
eagerly (``eager_because``: a capture across cards is not yet shown to
work). ``forward_trainable`` runs eagerly, through the same bands; the
panel reaches the cards through one ``autograd.Function``
(``distribution.peer.spread``) whose backward adds the cards' gradients
in card order, so two backward passes give the same bits.

Sharded plans live in the same :class:`repro_torch.plan.PlanCache` as
single-device plans; :class:`repro_torch.plan.PlanKey` carries the mesh
fingerprint so the two never collide. Entry points:
``repro_torch.core.dnn.dnn_forward(..., mesh=...)``,
``serve.SparseDNNEngine(mesh=...)`` (and the ``ContinuousBatcher``
above it), ``train.make_sparse_train_step(plan=sharded_plan)``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.dnn import Weight
from repro_torch.distribution import peer
from repro_torch.distribution.sharding import (
    mesh_shard_count,
    row_bands,
    row_block_axes,
    shard_device,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.plan import cost as _cost
from repro_torch.plan import layout as _layout
from repro_torch.plan import routes as _routes
from repro_torch.plan.stack_plan import (
    CapturedForward,
    PlanKey,
    _Captured,
    topology_fingerprint,
)
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.sparse.partition import (
    ShardedBlockCSR,
    partition_block_csr,
    place_shard,
    place_shard_transpose,
    stack_transpose_plans,
)


def mesh_fingerprint(mesh, rules=None) -> str:
    """Cache-key component of a mesh's row-block sharding: the resolved
    shard axes, their sizes and the devices. Two meshes with the same
    fingerprint partition a stack identically and run on the same
    devices (a mesh of four cards never shares a key with four positions
    on one)."""
    axes = row_block_axes(mesh, rules)
    inner = ",".join(f"{a}={mesh.shape[a]}" for a in axes)
    devs = ",".join(str(d) for d in mesh.devices)
    return f"row_blocks[{inner or 'replicated'}]@devices[{devs}]"


@dataclasses.dataclass(frozen=True)
class ShardedLayerPlan:
    """One layer's frozen partition artifacts."""

    index: int
    source_layout: str  # the caller's layout ("dense"/"ell"/"bcsr")
    kind: str  # "bcsr" (partitioned) or "dense" (computed once)
    sharded: ShardedBlockCSR | None
    transpose: BcsrTransposePlan | None  # stacked per-shard plans
    grid_steps_per_shard: tuple[int, ...]  # at the plan's width
    # each shard's sub-layout and backward transpose on its card, placed
    # once: the launches' piece tables are cached on these tensors
    shards: tuple[BlockCSRMatrix, ...] = ()
    shard_transposes: tuple[BcsrTransposePlan, ...] = ()
    nnz_per_shard: tuple[int, ...] = ()
    path: str = "kernel-bcsr"  # dense layers: routes.layer_path


@dataclasses.dataclass
class ShardedStackPlan(CapturedForward):
    """A multi-shard execution plan for one sparse stack at one width
    class, with :class:`~repro_torch.plan.StackPlan`'s serving surface
    (``forward``, ``grid_steps``, ``route``, ``kernel_launches``,
    ``compile_count``, ``describe``) and the sharding's
    (``grid_steps_per_shard``, ``nnz_per_shard``, ``imbalance``)."""

    key: PlanKey
    mesh: object  # repro_torch.launch.mesh.Mesh
    axes: tuple[str, ...]  # mesh axes the shard dim spans
    n_shards: int
    layers: tuple[ShardedLayerPlan, ...]
    width: int
    differentiable: bool
    weights: tuple  # per layer: ShardedBlockCSR, or the dense tensor
    biases: tuple
    source_weights: tuple  # the caller's objects — cache identity check
    shard_devices: tuple = ()  # the device each shard launches on (and owns its band on)
    calls: int = 0
    replays: int = 0
    warmups: int = 0
    pool: tuple | None = dataclasses.field(default=None, repr=False)
    _compiles: int = 0
    _captured: _Captured | None = dataclasses.field(default=None, repr=False)
    _bound: tuple | None = dataclasses.field(default=None, repr=False)
    # the unused bias of the partial products, one per (output rows, card)
    _zeros: dict = dataclasses.field(default_factory=dict, repr=False)
    # each band's bias rows on the band's card: (bias, version, rows)
    _band_biases: dict = dataclasses.field(default_factory=dict, repr=False)

    route: str = _routes.ROUTE_SHARDED
    is_sharded: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def device(self) -> torch.device:
        """The home device, where panels come in and answers go out."""
        return self.mesh.device

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The distinct devices the plan runs on, home first."""
        return tuple(dict.fromkeys((self.device, *self.shard_devices)))

    @property
    def eager_because(self) -> str | None:
        if len(self.cards) > 1 and not self.differentiable:
            return (f"a mesh over {len(self.cards)} cards: a CUDA graph capture across "
                    "cards is not yet shown to work (a capture on the home card was "
                    "invalidated: the other cards' streams never joined it), so the "
                    "launches and peer copies run eagerly")
        return super().eager_because

    def bands(self, i: int) -> tuple[slice, ...]:
        """The rows of sparse layer ``i``'s output each position owns in
        the shard-order sum (``row_bands`` of its row blocks)."""
        m, bs_r = self.layers[i].sharded.shape[0], self.layers[i].sharded.block_shape[0]
        return tuple(slice(a * bs_r, b * bs_r) for a, b in row_bands(m // bs_r, self.n_shards))

    @property
    def in_rows(self) -> int:
        return self.weights[0].shape[1]

    @property
    def grid_steps_per_shard(self) -> tuple[int, ...]:
        """Per-shard forward bill (summed over layers) for one panel of
        this plan's width."""
        return tuple(sum(lp.grid_steps_per_shard[s] for lp in self.layers)
                     for s in range(self.n_shards))

    @property
    def grid_steps(self) -> int:
        """Σ of the per-shard bills: the unsharded plan's bill."""
        return sum(self.grid_steps_per_shard)

    @property
    def kernel_launches_per_shard(self) -> int:
        """Launches a shard runs per forward, one per sparse layer (the
        reference's ``pallas_calls``)."""
        return sum(1 for lp in self.layers if lp.kind == "bcsr")

    @property
    def kernel_launches(self) -> int:
        """Kernel launches one forward performs: a ``bcsr_spmm`` per shard
        per sparse layer, and a ``semiring_matmul`` per dense layer
        (computed once, not per shard)."""
        return (self.n_shards * self.kernel_launches_per_shard
                + sum(1 for lp in self.layers if lp.path == "kernel-dense"))

    @property
    def transpose_plans(self) -> tuple[BcsrTransposePlan | None, ...]:
        return tuple(lp.transpose for lp in self.layers)

    def nnz_per_shard(self) -> tuple[int, ...]:
        """Stored blocks per shard, summed over the sparse layers."""
        return tuple(sum(lp.nnz_per_shard[s] for lp in self.layers if lp.kind == "bcsr")
                     for s in range(self.n_shards))

    def imbalance(self) -> float:
        """max-shard-nnz / mean-shard-nnz across the whole stack."""
        nnz = self.nnz_per_shard()
        total = sum(nnz)
        if total == 0:
            return 1.0
        return max(nnz) * self.n_shards / total

    def shard_pad_blocks(self) -> int:
        """Invalid padding slots the common per-shard segment length adds
        over the true nnz (nonzero only when n_shards ∤ a layer's nnz).
        The reference bills them; the port's launches never visit them."""
        return sum(lp.sharded.n_shards * lp.sharded.local_total_blocks - sum(lp.nnz_per_shard)
                   for lp in self.layers if lp.kind == "bcsr")

    def describe(self) -> dict:
        """JSON-ready summary: the reference's keys (``kernel_launches_per_
        shard`` in place of ``pallas_calls``, beside the whole forward's
        ``kernel_launches``) and the executable's kind."""
        return {
            "fingerprint": self.key.fingerprint[:12],
            "mesh": self.key.mesh,
            "shards": self.n_shards,
            "width": self.width,
            "differentiable": self.differentiable,
            "route": self.route,
            "layouts": [lp.kind for lp in self.layers],
            "grid_steps": self.grid_steps,
            "grid_steps_per_shard": list(self.grid_steps_per_shard),
            "nnz_per_shard": list(self.nnz_per_shard()),
            "imbalance": self.imbalance(),
            "shard_pad_blocks": self.shard_pad_blocks(),
            "kernel_launches": self.kernel_launches,
            "kernel_launches_per_shard": self.kernel_launches_per_shard,
            "devices": [str(d) for d in self.shard_devices],
            "cards": len(self.cards),
            "bands": self._describe_bands(),
            "compiles": self.compile_count,
            "calls": self.calls,
            "executable": "eager" if self.eager_because else "cuda-graph",
            "eager_because": self.eager_because,
            "replays": self.replays,
            "warmups": self.warmups,
        }

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------

    def _bound_objects(self) -> tuple:
        return (*(local for lp in self.layers for local in lp.shards),
                *(w for lp, w in zip(self.layers, self.weights) if lp.kind == "dense"),
                *self.biases)

    def _zero_bias(self, rows: int, device: torch.device) -> torch.Tensor:
        key = (rows, device)
        if key not in self._zeros:
            self._zeros[key] = torch.zeros((rows,), dtype=torch.float32, device=device)
        return self._zeros[key]

    def _band_bias(self, b: torch.Tensor, c: int, rows: slice) -> torch.Tensor:
        """Band ``c``'s rows of the bias on its card (a slice on the bias's
        own device; a copy kept per in-place version on another card)."""
        device = self.shard_devices[c]
        if device == b.device:
            return b[rows]
        hit = self._band_biases.get((id(b), c))
        if hit is None or hit[0] is not b or hit[1] != b._version:
            hit = (b, b._version, peer.to(b[rows], device))
            self._band_biases[(id(b), c)] = hit
        return hit[2]

    def _describe_bands(self) -> list:
        """The row blocks each position owns, of the first sparse layer."""
        for i, lp in enumerate(self.layers):
            if lp.kind == "bcsr":
                bs_r = lp.sharded.block_shape[0]
                return [[r.start // bs_r, r.stop // bs_r] for r in self.bands(i)]
        return []

    def scatter(self, y: torch.Tensor, cards=None) -> dict:
        """The home panel ``y`` on every card of ``cards`` (default: all
        the plan's), by card: ``{device: panel}``."""
        return {card: peer.to(y, card) for card in (cards or self.cards)}

    def layer_partials(self, i: int, y) -> list[torch.Tensor]:
        """Sparse layer ``i``'s partial panels over ``y`` (the home panel,
        or one panel a card, ``{device: panel}``): one ``bcsr_spmm`` per
        shard on its card, without the epilogue (rows outside a shard come
        out 0)."""
        lp = self.layers[i]
        if lp.kind != "bcsr":
            raise ValueError(f"layer {i} is {lp.kind}, not partitioned")
        panels = y if isinstance(y, dict) else self.scatter(y)
        rows = lp.shards[0].shape[0]
        return [kernel_ops.bcsr_spmm(local, panels[dev], self._zero_bias(rows, dev))
                for local, dev in zip(lp.shards, self.shard_devices)]

    def _layer(self, i: int, panels: dict, cards) -> dict:
        """Layer ``i`` over one panel a card → its output on every card of
        ``cards``. A sparse layer: the shards' partial panels, each band
        summed in shard order on its owner's card into ``relu(z + b)``,
        the bands sent to the other cards. A dense layer: once, on the
        home card, its panel sent out."""
        lp, w, b = self.layers[i], self.weights[i], self.biases[i]
        if lp.kind != "bcsr":
            y = panels[self.device]
            if lp.path == "kernel-dense":
                out = kernel_ops.semiring_matmul(w, y, b, fuse_bias_relu=True)
            else:
                out = sparse_ops.dense_matmul_fused_relu(w, y, b)
            return self.scatter(out, cards)
        parts = self.layer_partials(i, panels)
        outs = {card: torch.empty(parts[0].shape, dtype=torch.float32, device=card)
                for card in cards}
        bands = []
        for c, (rows, owner) in enumerate(zip(self.bands(i), self.shard_devices)):
            terms = [peer.to(part[rows], owner) for part in parts]
            bands.append(sum_and_relu(terms, self._band_bias(b, c, rows),
                                      out=outs[owner][rows] if owner in outs else None))
        for rows, band in zip(self.bands(i), bands):
            for card, out in outs.items():
                if card != band.device:
                    peer.copy_into(out[rows], band)
        return outs

    def layer_forward(self, i: int, y: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` of the forward over the home panel ``y``: the partial
        panels summed in shard order, then ``relu(z + b)``, on the home
        device; a dense layer runs once."""
        return self._layer(i, self.scatter(y), (self.device,))[self.device]

    def _run(self, y: torch.Tensor) -> torch.Tensor:
        """The layer loop over a width-wide panel: what a capture records.
        Every card holds the panel between layers; the last layer's goes
        home only."""
        panels = self.scatter(y)
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            panels = self._layer(i, panels, (self.device,) if last else self.cards)
        return panels[self.device]

    @staticmethod
    def _spread(bands, rows, cards) -> dict:
        """``peer.spread`` by card (differentiable)."""
        return dict(zip(cards, peer.spread(bands, rows, cards)))

    def forward_trainable(
        self,
        weights: Sequence[Weight],
        biases: Sequence[torch.Tensor],
        y0: torch.Tensor,
        *,
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Differentiable sharded forward with the caller's (fresh) values.
        Each sparse layer's values re-shard through the frozen partition
        (one gather; its backward writes the cotangents back onto the
        caller's layout) and go to their shards' cards; the backward
        launches run per shard on the cached transposes, on the shard's
        card. The panel reaches the cards through ``peer.spread``, whose
        backward adds the cards' gradients in card order.
        ``use_kernel=False`` runs the plain unsharded forms instead (the
        same math). Eager."""
        if not self.differentiable:
            raise ValueError(
                "forward_trainable needs a differentiable plan; rebuild "
                "with differentiable=True"
            )
        if len(weights) != self.n_layers:
            raise ValueError(
                f"plan has {self.n_layers} layers but the stack has {len(weights)}")
        if not use_kernel:
            from repro_torch.core import dnn as _dnn

            y = y0
            for w, b in zip(weights, biases):
                y = _dnn.dnn_layer(w, y, b, fused=True)
            return y
        home = self.device
        panels = self._spread([y0], [slice(0, y0.shape[0])], self.cards)
        for i, (lp, w, b) in enumerate(zip(self.layers, weights, biases)):
            cards = (home,) if i == self.n_layers - 1 else self.cards
            if lp.kind != "bcsr":
                y = sparse_ops.dense_matmul_fused_relu(w, panels[home], b)
                panels = self._spread([y], [slice(0, y.shape[0])], cards)
                continue
            if not isinstance(w, BlockCSRMatrix):
                raise ValueError(
                    "sharded differentiable plans require block-CSR weights; layer "
                    f"{lp.index} is {_layout.layer_layout(w)} (convert with "
                    "BlockCSRMatrix.from_bsr)")
            stacked = lp.sharded.rescatter_values(w.values)
            parts = [kernel_ops.bcsr_spmm(
                dataclasses.replace(local, values=peer.to(stacked[s], dev)), panels[dev], None,
                tp) for s, (local, tp, dev) in enumerate(
                    zip(lp.shards, lp.shard_transposes, self.shard_devices))]
            rows = self.bands(i)
            bands = [sum_and_relu([peer.to(part[r], owner) for part in parts],
                                  peer.to(b[r], owner))
                     for r, owner in zip(rows, self.shard_devices)]
            panels = self._spread(bands, rows, cards)
        return panels[home]


def sum_and_relu(parts: list[torch.Tensor], b: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(z_0 + z_1 + … + b)``: the partial panels (or one band of
    their rows, and the bias's rows of it) summed in shard order, then
    the epilogue; written into ``out`` when given (the same elementwise
    ops, so the same bits; under autograd computed apart and copied in,
    so the result stays differentiable)."""
    z = peer.shard_order_sum(parts)
    if out is not None and torch.is_grad_enabled() and (z.requires_grad or b.requires_grad):
        return out.copy_(sparse_ops.relu(z + b[:, None]))  # autograd refuses ``out=``
    if out is None:
        return sparse_ops.relu(z + b[:, None])
    torch.add(z, b[:, None], out=out)
    return out.relu_()


def build_sharded_plan(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    width: int,
    mesh,
    *,
    differentiable: bool = False,
    use_resident: bool | None = None,
    fingerprint: str | None = None,
    donor: "ShardedStackPlan | None" = None,
) -> ShardedStackPlan:
    """Build one :class:`ShardedStackPlan`: partitions, per-shard
    transposes, bills.

    Layout rules (the reference's): block-CSR layers are partitioned as
    they are; ELL layers are re-laid to block-CSR for inference plans
    and refused for differentiable ones (their gradients must keep the
    caller's layout: convert the stack first); dense layers run once,
    unsharded (``semiring_matmul``, or the plain form when
    differentiable). ``use_resident=True`` is refused: the fused
    whole-stack kernels run one unsharded stack. The weights must be on
    the mesh's (home) device; on a multi-card mesh each shard's
    sub-layout is copied to its card here, once.

    ``donor``: a sharded plan of the same (stack, mesh,
    differentiability) at another width class; its partitions,
    transposes and CUDA graph pool are shared, only the bills are
    rebuilt (``PlanCache.get`` supplies it).
    """
    weights = tuple(weights)
    biases = tuple(biases)
    if len(weights) != len(biases):
        raise ValueError("weights/biases length mismatch")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    if use_resident:
        raise ValueError(
            "use_resident=True is incompatible with mesh sharding: the fused "
            "whole-stack kernels run one unsharded stack; sharded plans always "
            "take the per-shard block-CSR route"
        )
    for i, w in enumerate(weights):
        if w.device != mesh.device:
            raise ValueError(f"layer {i}'s weight is on {w.device}, the mesh's home on "
                             f"{mesh.device}")
    if fingerprint is None:
        fingerprint = topology_fingerprint(weights)
    axes = row_block_axes(mesh)
    n_shards = mesh_shard_count(mesh)
    devices = tuple(shard_device(mesh, s) for s in range(n_shards))
    mesh_fp = mesh_fingerprint(mesh)
    key = PlanKey(fingerprint, width, use_resident, differentiable=differentiable, mesh=mesh_fp)
    if donor is not None and (donor.key._replace(width=width) != key
                              or donor.n_layers != len(weights)):
        raise ValueError(
            "donor plan does not match this stack's plan key "
            "(fingerprint / differentiable / mesh / layers)")

    # one partition (and, differentiable, one set of transposes) per
    # distinct layer object, and one bill each
    parts: dict[int, tuple] = {}
    bills: dict[int, tuple[int, ...]] = {}
    layer_plans, exec_weights = [], []
    for i, w in enumerate(weights):
        src_layout = _layout.layer_layout(w)
        if isinstance(w, BlockSparseMatrix) and differentiable:
            raise ValueError(
                f"sharded differentiable plans require block-CSR weights; layer {i} is "
                "ELL (convert with BlockCSRMatrix.from_bsr so weight gradients keep "
                "the caller's layout)")
        if isinstance(w, (BlockSparseMatrix, BlockCSRMatrix)):
            if id(w) not in parts:
                if donor is not None:
                    d = donor.layers[i]
                    parts[id(w)] = (d.sharded, d.transpose, d.shards, d.shard_transposes,
                                    d.nnz_per_shard)
                else:
                    ew = BlockCSRMatrix.from_bsr(w) if isinstance(w, BlockSparseMatrix) else w
                    sharded = partition_block_csr(ew, n_shards)
                    tp = stack_transpose_plans(sharded) if differentiable else None
                    parts[id(w)] = (
                        sharded, tp, tuple(place_shard(sharded, s, devices[s])
                                           for s in range(n_shards)),
                        () if tp is None else tuple(place_shard_transpose(tp, s, devices[s])
                                                    for s in range(n_shards)),
                        tuple(int(n) for n in sharded.nnz_per_shard()))
                bills[id(w)] = tuple(_cost.layer_grid_steps(local, width)
                                     for local in parts[id(w)][2])
            sharded, tp, shards, shard_tps, nnz = parts[id(w)]
            layer_plans.append(ShardedLayerPlan(i, src_layout, "bcsr", sharded, tp, bills[id(w)],
                                                shards, shard_tps, nnz))
            exec_weights.append(sharded)
        else:  # dense: computed once; its bill lands on the first shard
            bill = _cost.layer_grid_steps(w, width)
            layer_plans.append(ShardedLayerPlan(
                i, src_layout, "dense", None, None, (bill,) + (0,) * (n_shards - 1),
                path=_routes.layer_path(w, differentiable=differentiable)))
            exec_weights.append(w)

    if donor is not None:
        pool = donor.pool
    else:
        pool = (torch.cuda.graph_pool_handle()
                if mesh.device.type == "cuda" and not differentiable
                and len(set(mesh.devices)) == 1 else None)
    return ShardedStackPlan(
        key=key,
        mesh=mesh,
        axes=axes,
        n_shards=n_shards,
        layers=tuple(layer_plans),
        width=width,
        differentiable=differentiable,
        weights=tuple(exec_weights),
        biases=biases,
        source_weights=weights,
        shard_devices=devices,
        pool=pool,
    )
