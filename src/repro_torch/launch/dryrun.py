"""Dry run on the ``meta`` device — counterpart of ``repro/launch/dryrun.py``:
every (arch × shape × mesh) cell traced with no device memory and no
card, and the roofline inputs written as JSON records.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --mesh card
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --summary   # table from saved records

The reference lowers and compiles each cell with XLA and reads the
compiled program's memory and cost analysis. The port has no compiler:
it runs the plan's ``fn`` once on ``meta`` arguments
(``launch.specs.make_plan``) under one :class:`Tracker`, which records

1. FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``'s formulas;
2. peak live bytes: each new storage on the arguments' device counted
   when it is made and released when its ``UntypedStorage`` dies (a
   weakref), starting from the arguments, each storage once (a donated
   cache is written in place and counted once), rounded as the CUDA
   caching allocator rounds a block (:data:`ALLOC_ROUND_BYTES`);
3. eager bytes: every aten op's inputs read and outputs written.

The same :class:`Tracker` run on real tensors gives the same counts, so
a card run of the plan's ``fn`` can be held to the trace
(``chip_smoke.py`` phase ``dryrun``).

A pod record (``pod16x16``, ``pod2x16x16``) comes from the port's own
partitioned program (:func:`mesh_trace`): the plan made for that mesh,
its ``meta`` arguments placed by the plan's ``in_shardings``
(``sharding.place``), and the train step or serve fn run through the
mesh path (``distribution.tensor_parallel``, ``peer``) under the plan's
rules (``sharding.activate``: ``--seq-shard`` gives
``ShardingRules(seq_axis="model")``, which splits the sequence over
``model`` between the tensor-parallel regions) and a
:class:`MeshTracker`, which bills every new storage and every op's FLOPs
and eager bytes to the position the mesh path works for, and every
exchange by the position that sends it, the one that receives it and
the axis it crosses (``peer.link_counts``). That is the counterpart of
what the reference reads from the compiled HLO
(``repro/launch/hlo_analysis.py``): collectives by kind
(``collectives``), temporaries and the peak per device (``memory``), and
a collective time (``roofline.t_collective_s``, also in ``dominant``
and the bound). All groups of a pod do the same work on the same shapes,
so the pod records trace the first :data:`SHORTCUT_GROUPS` groups'
computation and bill the rest by symmetry (``notes.shortcut``); where an
MoE's token groups cross data indices (a decode of one token a row),
each MoE layer runs on group 0, which is traced, and every group's rows
go there and back in full (``moe_gather``, ``moe_return``). What the
mesh path refuses (a batch that does not split into its microbatches) is
a ``refused`` record with its message.

Where a record differs from the reference's, it says so (``notes``):

* ``bytes_per_device`` is unfused eager traffic, where the reference's
  is HLO ``bytes_accessed`` after fusion.
* ``card`` is one trace of the one-card plan on one H100, with no
  collectives (null).
* The port's collectives are not the reference's HLO collectives
  (``notes.collectives``): model-order fan-out and fan-in where the
  reference all-reduces (under ``--seq-shard``, a model-order gather and
  reduce-scatter over the sequence where GSPMD all-gathers and
  reduce-scatters), the MoE combine gathered, a MoE whose token groups
  cross data indices run once on position 0 over every group's rows,
  softmaxes merged per slot range, each group's gradients sent to every
  owner, the logits gathered on position 0.
* The collective time assumes a layout (``notes.layout``,
  :data:`NODE_POSITIONS`, :data:`NETWORK_BW`): it is not a measurement.
* A train cell's state is not donated: the step builds new leaves, and
  the old and new parameters and moments live together at its peak.
* ``F.one_hot`` (the MoE dispatch) runs arange and eq on ``meta`` and
  zeros and scatter on a device: an MoE cell's eager bytes and peak
  differ from a device run's by those ops; its FLOPs do not.

The roofline takes the H100 SXM data sheet's peaks (:data:`PEAK_FLOPS`,
:data:`HBM_BW`, :data:`NVLINK_BW`) for every FLOP and byte, f32 ones
included. The dry run asks for no card; where ``nvidia-smi`` answers,
the record carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPE_CELLS, get_config
from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.distribution.sharding import (
    Placed,
    ShardingRules,
    activate,
    place,
    shardings_for,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    LoweringPlan,
    make_plan,
    model_flops,
    skip_reason,
    train_optimizer,
)
from repro_torch.models.layers import tree_leaves
from repro_torch.train import checkpoint
from repro_torch.train.trainer import TrainState

OUT_DEFAULT = "experiments/dryrun_torch"

# H100 SXM data sheet, at its full 700 W: dense bf16 on the tensor cores,
# HBM3, and NVLink 4 per direction (900 GB/s both ways)
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
# the collective term's layout, assumed: 8 positions to an NVLink node in
# position order (a DGX H100), and between nodes one 400 Gb/s network port
# a card (the DGX H100 data sheet), 50 GB/s a direction
NODE_POSITIONS = 8
NETWORK_BW = 50e9
# the CUDA caching allocator hands out blocks in multiples of 512 bytes
# (``kMinBlockSize``): ``torch.cuda.max_memory_allocated`` counts the blocks
ALLOC_ROUND_BYTES = 512
MESHES = {"card": None, "single": False, "multi": True}  # --mesh → multi_pod; None: one H100
MESH_NAMES = {"card": "card", "single": "pod16x16", "multi": "pod2x16x16"}
NOTES = {
    "bytes": "unfused eager traffic: every aten op's inputs read and outputs written "
             "(the reference: HLO bytes_accessed after fusion)",
    "trace": "the card record: one trace of the one-card plan on meta; each pod record: "
             "one trace of the port's own mesh path over the pod's positions on meta "
             "(mesh_trace), never derived from the card's",
}
CARD_NOTE = "null on one card: no exchange"
MESH_NOTES = {
    "per_device": "by position: each new storage and each op's FLOPs and eager bytes "
                  "billed to the position the mesh path works for (MeshTracker); "
                  "flops/bytes_per_device and collectives are the busiest position's (the "
                  "largest step-time bound), memory the position with the largest peak; "
                  "per_position lists every position",
    "collectives": "the port's exchanges, by kind, where the reference's HLO has its own "
                   "collectives: fan_out and fan_in (copies to each model position and "
                   "model-order sums on the group's home, where the reference all-reduces a "
                   "row-parallel product), under --seq-shard seq_gather and seq_reduce (a "
                   "region's input gathered over the sequence on every model position, its "
                   "partials reduce-scattered onto the sequence chunks in model order, where "
                   "the reference all-gathers and reduce-scatters) and param_copy (a norm's "
                   "scale copied to the chunks' positions), all_gather, scatter, reshard (the "
                   "tied table; the embedding's rows to the sequence chunks), "
                   "regroup (Mamba's in_proj), write, merge (each slot range's partial "
                   "softmax merged on the home, where the reference reduces over cache_seq) "
                   "and replicate (serving's split cache), moe_gather and moe_return (a MoE "
                   "whose token groups cross data indices: each group's rows of its input "
                   "sent to position 0 and its output's rows back, where GSPMD replicates "
                   "such a group over data), gather (each position's FSDP copy "
                   "of its chunks, over data), reduce (each group's gradients sent to every "
                   "owner and added in card order, where the reference reduce-scatters), "
                   "metrics (losses, norms) and logits (gathered on position 0, where the "
                   "reference keeps them sharded). total_bytes: sent plus received; a count: "
                   "the calls the position sends or receives in. Not counted: moves of a "
                   "few values a row (the vocab-parallel loss's row maxima and labels, "
                   "decode positions, the token ids each model position looks up)",
    "layout": "assumed, not measured: 8 positions to an NVLink node in position order, "
              "NVLink 4 at 450 GB/s a direction inside a node, the DGX H100 data sheet's "
              "400 Gb/s network port a card (50 GB/s) between nodes; each axis billed at the "
              "slowest link it crosses; t_collective_s is the sum over axes of max(sent, "
              "received) over that rate",
    "batch": "the batch (serving: the tokens) comes from the host: each group's rows are "
             "copied to its home inside the step, and no position's arguments hold them",
}


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND_BYTES) * ALLOC_ROUND_BYTES


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return out
    for x in (tree.values() if isinstance(tree, dict) else
              tree if isinstance(tree, (list, tuple)) else ()):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            _tensors(x, out)
    return out


def _leaf_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a plan's tree (a sparse matrix's tensors included, a
    placed leaf's chunks)."""
    return [c for t in checkpoint.leaves(tree) for c in getattr(t, "chunks", (t,))
            if isinstance(c, torch.Tensor)]


def _op_bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements, a broadcast
    (stride 0) dim once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n if t.numel() else 0


_aten = torch.ops.aten
# ops that write their first argument without reading it; ops that allocate
# without writing
_WRITE_ONLY = frozenset({_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
                         _aten.zero_.default})
_ALLOC_ONLY = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                         _aten.empty_like.default})


class Tracker(TorchDispatchMode):
    """FLOPs, live bytes, their peak and eager bytes of the ops run under
    it, on the device of ``args`` (``meta``, ``cpu`` or ``cuda``). FLOPs
    are ``FlopCounterMode``'s: its formulas (``flop_registry``) on each
    op. ``FlopCounterMode`` also tries to decompose every op it has no
    formula for; no op of the model cells decomposes, and the tracker,
    which skips that try, runs the trace in about half the time.
    ``tests/test_torch_dryrun.py`` holds the two counts equal."""

    def __init__(self, args, device: torch.device):
        super().__init__()
        self.device_type = torch.device(device).type
        self.live: dict[int, int] = {}
        self.current = self.peak = 0
        self.flops = self.eager_bytes = 0
        self._lock = threading.Lock()
        for t in _leaf_tensors(args):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        with self._lock:
            if key in self.live:
                return
            self.live[key] = _rounded(storage.nbytes())
            self.current += self.live[key]
            self.peak = max(self.peak, self.current)
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            self.current -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return self._run(func, args, kwargs, _tensors((args, kwargs)))

    def _run(self, func, args, kwargs, ins):
        """``func`` on ``args``, counted (``ins``: their tensors)."""
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        storages = {t.untyped_storage()._cdata for t in ins}
        view = not func._schema.is_mutable and any(
            t.untyped_storage()._cdata in storages for t in outs)
        if not view and func not in _ALLOC_ONLY:
            read = ins[1:] if func in _WRITE_ONLY else ins
            self.eager_bytes += sum(map(_op_bytes, read)) + sum(map(_op_bytes, outs))
        for t in outs:
            self._add(t)
        return out


class MeshTracker(Tracker):
    """A :class:`Tracker` that also bills each new storage, and each op's
    FLOPs and eager bytes, to a position of ``mesh`` (all its positions on
    the one device of ``args``): the arguments' placed chunks to their
    positions; an op's outputs to the position the mesh code names around
    it (``peer.at``: its copies, its per-position loops), else to that of
    its largest input the tracker bills, else, for an op with no tensor
    input, to the current group's home (``peer.in_group``). Unplaced
    arguments (the batch, the tokens) and what is made from them alone are
    host work handed to the mesh: the device totals count them, no
    position does. Each position's live bytes and their peak are kept as
    the device's are."""

    def __init__(self, args, mesh):
        n = mesh.size
        self.where: dict[int, int] = {}
        self.untracked: set[int] = set()
        self.pos_current, self.pos_peak = [0] * n, [0] * n
        self.pos_flops, self.pos_eager = [0.0] * n, [0.0] * n
        self._pos: int | None = None
        for leaf in checkpoint.leaves(args):
            if isinstance(leaf, Placed):
                for p, chunk in enumerate(leaf.chunks):
                    self.where.setdefault(chunk.untyped_storage()._cdata, p)
            elif isinstance(leaf, torch.Tensor):
                self.untracked.add(leaf.untyped_storage()._cdata)
        super().__init__(args, mesh.device)

    def _add(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        storage = t.untyped_storage()
        key = storage._cdata
        with self._lock:
            if key in self.live:
                return
            nbytes = self.live[key] = _rounded(storage.nbytes())
            self.current += nbytes
            self.peak = max(self.peak, self.current)
            p = None if key in self.untracked else self.where.get(key, self._pos)
            if p is None:
                self.untracked.add(key)
            else:
                self.where[key] = p
                self.pos_current[p] += nbytes
                self.pos_peak[p] = max(self.pos_peak[p], self.pos_current[p])
        weakref.finalize(storage, self._release, key)

    def _release(self, key: int) -> None:
        with self._lock:
            nbytes = self.live.pop(key)
            self.current -= nbytes
            p = self.where.pop(key, None)
            if p is not None:
                self.pos_current[p] -= nbytes
            self.untracked.discard(key)

    def _position(self, ins) -> int | None:
        best, pos = -1, None
        for t in ins:
            if t.device.type != self.device_type:
                continue
            p = self.where.get(t.untyped_storage()._cdata)
            if p is not None and _op_bytes(t) > best:
                best, pos = _op_bytes(t), p
        if pos is None and ins:
            return None
        named = peer.named_position()
        if named is not None:
            return named
        return pos if pos is not None else (peer.group_position() or 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        self._pos = self._position(ins)
        flops, eager = self.flops, self.eager_bytes
        out = self._run(func, args, kwargs, ins)
        p = self._pos if self._pos is not None else (peer.working_position() or 0)
        self.pos_flops[p] += self.flops - flops
        self.pos_eager[p] += self.eager_bytes - eager
        return out


def live_bytes(tree, device) -> int:
    """The bytes ``tree``'s distinct storages on ``device`` hold, rounded
    as the caching allocator rounds them: what a :class:`Tracker` starts
    from."""
    return Tracker(tree, device).current


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    seen: dict[int, int] = {}
    for t in _leaf_tensors(tree):
        s = t.untyped_storage()
        seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _storage_keys(tree) -> set[int]:
    return {t.untyped_storage()._cdata for t in _leaf_tensors(tree)}


def _device_of(plan: LoweringPlan, args) -> torch.device:
    params = args[0].params if plan.static["kind"] == "train" else args[0]
    return tree_leaves(params)[0].device


def trace(plan: LoweringPlan, args=None) -> dict:
    """Run ``plan.fn`` once on ``args`` (default: the plan's ``meta``
    specs) under a :class:`Tracker`: FLOPs, eager bytes, the peak of live
    bytes, argument, output and alias bytes, the seconds it took, and the
    outputs."""
    args = plan.args if args is None else args
    device = _device_of(plan, args)
    arg_keys = _storage_keys(args)
    t0 = time.monotonic()
    with Tracker(args, device) as tracker:
        out = plan.fn(*args)
    seconds = time.monotonic() - t0
    out_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in _leaf_tensors(out)}
    return {
        "flops": float(tracker.flops),
        "eager_bytes": float(tracker.eager_bytes),
        "peak_bytes": tracker.peak,
        "argument_bytes": _storage_bytes(args),
        "output_bytes": sum(out_storages.values()),
        "alias_bytes": sum(n for k, n in out_storages.items() if k in arg_keys),
        "trace_s": seconds,
        "out": out,
    }


def place_args(plan: LoweringPlan, mesh, args=None) -> tuple:
    """``args`` (default: the plan's ``meta`` specs) placed on ``mesh`` by
    the plan's own ``in_shardings`` (``sharding.place``): a train plan's
    state (its step counter left on the host, as ``trainer.state_shardings``
    leaves it), a serving plan's params and cache. The batch, the tokens
    and the decode position stay as they are: the step hands each group its
    rows."""
    args = plan.args if args is None else args
    kind = plan.static["kind"]
    if kind == "train":
        ss = shardings_for(None, mesh, plan.in_shardings[0])
        ss = ss._replace(opt=ss.opt._replace(step=None))
        return (place(args[0], ss), *args[1:])
    params = place(args[0], shardings_for(None, mesh, plan.in_shardings[0]))
    cache = place(args[2], shardings_for(None, mesh, plan.in_shardings[2]))
    return (params, args[1], cache, *args[3:])


def _chunk_bytes(tree, n: int) -> list[int]:
    """Bytes of the distinct storages of ``tree``'s placed chunks, by
    position."""
    seen: dict[int, tuple[int, int]] = {}
    for leaf in checkpoint.leaves(tree):
        if isinstance(leaf, Placed):
            for p, c in enumerate(leaf.chunks):
                s = c.untyped_storage()
                seen.setdefault(s._cdata, (p, s.nbytes()))
    out = [0] * n
    for p, nbytes in seen.values():
        out[p] += nbytes
    return out


# the exchanges of a group's own computation, each between two of its positions
GROUP_KINDS = ("fan_out", "fan_in", "all_gather", "scatter", "reshard", "regroup", "write",
               "merge", "seq_gather", "seq_reduce", "param_copy")
# the exchanges between groups of a MoE whose token groups cross data indices
CROSS_KINDS = ("moe_gather", "moe_return")
# the groups the pod records trace (``mesh_trace``'s ``groups``)
SHORTCUT_GROUPS = 2


def _by_symmetry(res: dict, mesh, k: int) -> None:
    """A :func:`mesh_trace` of the first ``k`` groups made whole: every
    position of a group that stood in takes the FLOPs, eager bytes and
    peak of the same model index of group ``k - 1``, and that group's
    exchanges between its own positions (:data:`GROUP_KINDS`: its links,
    moved to the group's positions, and its own calls and bytes,
    ``tensor_parallel.group_exchange_counts``); the exchanges between
    groups ran in full. Group 0 may do more (a MoE whose token groups
    cross data indices runs there) and is always traced."""
    m_size = mesh.shape.get("model", 1)
    groups, last = mesh.size // m_size, k - 1
    pos = res["positions"]
    for key in ("flops", "eager_bytes", "peak_bytes"):
        for p in range(k * m_size, mesh.size):
            pos[key][p] = pos[key][last * m_size + p % m_size]
    links = res["links"]
    own = [(key, v) for key, v in links.items() if key[0] in GROUP_KINDS
           and key[1] // m_size == last and key[2] // m_size == last]
    for g in range(k, groups):
        shift = (g - last) * m_size
        for (kind, src, dst), v in own:
            links[kind, src + shift, dst + shift] = dict(v)
    own_calls = res["group_exchanges"].get(last * m_size, {})
    for kind, v in res["exchanges"].items():
        if kind in GROUP_KINDS and kind in own_calls:
            v["calls"] += (groups - k) * own_calls[kind]["calls"]
            v["bytes"] += (groups - k) * own_calls[kind]["bytes"]
    res["flops"], res["eager_bytes"] = sum(pos["flops"]), sum(pos["eager_bytes"])
    res["peak_bytes"] = None


def mesh_trace(plan: LoweringPlan, mesh, args=None, *, groups: int | None = None) -> dict:
    """``plan.fn`` once over ``mesh``, the port's own partitioned program:
    ``args`` (default: the plan's ``meta`` specs) placed by the plan's
    ``in_shardings`` (:func:`place_args`), then run under the plan's rules
    (``sharding.activate``) and a
    :class:`MeshTracker` with every move between positions a copy
    (``peer.distinct_positions``), so each position holds what its card
    would. The plan must be made for ``mesh``'s shape. Returns the device
    totals of :func:`trace` and, by position, FLOPs, eager bytes, the peak
    of live bytes, argument, output and alias bytes, and the exchanges:
    ``links`` (``peer.link_counts``) and ``exchanges``
    (``tensor_parallel.exchange_counts``). The mesh path's refusals raise
    (``ValueError``).

    ``groups``: trace only the first ``groups`` groups' computation
    (``peer.traced_groups``; the others stand in with zeros, and every
    exchange between groups runs) and bill the rest by symmetry
    (:func:`_by_symmetry`); the device's peak is then not traced (None)."""
    placed = place_args(plan, mesh, args)
    n = mesh.size
    n_groups = n // mesh.shape.get("model", 1)
    k = None if groups is None or groups >= n_groups else groups
    arg_keys = _storage_keys(placed)
    tp.reset_exchange_counts()
    peer.reset_link_counts()
    t0 = time.monotonic()
    with activate(mesh, plan.rules), peer.distinct_positions(), peer.traced_groups(k), \
            MeshTracker(placed, mesh) as tracker:
        out = plan.fn(*placed)
    seconds = time.monotonic() - t0
    out_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in _leaf_tensors(out)}
    outs, alias = [0] * n, [0] * n
    for key, nbytes in out_storages.items():
        p = tracker.where.get(key)
        if p is not None:
            outs[p] += nbytes
            alias[p] += nbytes if key in arg_keys else 0
    res = {
        "flops": float(tracker.flops),
        "eager_bytes": float(tracker.eager_bytes),
        "peak_bytes": tracker.peak,
        "argument_bytes": _storage_bytes(placed),
        "output_bytes": sum(out_storages.values()),
        "alias_bytes": sum(b for key, b in out_storages.items() if key in arg_keys),
        "trace_s": seconds,
        "positions": {
            "flops": [float(f) for f in tracker.pos_flops],
            "eager_bytes": [float(b) for b in tracker.pos_eager],
            "peak_bytes": list(tracker.pos_peak),
            "argument_bytes": _chunk_bytes(placed, n),
            "output_bytes": outs,
            "alias_bytes": alias,
        },
        "links": peer.link_counts(),
        "exchanges": tp.exchange_counts(),
        "group_exchanges": tp.group_exchange_counts(),
        "groups": n_groups,
        "traced_groups": k or n_groups,
        "out": out,
    }
    if k is not None:
        _by_symmetry(res, mesh, k)
    return res


def materialize(plan: LoweringPlan, *, device, generator: torch.Generator) -> tuple:
    """Real arguments of ``plan``'s shapes on ``device``: the model's
    parameters drawn from ``generator``, random tokens (or embeddings) and
    labels, a fresh cache (``Model.init_cache``), zero optimizer moments,
    the plan's decode position."""
    model, cell, kind = plan.model, plan.cell, plan.static["kind"]
    cfg = model.cfg
    params = model.init(generator, device=device)

    def like(spec: torch.Tensor) -> torch.Tensor:
        if spec.is_floating_point():
            return torch.randn(spec.shape, generator=generator, device=device).to(spec.dtype)
        return torch.randint(0, cfg.vocab_size, spec.shape, generator=generator,
                             device=device, dtype=spec.dtype)

    if kind == "train":
        state = TrainState(params, train_optimizer().init(checkpoint.leaves(params)))
        return state, {name: like(spec) for name, spec in plan.args[1].items()}
    cache = model.init_cache(cell.global_batch, cell.seq_len, device=device)
    if kind == "prefill":
        return params, like(plan.args[1]), cache
    return params, like(plan.args[1]), cache, plan.args[3].clone()


def card_info() -> dict | None:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    None where there is no ``nvidia-smi`` or it finds no card."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, _, limit = line.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   t_collective_s: float | None = None) -> dict:
    """The reference's roofline terms at the H100's peaks; the collective
    term where the record has one (a mesh's: :func:`collective_seconds`),
    None on one card."""
    terms = {"t_compute_s": flops_per_device / PEAK_FLOPS,
             "t_memory_s": bytes_per_device / HBM_BW}
    if t_collective_s is not None:
        terms["t_collective_s"] = t_collective_s
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    return {
        **terms,
        "t_collective_s": t_collective_s,
        "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "roofline_fraction": terms["t_compute_s"] / bound if bound > 0 else 0.0,
        "peaks": {"flops_per_s": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "nvlink_bytes_per_s": NVLINK_BW, "network_bytes_per_s": NETWORK_BW},
    }


def axis_rates(shape: dict) -> dict[str, float]:
    """Bytes per second a direction of each axis of a mesh of ``shape``
    (row-major positions) under the assumed layout: ``NVLINK_BW`` where
    every pair of positions the axis joins shares a node of
    ``NODE_POSITIONS``, else ``NETWORK_BW``."""
    sizes = list(shape.values())
    n = math.prod(sizes)
    rates = {}
    for i, name in enumerate(shape):
        inner, size = math.prod(sizes[i + 1:]), sizes[i]
        crosses = any(p // NODE_POSITIONS != (p + (j - p // inner % size) * inner)
                      // NODE_POSITIONS for p in range(n) for j in range(size))
        rates[name] = NETWORK_BW if crosses else NVLINK_BW
    return rates


def exchange_bytes(links: dict, shape: dict) -> dict:
    """Each position's exchanges from ``links`` (``peer.link_counts``) on a
    mesh of ``shape``: bytes sent and received by axis, bytes (sent plus
    received) and calls by kind, and its collective seconds
    (:func:`collective_seconds`)."""
    n = math.prod(shape.values())
    sent = [dict.fromkeys(shape, 0) for _ in range(n)]
    recv = [dict.fromkeys(shape, 0) for _ in range(n)]
    kind_bytes = [{} for _ in range(n)]
    kind_calls = [{} for _ in range(n)]
    for (kind, src, dst), v in links.items():
        axis = peer.axis_crossed(shape, src, dst)
        sent[src][axis] += v["bytes"]
        recv[dst][axis] += v["bytes"]
        for p in (src, dst):
            kind_bytes[p][kind] = kind_bytes[p].get(kind, 0) + v["bytes"]
            kind_calls[p][kind] = kind_calls[p].get(kind, 0) + v["calls"]
    rates = axis_rates(shape)
    return {"sent": sent, "received": recv, "kind_bytes": kind_bytes, "kind_calls": kind_calls,
            "t_collective_s": [collective_seconds(sent[p], recv[p], rates) for p in range(n)],
            "rates": rates}


def collective_seconds(sent: dict, received: dict, rates: dict) -> float:
    """The seconds a position's exchanges take at least: each axis's larger
    direction over the axis's rate, the axes one after another."""
    return sum(max(sent[a], received[a]) / rates[a] for a in rates)


def _shard_bytes(leaf: torch.Tensor, spec, mesh_shape: dict) -> int:
    """``leaf``'s bytes on one device of a mesh under ``spec``."""
    n = leaf.element_size()
    for dim, size in enumerate(leaf.shape):
        axes = spec[dim] if dim < len(spec) else None
        for a in (axes if isinstance(axes, tuple) else (axes,)) if axes else ():
            size //= mesh_shape[a]
        n *= size
    return n


def per_device_bytes(tree, specs, mesh_shape: dict) -> int:
    """Bytes of ``tree`` on one device: each leaf's shard under its spec
    (``specs`` in ``tree``'s structure, the leaf order of
    ``checkpoint.leaves``)."""
    return sum(_shard_bytes(leaf, spec, mesh_shape)
               for leaf, spec in zip(checkpoint.leaves(tree), checkpoint.leaves(specs)))


def _base(arch: str, shape: str, plan: LoweringPlan, t: dict,
          rules: ShardingRules | None) -> dict:
    """What every record of a traced cell holds, from one trace ``t``."""
    cell = plan.cell
    mf = model_flops(arch, shape, global_batch=cell.global_batch, config=plan.model.cfg)
    kind = plan.static["kind"]
    notes = dict(NOTES)
    notes["donation"] = ("the cache is written in place (donate_cache=True)" if kind != "train"
                         else "not honoured: the train step builds new state leaves")
    if plan.model.cfg.sparsity is not None:
        notes["sparsity"] = "traced dense on the plain path, as the plan's init is dense"
    if plan.model.cfg.moe is not None:
        notes["moe"] = ("F.one_hot runs arange and eq on meta, zeros and scatter on a "
                        "device: eager bytes and peak differ from a device run's by those ops")
    return {"arch": arch, "shape": shape, "kind": kind, "status": "ok",
            "global_batch": cell.global_batch,
            "batch_cut_from": (SHAPE_CELLS[shape].global_batch
                               if cell.global_batch != SHAPE_CELLS[shape].global_batch
                               else None),
            "trace_s": t["trace_s"], "model_flops": mf["model_flops"],
            "n_active_params": mf["n_active"],
            "useful_flops_fraction": mf["model_flops"] / max(t["flops"], 1.0),
            "static": plan.static, "seq_axis": None if rules is None else rules.seq_axis,
            "card": card_info(), "notes": notes}


def card_record(arch: str, shape: str, plan: LoweringPlan, t: dict, *,
                rules: ShardingRules | None = None) -> dict:
    """The ``card`` record of one trace ``t`` of ``plan`` (:func:`trace`)."""
    rec = _base(arch, shape, plan, t, rules)
    mem = {k: t[k] for k in ("argument_bytes", "output_bytes", "alias_bytes")}
    mem.update(temp_bytes=t["peak_bytes"] - mem["argument_bytes"] - mem["output_bytes"]
               + mem["alias_bytes"], peak_per_device_bytes=t["peak_bytes"])
    rec["notes"]["collectives"] = CARD_NOTE
    rec.update(mesh="card", chips=1, flops_per_device=t["flops"],
               bytes_per_device=t["eager_bytes"], memory=mem, collectives=None,
               roofline=roofline_terms(flops_per_device=t["flops"],
                                       bytes_per_device=t["eager_bytes"]))
    return rec


def mesh_record(arch: str, shape: str, plan: LoweringPlan, mt: dict, mesh, name: str, *,
                rules: ShardingRules | None = None) -> dict:
    """The record of one :func:`mesh_trace` ``mt`` of ``plan`` over ``mesh``
    (named ``name``): the reference's keys from the busiest position (the
    largest step-time bound) and the memory of the position with the
    largest peak, each position's numbers under ``per_position``."""
    rec = _base(arch, shape, plan, mt, rules)
    n, pos = mesh.size, mt["positions"]
    ex = exchange_bytes(mt["links"], mesh.shape)
    terms = [roofline_terms(flops_per_device=pos["flops"][p],
                            bytes_per_device=pos["eager_bytes"][p],
                            t_collective_s=ex["t_collective_s"][p]) for p in range(n)]
    busy = max(range(n), key=lambda p: terms[p]["step_time_lower_bound_s"])
    top = max(range(n), key=lambda p: pos["peak_bytes"][p])
    mem = {k: pos[k][top] for k in ("argument_bytes", "output_bytes", "alias_bytes")}
    mem.update(temp_bytes=pos["peak_bytes"][top] - mem["argument_bytes"]
               - mem["output_bytes"] + mem["alias_bytes"],
               peak_per_device_bytes=pos["peak_bytes"][top], position=top)
    largest = sorted(({"kind": k, "src": src, "dst": dst,
                       "axis": peer.axis_crossed(mesh.shape, src, dst), **v}
                      for (k, src, dst), v in mt["links"].items() if busy in (src, dst)),
                     key=lambda r: -r["bytes"])[:6]
    sent = [sum(d.values()) for d in ex["sent"]]
    received = [sum(d.values()) for d in ex["received"]]
    notes = {**rec["notes"], **MESH_NOTES}
    if mt["traced_groups"] < mt["groups"]:
        notes["shortcut"] = (
            f"traced the computation of groups 0-{mt['traced_groups'] - 1} of "
            f"{mt['groups']} (peer.traced_groups); every other group's positions take group "
            f"{mt['traced_groups'] - 1}'s numbers by symmetry (all groups do the same work on "
            "the same shapes), its exchanges between its own positions moved to them; every "
            "exchange between groups ran in full (tests/test_torch_dryrun_mesh.py holds this "
            "to the full trace)")
    rec.update(
        mesh=name, chips=n, flops_per_device=pos["flops"][busy],
        bytes_per_device=pos["eager_bytes"][busy], memory=mem,
        collectives={"per_kind_bytes": ex["kind_bytes"][busy],
                     "per_kind_count": ex["kind_calls"][busy],
                     "total_bytes": sent[busy] + received[busy],
                     "largest": largest,
                     "moe_links": sorted(
                         ({"kind": k, "src": src, "dst": dst,
                           "axis": peer.axis_crossed(mesh.shape, src, dst), **v}
                          for (k, src, dst), v in mt["links"].items() if k in CROSS_KINDS),
                         key=lambda r: (r["kind"], r["src"], r["dst"])),
                     "per_axis_bytes": {a: ex["sent"][busy][a] + ex["received"][busy][a]
                                        for a in mesh.shape},
                     "position": busy, "exchange_counts": mt["exchanges"]},
        roofline=terms[busy], busiest_position=busy, peak_position=top,
        per_position={"flops": pos["flops"], "eager_bytes": pos["eager_bytes"],
                      "peak_bytes": pos["peak_bytes"], "sent_bytes": sent,
                      "received_bytes": received, "t_collective_s": ex["t_collective_s"]},
        layout={"node_positions": NODE_POSITIONS, "axis_bytes_per_s": ex["rates"]},
        groups=mt["groups"], traced_groups=mt["traced_groups"], notes=notes)
    return rec


def pod_record(arch: str, shape: str, name: str, *, rules: ShardingRules | None = None,
               microbatches: int | None = None, global_batch: int | None = None) -> dict:
    """The record of one cell on a pod mesh (``name``, a key of
    :data:`MESHES`) from :func:`mesh_trace` of the plan made for that
    mesh (its first :data:`SHORTCUT_GROUPS` groups traced), or
    ``refused`` with the mesh path's own message (a batch that does not
    split into its microbatches)."""
    mesh = make_production_mesh(multi_pod=MESHES[name], device="meta")
    plan = make_plan(arch, shape, mesh, rules=rules, microbatches=microbatches,
                     global_batch=global_batch)
    try:
        mt = mesh_trace(plan, mesh, groups=SHORTCUT_GROUPS)
    except ValueError as e:
        return {"arch": arch, "shape": shape, "mesh": MESH_NAMES[name], "kind": plan.cell.kind,
                "status": "refused", "chips": mesh.size, "reason": str(e)}
    return mesh_record(arch, shape, plan, mt, mesh, MESH_NAMES[name], rules=rules)


def run_cell(
    arch: str,
    shape: str,
    *,
    meshes=("card",),
    rules: ShardingRules | None = None,
    microbatches: int | None = None,
    global_batch: int | None = None,
) -> list[dict]:
    """The records of one cell on ``meshes``: the card's from one trace of
    the one-card plan, each pod mesh's from a trace of the mesh path over
    it (:func:`pod_record`); a skipped cell gives a ``skipped`` record a
    mesh."""
    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    reason = skip_reason(cfg, cell)
    if reason:
        return [{"arch": arch, "shape": shape, "mesh": MESH_NAMES[m], "kind": cell.kind,
                 "status": "skipped", "reason": reason} for m in meshes]
    out = []
    for name in meshes:
        if MESHES[name] is not None:
            out.append(pod_record(arch, shape, name, rules=rules, microbatches=microbatches,
                                  global_batch=global_batch))
            continue
        # the card's trace reads no mesh: the plan is made on the production mesh's shape
        plan = make_plan(arch, shape, make_production_mesh(device="meta"), rules=rules,
                         microbatches=microbatches, global_batch=global_batch)
        out.append(card_record(arch, shape, plan, trace(plan), rules=rules))
    return out


def cell_list(which: str):
    for arch in ARCHS:
        for shape in SHAPE_CELLS:
            if which == "all" or which == arch:
                yield arch, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"], default="single")
    ap.add_argument("--out", default=OUT_DEFAULT)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence parallelism: shard the token dim over 'model'")
    ap.add_argument("--summary", action="store_true")
    args = ap.parse_args(argv)

    if args.summary:
        summarize(args.out)
        return 0

    os.makedirs(args.out, exist_ok=True)
    meshes = {"card": ["card"], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.all:
        cells = list(cell_list("all"))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]
    rules = ShardingRules(seq_axis="model") if args.seq_shard else None

    failures = 0
    for arch, shape in cells:
        try:
            recs = run_cell(arch, shape, meshes=meshes, rules=rules,
                            microbatches=args.microbatches)
        except Exception as e:  # noqa: BLE001 — one cell's failure is its record
            recs = [{"arch": arch, "shape": shape, "mesh": MESH_NAMES[m], "status": "error",
                     "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-4000:]} for m in meshes]
            failures += 1
        for rec in recs:
            tag = f"{arch}__{shape}__{rec['mesh']}"
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                r = rec["roofline"]
                extra = (
                    f" dom={r['dominant']}"
                    f" frac={r['roofline_fraction']:.3f}"
                    f" mem={rec['memory']['peak_per_device_bytes']/2**30:.2f}GiB"
                    + (f" coll={rec['collectives']['total_bytes']/2**30:.2f}GiB"
                       if rec["collectives"] else "")
                    + f" trace={rec['trace_s']:.1f}s"
                )
            print(f"[dryrun] {tag}: {rec['status']}{extra}", flush=True)
    return 1 if failures else 0


def summarize(out_dir: str):
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            rows.append(json.load(f))
    fmt = "{:<22s} {:<12s} {:<10s} {:<8s} {:>9s} {:>9s} {:>9s} {:<12s} {:>6s} {:>8s}"
    print(
        fmt.format(
            "arch", "shape", "mesh", "status",
            "t_comp", "t_mem", "t_coll", "dominant", "frac", "GiB/dev",
        )
    )
    for r in rows:
        if r["status"] != "ok":
            print(
                fmt.format(
                    r["arch"], r["shape"], r["mesh"], r["status"],
                    "-", "-", "-", r.get("reason", r.get("error", ""))[:12], "-", "-",
                )
            )
            continue
        t = r["roofline"]
        print(
            fmt.format(
                r["arch"], r["shape"], r["mesh"], r["status"],
                f"{t['t_compute_s']*1e3:.1f}ms",
                f"{t['t_memory_s']*1e3:.1f}ms",
                "-" if t["t_collective_s"] is None else f"{t['t_collective_s']*1e3:.1f}ms",
                t["dominant"].replace("t_", "").replace("_s", ""),
                f"{t['roofline_fraction']:.2f}",
                f"{r['memory']['peak_per_device_bytes']/2**30:.2f}",
            )
        )


if __name__ == "__main__":
    raise SystemExit(main())
