"""Dry run on the ``meta`` device — counterpart of ``repro/launch/dryrun.py``:
every (arch × shape × mesh) cell traced with no device memory and no
card, and the roofline inputs written as JSON records.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k --mesh card
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

Where a record differs from the reference's, it says so (``notes``):

* ``bytes_per_device`` is unfused eager traffic, where the reference's
  is HLO ``bytes_accessed`` after fusion.
* One trace per cell; every mesh is derived from it. ``card`` is the
  trace itself on one H100. On the pod meshes the argument and output
  bytes per device come from the specs (each leaf's shard shape), FLOPs
  and eager bytes per device are the card totals over ``chips``,
  ``temp_bytes`` is null (no partitioner places the temporaries) and the
  peak counts arguments and outputs only.
* ``collectives`` and ``t_collective_s`` are null: nothing partitions
  the program, so there are no collectives to count.
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
from repro_torch.distribution.sharding import ShardingRules
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
# the CUDA caching allocator hands out blocks in multiples of 512 bytes
# (``kMinBlockSize``): ``torch.cuda.max_memory_allocated`` counts the blocks
ALLOC_ROUND_BYTES = 512
MESHES = {"card": None, "single": False, "multi": True}  # --mesh → multi_pod; None: one H100
MESH_NAMES = {"card": "card", "single": "pod16x16", "multi": "pod2x16x16"}
NOTES = {
    "bytes": "unfused eager traffic: every aten op's inputs read and outputs written "
             "(the reference: HLO bytes_accessed after fusion)",
    "collectives": "null: no partitioner, so no collectives to count",
    "trace": "one trace on meta; every mesh of the cell is derived from it",
}
POD_NOTE = ("per device: argument and output bytes from the specs' shard shapes; "
            "FLOPs and eager bytes the card totals over chips; temps not placed "
            "(temp_bytes null), so the peak counts arguments and outputs only")


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND_BYTES) * ALLOC_ROUND_BYTES


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors among an op's arguments or results."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _leaf_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a plan's tree (a sparse matrix's tensors included)."""
    return [t for t in checkpoint.leaves(tree) if isinstance(t, torch.Tensor)]


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
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        storages = {t.untyped_storage()._cdata for t in ins}
        view = not func._schema.is_mutable and any(
            t.untyped_storage()._cdata in storages for t in outs)
        if not view and func not in _ALLOC_ONLY:
            read = ins[1:] if func in _WRITE_ONLY else ins
            self.eager_bytes += sum(map(_op_bytes, read)) + sum(map(_op_bytes, outs))
        for t in outs:
            self._add(t)
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


def roofline_terms(*, flops_per_device: float, bytes_per_device: float) -> dict:
    """The reference's roofline terms at the H100's peaks; no collective
    term (see ``NOTES``)."""
    t_compute = flops_per_device / PEAK_FLOPS
    t_memory = bytes_per_device / HBM_BW
    bound = max(t_compute, t_memory)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": None,
        "dominant": "t_compute_s" if t_compute >= t_memory else "t_memory_s",
        "step_time_lower_bound_s": bound,
        "roofline_fraction": t_compute / bound if bound > 0 else 0.0,
        "peaks": {"flops_per_s": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "nvlink_bytes_per_s": NVLINK_BW},
    }


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


def records(arch: str, shape: str, plan: LoweringPlan, t: dict, meshes, *,
            rules: ShardingRules | None = None) -> list[dict]:
    """One record per mesh of ``meshes`` (keys of :data:`MESHES`) from one
    trace ``t`` of ``plan`` (made with ``rules``)."""
    cell = plan.cell
    mf = model_flops(arch, shape, global_batch=cell.global_batch)
    kind = plan.static["kind"]
    donated = kind != "train"
    notes = dict(NOTES)
    notes["donation"] = ("the cache is written in place (donate_cache=True)" if donated else
                         "not honoured: the train step builds new state leaves")
    if plan.model.cfg.sparsity is not None:
        notes["sparsity"] = "traced dense on the plain path, as the plan's init is dense"
    if plan.model.cfg.moe is not None:
        notes["moe"] = ("F.one_hot runs arange and eq on meta, zeros and scatter on a "
                        "device: eager bytes and peak differ from a device run's by those ops")
    base = {"arch": arch, "shape": shape, "kind": kind, "status": "ok",
            "global_batch": cell.global_batch,
            "batch_cut_from": (SHAPE_CELLS[shape].global_batch
                               if cell.global_batch != SHAPE_CELLS[shape].global_batch
                               else None),
            "trace_s": t["trace_s"], "model_flops": mf["model_flops"],
            "n_active_params": mf["n_active"],
            "useful_flops_fraction": mf["model_flops"] / max(t["flops"], 1.0),
            "collectives": None, "static": plan.static, "card": card_info(), "notes": notes}
    out = []
    for name in meshes:
        rec = {**base, "mesh": MESH_NAMES[name]}
        if MESHES[name] is None:
            mem = {k: t[k] for k in ("argument_bytes", "output_bytes", "alias_bytes")}
            mem.update(temp_bytes=t["peak_bytes"] - mem["argument_bytes"] - mem["output_bytes"]
                       + mem["alias_bytes"], peak_per_device_bytes=t["peak_bytes"])
            rec.update(chips=1, flops_per_device=t["flops"], bytes_per_device=t["eager_bytes"],
                       memory=mem)
        else:
            mesh = make_production_mesh(multi_pod=MESHES[name], device="meta")
            chips = mesh.size
            # the specs are the mesh's own: make_plan reads only its shape
            mplan = make_plan(arch, shape, mesh, rules=rules,
                              microbatches=plan.static.get("microbatches"),
                              global_batch=cell.global_batch)
            arg = per_device_bytes(mplan.args, mplan.in_shardings, mesh.shape)
            outb = per_device_bytes(t["out"], mplan.out_shardings, mesh.shape)
            alias = per_device_bytes(mplan.args[2], mplan.in_shardings[2], mesh.shape) \
                if donated else 0
            mem = {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": None,
                   "alias_bytes": alias, "peak_per_device_bytes": arg + outb - alias}
            rec.update(chips=chips, flops_per_device=t["flops"] / chips,
                       bytes_per_device=t["eager_bytes"] / chips, memory=mem,
                       notes={**notes, "per_device": POD_NOTE})
        rec["roofline"] = roofline_terms(flops_per_device=rec["flops_per_device"],
                                         bytes_per_device=rec["bytes_per_device"])
        out.append(rec)
    return out


def run_cell(
    arch: str,
    shape: str,
    *,
    meshes=("card",),
    rules: ShardingRules | None = None,
    microbatches: int | None = None,
    global_batch: int | None = None,
) -> list[dict]:
    """The records of one cell on ``meshes`` from one trace; a skipped
    cell gives a ``skipped`` record a mesh."""
    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    reason = skip_reason(cfg, cell)
    if reason:
        return [{"arch": arch, "shape": shape, "mesh": MESH_NAMES[m], "kind": cell.kind,
                 "status": "skipped", "reason": reason} for m in meshes]
    mesh = make_production_mesh(device="meta")  # the card's trace reads no mesh
    plan = make_plan(arch, shape, mesh, rules=rules, microbatches=microbatches,
                     global_batch=global_batch)
    return records(arch, shape, plan, trace(plan), meshes, rules=rules)


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
                    f" trace={rec['trace_s']:.1f}s"
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
                "-",
                t["dominant"].replace("t_", "").replace("_s", ""),
                f"{t['roofline_fraction']:.2f}",
                f"{r['memory']['peak_per_device_bytes']/2**30:.2f}",
            )
        )


if __name__ == "__main__":
    raise SystemExit(main())
