"""Batched serving engines — counterpart of ``repro/serve/engine.py``.

``Engine`` — the LLM prefill + decode loop with sampling over
``repro_torch.models.Model``. It owns the decode cache (GQA KV, MLA
latents, SSM state — ``Model.init_cache`` per the arch's mixers), casts
the parameters to the compute dtype once, at construction, and runs
``prefill`` then one eager ``decode_step`` a token, in aligned batches.

``SparseDNNEngine`` — the paper's workload as a service, below.

Requests are feature columns. ``submit(cols)`` stages columns,
``step(limit=..., pad_to=...)`` dispatches one right-padded panel over
what is staged, ``drain()`` steps until the stage is empty and
``infer(y0)`` is the one-shot form; the step API is what
``repro_torch.serve.scheduler.ContinuousBatcher`` drives. Every step
fetches a plan for its padded width from the engine's plan cache
through the degradation ladder (sharded → resident → layered) and runs
it: on the card the plan's first panel captures a CUDA graph and later
panels of that width class replay it. Step stats report exact launch
accounting.

Fault handling, as the reference's: a ``fault_injector`` is polled at
the engine's sites (cache-eviction, shard-failure, panel-nans,
plan-compile, step-transient), keyed by the dispatch ordinal; a shard
failure marks the ladder's ``sharded`` level unhealthy, so the panel and
those after it serve one level down; transient step failures
are retried up to ``max_step_retries`` times with exponential backoff on
``clock``; an exhausted panel fails gracefully (``step`` returns
``(None, stats)`` naming the lost request ids); output columns that are
not finite fail only their own request ids (``quarantine_nonfinite``);
a plan whose build or CUDA graph capture fails demotes its ladder level
and the panel is served one level down. ``validate`` checks the weights'
layout invariants once, at construction.

``tuning_table`` (a :class:`~repro_torch.tune.TuningTable`) is
consulted once, at construction, by the stack's topology fingerprint, the
engine's device type as backend and the weights' dtype: a hit threads
the tuned config (``block_n``, forced layout, re-blocking, bf16 panels,
shared-memory budget) into every plan the engine builds and into its
fused-route check; a miss serves the defaults. ``panel_dtype="bfloat16"``
serves the fused routes on bf16 activation panels, on top of any hit
(bf16 panels also move the resident↔tiled boundary).
``differentiable=True`` serves a forward that autograd can go through:
the plans route around the fused kernels (they have no backward) and run
eagerly. ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) serves the
stack sharded (:class:`repro_torch.plan.ShardedStackPlan`): the same
outputs, with per-shard bills in the step stats.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.dnn import Weight
from repro_torch.device import resolve_device, to_device
from repro_torch.distribution import peer
from repro_torch.distribution import sharding as sh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model, cast_floating
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.launch.mesh import normalized_device
from repro_torch.plan import routes as _routes
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.degrade import LEVEL_LAYERED, LEVEL_SHARDED, DegradationLadder
from repro_torch.plan.stack_plan import PlanCaptureError, topology_fingerprint
from repro_torch.serve.clock import WALL_CLOCK
from repro_torch.testing import faults as _faults
from repro_torch.train import checkpoint
from repro_torch.tune.table import TunedConfig, default_backend, panel_dtype_name


def cache_nbytes(cache: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (T=0: argmax, ties to the lower index) or temperature
    sampling over (B, V) logits, drawn from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@dataclasses.dataclass
class Engine:
    """Generate from ``model`` with ``params``, ``batch_size`` prompts at a
    time, into a cache of ``cache_len`` positions. The parameters are
    moved to ``device`` (``None``: the card; without one the constructor
    raises) and cast to the compute dtype once, here; ``Model`` casts
    again for free. Sampling draws from a ``torch.Generator`` seeded from
    ``seed``, which advances across ``generate`` calls."""

    model: Model
    params: Any
    batch_size: int
    cache_len: int
    temperature: float = 0.0
    seed: int = 0
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        moved = tree_map(lambda leaf: leaf.to(self.device), self.params)
        self.params = cast_floating(moved, self.model.compute_dtype)
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)

    def generate(self, prompts: torch.Tensor, max_new_tokens: int) -> tuple[torch.Tensor, dict]:
        """prompts: (B, S_prompt) int (aligned, no padding). Returns the
        (B, max_new_tokens) tokens and the run's counts."""
        b, s = prompts.shape
        if b != self.batch_size:
            raise ValueError(f"{b} prompts for an engine of batch_size {self.batch_size}")
        prompts = prompts.to(self.device)
        cache = self.model.init_cache(b, self.cache_len, device=self.device)
        logits, cache = self.model.prefill(self.params, prompts, cache)
        tok = sample_token(logits[:, -1], self._generator, self.temperature)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(self.params, tok, cache, s + i)
            tok = sample_token(logits, self._generator, self.temperature)
            out.append(tok)
        stats = {
            "prompt_tokens": b * s,
            "generated_tokens": b * max_new_tokens,
            "cache_bytes": cache_nbytes(cache),
        }
        return torch.stack(out, dim=1), stats


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
    ``mesh``: serve sharded over the mesh's shards, with panels and
    answers on the mesh's home device (``device`` defaults to it;
    ``use_resident=True`` is refused, and the sharded level serves
    untuned). ``plan_cache``: the engine's own
    :class:`PlanCache` (max 16) unless one is shared. The fault-handling
    and tuning arguments are the reference's, with its defaults (module
    docstring).
    """

    weights: Sequence[Weight]
    biases: Sequence[torch.Tensor]
    batch_align: int = 64
    use_resident: bool | None = None  # None = auto-detect eligibility
    device: Any = None
    differentiable: bool = False
    mesh: Any = None
    plan_cache: PlanCache | None = None
    fault_injector: Any = None
    max_step_retries: int = 2
    retry_backoff_s: float = 0.0
    quarantine_nonfinite: bool = True
    validate: bool = True
    clock: Any = None
    tuning_table: Any = None
    panel_dtype: Any = None

    def __post_init__(self):
        if self.mesh is not None:
            if self.device is not None and normalized_device(self.device) != self.mesh.device:
                raise ValueError(f"the engine serves on {self.device}, its mesh's shards "
                                 f"on {self.mesh.device}")
            self.device = self.mesh.device
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
        if self.mesh is not None and self.use_resident:
            raise ValueError(
                "use_resident=True is incompatible with mesh=: the fused "
                "whole-stack kernels run one unsharded stack; sharded serving "
                "always takes the per-shard block-CSR route. Pass "
                "use_resident=None/False."
            )
        # Layers that share one matrix object (RadiX-net phases) stay
        # shared: moved, validated and fingerprinted once each.
        moved = to_device((*self.weights, *self.biases), self.device)
        self.weights, self.biases = moved[:self.n_layers], moved[self.n_layers:]
        self._fingerprint = topology_fingerprint(self.weights)
        self._tuned = None
        if self.tuning_table is not None:
            dtype = str(getattr(self.weights[0], "dtype", torch.float32)).removeprefix("torch.")
            self._tuned = self.tuning_table.lookup(
                self._fingerprint, backend=default_backend(self.device), dtype=dtype)
        if self.panel_dtype is not None:
            pdt = panel_dtype_name(self.panel_dtype)
            self._tuned = (TunedConfig(panel_dtype=pdt) if self._tuned is None
                           else dataclasses.replace(self._tuned, panel_dtype=pdt))
        # tuned knobs move the fused boundary: bf16 panels halve the
        # panel's bill, a lower budget tips a stack to fused-tiled
        fused_kw = {}
        if self._tuned is not None:
            fused_kw = {"block_n": self._tuned.block_n or DEFAULT_BLOCK_N,
                        "panel_dtype": self._tuned.panel_dtype,
                        "smem_limit": self._tuned.vmem_limit_bytes}
        resident_ok = (not self.differentiable and self.mesh is None
                       and _routes.fused_route(self.weights, **fused_kw) is not None)
        if self.use_resident and not resident_ok:
            raise ValueError(
                "use_resident=True but the stack is not eligible for the "
                "fused whole-stack kernels (needs a homogeneous square "
                "BSR stack); pass use_resident=None to auto-detect"
            )
        self._resident = (
            resident_ok if self.use_resident is None else self.use_resident
        )
        if self.validate:
            seen = set()
            for i, w in enumerate(self.weights):
                if id(w) not in seen and hasattr(w, "validate"):
                    seen.add(id(w))
                    w.validate(name=f"SparseDNNEngine layer {i} weight")
        if self.plan_cache is None:
            self.plan_cache = PlanCache(max_size=16)
        self._ladder = DegradationLadder(
            self.plan_cache, mesh=self.mesh, use_resident=self._resident, tuned=self._tuned
        )
        self._served = 0
        self._steps = 0
        self._dispatches = 0  # fault sites key on this ordinal
        self._next_rid = 0
        # Staged work as contiguous (request_ids, panel) chunks — a chunk
        # is split only when a step's limit lands inside it.
        self._staged: list[tuple[list, torch.Tensor]] = []
        self._staged_count = 0

    @property
    def ladder(self) -> DegradationLadder:
        """The engine's degradation ladder (health marks, events)."""
        return self._ladder

    @property
    def tuned(self) -> TunedConfig | None:
        """The tuned config this engine serves with (None = defaults)."""
        return self._tuned

    # ------------------------------------------------------------------
    # step-level API
    # ------------------------------------------------------------------

    @property
    def staged(self) -> int:
        """Feature columns submitted but not yet dispatched."""
        return self._staged_count

    @property
    def staged_request_ids(self) -> list:
        return [rid for rids, _ in self._staged for rid in rids]

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
            "failed": False,
            "retries": 0,
            "quarantined_request_ids": [],
        }

    def _plan_for_width(self, width: int, *, step: int = -1, compile_hook=None):
        """(plan, level, cache_hit) serving a ``width``-wide panel at the
        best healthy ladder level."""
        return self._ladder.get_plan(
            self.weights, self.biases, width, differentiable=self.differentiable,
            fingerprint=self._fingerprint, step=step, compile_hook=compile_hook,
        )

    def step(
        self, limit: int | None = None, *, pad_to: int | None = None
    ) -> tuple[torch.Tensor | None, dict]:
        """Dispatch ONE padded forward pass over up to ``limit`` staged
        columns (FIFO). Returns ``(Y[L] (m, batch), stats)``, or
        ``(None, stats)`` when nothing is staged or the panel failed
        (``stats["failed"]``). ``pad_to`` pads the panel further (aligned
        to ``batch_align``) so panels share one width class."""
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

        # ---- fault sites, keyed by the dispatch ordinal
        ordinal = self._dispatches
        self._dispatches += 1
        inj = self.fault_injector
        compile_spec = transient_spec = None
        if inj is not None:
            if inj.fires(_faults.SITE_CACHE_EVICTION, ordinal) is not None:
                self.plan_cache.clear()  # eviction storm: every width builds again
            spec = inj.fires(_faults.SITE_SHARD_FAILURE, ordinal)
            if spec is not None and self.mesh is not None:
                self._ladder.mark_unhealthy(
                    LEVEL_SHARDED, reason=spec.get("reason", "injected shard failure"),
                    step=ordinal)
            spec = inj.fires(_faults.SITE_PANEL_NANS, ordinal)
            if spec is not None:  # poison only real request columns, not the pad
                yp, _ = _faults.poison_panel(yp, limit=batch, rng=inj.rng, **spec)
            compile_spec = inj.fires(_faults.SITE_PLAN_COMPILE, ordinal)
            transient_spec = inj.fires(_faults.SITE_STEP_TRANSIENT, ordinal)
        failures_left = int(transient_spec.get("failures", 1)) if transient_spec else 0

        def compile_hook(level: str) -> None:
            nonlocal compile_spec
            if compile_spec is not None:
                compile_spec = None  # fires once, at the preferred level
                raise _faults.InjectedFault(
                    f"injected plan-compile failure at level {level!r}")

        out = None
        retries = 0
        last_err: Exception | None = None
        plan = level = cache_hit = None
        for attempt in range(self.max_step_retries + 1):
            try:
                plan, level, cache_hit = self._plan_for_width(
                    width, step=ordinal, compile_hook=compile_hook)
                if failures_left > 0:
                    failures_left -= 1
                    raise _faults.TransientFault("injected transient step failure")
                while out is None:
                    try:
                        out = plan.forward(yp)
                    except PlanCaptureError as e:  # a compile failure: one level down
                        if level == LEVEL_LAYERED:
                            raise
                        self._ladder.mark_unhealthy(
                            level, reason=f"{type(e).__name__}: {e}", step=ordinal)
                        plan, level, cache_hit = self._plan_for_width(width, step=ordinal)
                break
            except _faults.TransientFault as e:
                last_err = e
                if attempt >= self.max_step_retries:
                    break
                retries += 1
                if self.retry_backoff_s:
                    (self.clock or WALL_CLOCK).sleep(self.retry_backoff_s * 2**attempt)
            except Exception as e:  # noqa: BLE001 — not retryable
                last_err = e
                break
        if out is None:
            # Graceful panel failure: the batch's requests are lost, the
            # engine (and the requests behind it) live on.
            stats = self._idle_stats()
            stats.update(batch=batch, request_ids=ids, failed=True, retries=retries,
                         error=f"{type(last_err).__name__}: {last_err}")
            return None, stats
        res = out[:, :batch]
        self._served += batch
        self._steps += 1
        quarantined: list = []
        if self.quarantine_nonfinite:
            col_ok = torch.isfinite(res).all(dim=0)
            if not bool(col_ok.all()):
                quarantined = [ids[j] for j in torch.nonzero(~col_ok).flatten().tolist()]
        plan_stats = {
            "width_class": width,
            "cache_hit": cache_hit,
            "route": plan.route,
            "compiles": plan.compile_count,
            "level": level,
            "degraded": level != self._ladder.preferred_level,
            "tuned": plan.key.tuned,
        }
        if getattr(plan, "is_sharded", False):
            # per-shard bills: a shard's valid blocks × column tiles; they
            # sum to plan.grid_steps, the unsharded bill
            plan_stats["shards"] = plan.n_shards
            plan_stats["grid_steps_per_shard"] = list(plan.grid_steps_per_shard)
            plan_stats["devices"] = [str(d) for d in plan.shard_devices]
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
            "plan": plan_stats,
            "failed": False,
            "retries": retries,
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


def make_serve_fns(model: Model):
    """(prefill_fn, decode_fn) of the dry run's serving plans
    (``repro_torch.launch.specs.make_plan``). The reference plan donates
    the cache (``donate_argnums``, XLA updates it in place); here the
    callee may overwrite it: each function writes the cache in place and
    returns the same storages (``donate_cache=True``).

    Over the model's mesh (the reference's plans under their shardings):
    params placed by ``param_pspecs`` and a cache placed by
    ``cache_pspecs`` (``sharding.place``). Each call gathers every group's
    params once (``sharding.group_params``) and runs the groups in data
    order, each on its rows of ``tokens`` (the batch split over ``data``
    when it divides, as the plan's ``dp_ok``; else group 0 runs every row)
    with its view of the cache (``sharding.group_cache``: the placed chunks
    themselves, written in place); the copies of a leaf no group wrote are
    then refreshed (``sharding.sync_replicas``). The logits come back
    concatenated in data order on the mesh's home device, and the cache is
    the placed tree it was given. Where a MoE's token groups would cross
    data indices (``sharding.moe_groups_cross``), the groups run together
    layer by layer (``Model.prefill_groups``/``decode_groups``), each MoE
    layer once on group 0's home over every group's rows, as in the train
    step. Under
    ``ShardingRules(seq_axis="model")`` active around a call
    (``sharding.activate``), a prefill splits its prompt's residual along
    the sequence over each group's positions and writes the cache to the
    slot owners as it does unsplit; a decode step (one token) never
    splits. Unplaced arguments take the one-device path."""

    def prefill_fn(params, tokens, cache):
        if _placed(params):
            return _serve_groups(
                model, params, tokens, cache,
                lambda p, rows, c: model.prefill(p, rows, c, donate_cache=True)[0],
                model.prefill_groups)
        return model.prefill(params, tokens, cache, donate_cache=True)

    def decode_fn(params, token, cache, pos):
        if _placed(params):
            return _serve_groups(
                model, params, token, cache,
                lambda p, rows, c: model.decode_step(p, rows, c, pos, donate_cache=True)[0],
                lambda run, ps, rows, cs: model.decode_groups(run, ps, rows, cs, pos))
        return model.decode_step(params, token, cache, pos, donate_cache=True)

    return prefill_fn, decode_fn


def _placed(params) -> bool:
    return isinstance(checkpoint.leaves(params)[0], sh.Placed)


def _serve_groups(model: Model, params, tokens: torch.Tensor, cache, step, step_groups):
    """``step(group params, group rows, group cache) -> logits`` for each group
    of the mesh the placed ``params`` live on (:func:`make_serve_fns`), or,
    where their MoE token groups cross data indices,
    ``step_groups(run, each group's params, rows, cache) -> each group's
    logits`` over all of them together (``sharding.GroupRun``)."""
    owners = checkpoint.leaves(params)
    mesh = owners[0].sharding.mesh
    m_size = mesh.shape.get("model", 1)
    n = len(mesh.devices) // m_size
    if not all(isinstance(leaf, sh.Placed) and leaf.sharding.mesh == mesh
               for leaf in checkpoint.leaves(cache)):
        raise ValueError("serving over a mesh takes a cache placed on the params' mesh "
                         "(sharding.place by cache_pspecs)")
    rows = tokens.shape[0]
    groups = n if rows % n == 0 else 1
    per = rows // groups
    trees = sh.group_params(params, owners, mesh, groups)

    def rows_of(c):
        return peer.send(tokens.narrow(0, c * per, per), mesh.devices[c * m_size], None,
                         c * m_size)

    # groups that do not cross run one after another, each through the
    # one-group prefill or step: its compute-dtype copy of the params and its
    # temporaries live only for its own call, so positions that share a card
    # (the dry run's mesh cells, sized to the card by that peak) hold one
    # group's at a time
    crossing = sh.moe_groups_cross(model.cfg, {"inputs": tokens.narrow(0, 0, per)}, groups)
    if crossing:
        sent = []
        for c in range(groups):
            with peer.in_group(mesh, c):
                sent.append(rows_of(c))
        got = step_groups(sh.GroupRun(mesh, groups), trees, sent,
                          [sh.group_cache(cache, mesh, c) for c in range(groups)])
    outs = []
    for c in range(groups):
        home = mesh.devices[c * m_size]
        with peer.in_group(mesh, c):
            if crossing:
                logits = got[c]
            else:
                rows_c = rows_of(c)
                logits = (step(trees[c], rows_c, sh.group_cache(cache, mesh, c))
                          if peer.computes(c) else None)
            if logits is None:  # the dry run's shortcut (``peer.traced_groups``)
                with peer.at(c * m_size):
                    logits = torch.zeros(like[0], dtype=like[1], device=home)
            like = (logits.shape, logits.dtype)
            outs.append(peer.send(logits, mesh.device, c * m_size, 0, "logits"))
    sh.sync_replicas(cache, mesh, groups)
    return (outs[0] if groups == 1 else torch.cat(outs, 0)), cache
