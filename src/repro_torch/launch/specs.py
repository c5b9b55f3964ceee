"""Shape-only arguments and the step functions of every (arch × shape) cell —
counterpart of ``repro/launch/specs.py``; the dry run
(``repro_torch.launch.dryrun``) traces these with no device memory.

A ``jax.ShapeDtypeStruct`` is a ``meta`` tensor of the same shape and
dtype here, and ``jax.eval_shape(model.init, ...)`` is
``model.init(device="meta")``. ``input_specs`` mirrors what the data
pipeline or the serving frontend feeds: int32 token ids for LM archs,
bf16 patch/frame embeddings for the VLM/audio stubs, and labels for
train cells.

Two things are not the reference's:

* A decode plan's position is a 0-d int32 tensor on the CPU, not on
  ``meta``: the port reads it on the host (``Model.decode_step``), and
  its value (0 in the plan) picks the slot written, not the work done.
  The optimizer's step counter lies on the CPU as well
  (``train.optimizer.adamw``), so a train plan's state has one CPU leaf.
* ``make_plan`` takes ``global_batch=``, a batch cut that the card's
  memory forces, and the plan keeps the ``model`` and the ``cell`` it
  was built for, so a caller can make real arguments of its shapes
  (``dryrun.materialize``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPE_CELLS, ShapeCell, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.sharding import (
    PartitionSpec,
    ShardingRules,
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
)
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Model, dtype_of
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.trainer import TrainState, make_train_step

P = PartitionSpec
META = torch.device("meta")

# Microbatch counts for train cells (memory lever; global_batch=256).
# 8 is the divisibility ceiling: global_batch 256 / 8 micro = 32 = the
# multi-pod DP-shard count (pod×data); finer microbatching would leave
# per-micro batches unshardable and replicate activations.
DEFAULT_MICROBATCHES = 8
MICROBATCH_OVERRIDES: dict[str, int] = {}


def skip_reason(cfg: ModelConfig, cell: ShapeCell) -> str | None:
    """Assigned skip rules (recorded in the roofline table)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "pure full-attention arch: 500k decode has no sub-quadratic "
            "path (skip per assignment; see DESIGN.md)"
        )
    return None


def _token_spec(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.input_mode == "embeddings":
        return torch.empty((batch, seq, cfg.d_model), dtype=dtype_of(cfg.compute_dtype),
                           device=META)
    return torch.empty((batch, seq), dtype=torch.int32, device=META)


def input_specs(arch: str, shape: str) -> dict[str, Any]:
    """The raw data-batch specs for one cell (train cells)."""
    cfg = get_config(arch)
    cell = SHAPE_CELLS[shape]
    return {
        "inputs": _token_spec(cfg, cell.global_batch, cell.seq_len),
        "labels": torch.empty((cell.global_batch, cell.seq_len), dtype=torch.int32,
                              device=META),
    }


def train_optimizer():
    """The train cells' optimizer, the reference plan's: AdamW on a
    warmup-cosine schedule with bf16 moments."""
    return adamw(warmup_cosine(3e-4, 2000, 100_000), state_dtype=torch.bfloat16)


@dataclasses.dataclass
class LoweringPlan:
    """Everything the dry run needs for one cell: fn, arg specs, shardings."""

    name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple
    static: dict
    model: Model | None = None
    cell: ShapeCell | None = None
    rules: ShardingRules | None = None  # active around ``fn`` on a mesh (``sharding.activate``)


def make_plan(
    arch: str,
    shape: str,
    mesh,
    *,
    rules: ShardingRules | None = None,
    microbatches: int | None = None,
    global_batch: int | None = None,
    config: ModelConfig | None = None,
) -> LoweringPlan:
    """The plan of one cell on ``mesh`` (only ``mesh.shape`` is read).
    ``global_batch`` cuts the cell's batch (None: the cell's own);
    ``config`` is ``arch``'s config cut by the caller (None: its own)."""
    cfg = get_config(arch) if config is None else config
    cell = SHAPE_CELLS[shape]
    reason = skip_reason(cfg, cell)
    if reason:
        raise ValueError(f"cell skipped: {reason}")
    if global_batch is not None:
        cell = dataclasses.replace(cell, global_batch=global_batch)
    rules = rules or ShardingRules()
    model = Model(cfg)

    if cell.kind == "train":
        mb = microbatches or MICROBATCH_OVERRIDES.get(arch, DEFAULT_MICROBATCHES)
        opt = train_optimizer()
        step_fn = make_train_step(model, opt, microbatches=mb)
        params = model.init(device=META)
        state_specs = TrainState(params, opt.init(checkpoint.leaves(params)))
        batch_specs = {
            "inputs": _token_spec(cfg, cell.global_batch, cell.seq_len),
            "labels": torch.empty((cell.global_batch, cell.seq_len), dtype=torch.int32,
                                  device=META),
        }
        # the moments are flat lists here: their specs are the params' own,
        # resolved on the reference's tree (``checkpoint.state_tree``)
        state_ps = checkpoint.state_from_tree(
            param_pspecs(cfg, checkpoint.state_tree(state_specs), mesh, rules))
        batch_ps = tree_map(lambda _: batch_pspecs(mesh, rules)["inputs"], batch_specs)
        metrics_ps = {k: P() for k in ("ce", "moe_aux", "loss", "grad_norm")}
        return LoweringPlan(
            name=f"{arch}/{shape}",
            fn=step_fn,
            args=(state_specs, batch_specs),
            in_shardings=(state_ps, batch_ps),
            out_shardings=(state_ps, metrics_ps),
            donate_argnums=(0,),
            static={"microbatches": mb, "kind": "train"},
            model=model,
            cell=cell,
            rules=rules,
        )

    # serving cells
    prefill_fn, decode_fn = make_serve_fns(model)
    params_specs = model.init(device=META)
    params_ps = param_pspecs(cfg, params_specs, mesh, rules)
    cache_specs = model.init_cache(cell.global_batch, cell.seq_len, device=META)
    cache_ps = cache_pspecs(cfg, cache_specs, mesh, rules)
    dp = tuple(a for a in rules.batch_axes if a in mesh.shape)
    vocab_ax = (
        rules.tp_axis
        if rules.shard_vocab
        and rules.tp_axis in mesh.shape
        and cfg.vocab_size % mesh.shape[rules.tp_axis] == 0
        else None
    )
    bsz = cell.global_batch
    dp_ok = dp if bsz % max(
        1, _prod(mesh.shape[a] for a in dp)
    ) == 0 else ()

    if cell.kind == "prefill":
        tok_specs = _token_spec(cfg, bsz, cell.seq_len)
        logits_ps = P(dp_ok, None, vocab_ax)
        return LoweringPlan(
            name=f"{arch}/{shape}",
            fn=prefill_fn,
            args=(params_specs, tok_specs, cache_specs),
            in_shardings=(params_ps, P(dp_ok, None), cache_ps),
            out_shardings=(logits_ps, cache_ps),
            donate_argnums=(2,),
            static={"kind": "prefill"},
            model=model,
            cell=cell,
            rules=rules,
        )

    # decode: one new token against a full cache
    if cfg.input_mode == "embeddings":
        tok_specs = torch.empty((bsz, 1, cfg.d_model), dtype=dtype_of(cfg.compute_dtype),
                                device=META)
        tok_ps = P(dp_ok, None, None)
    else:
        tok_specs = torch.empty((bsz,), dtype=torch.int32, device=META)
        tok_ps = P(dp_ok)
    pos_specs = torch.zeros((), dtype=torch.int32)
    logits_ps = P(dp_ok, vocab_ax)
    return LoweringPlan(
        name=f"{arch}/{shape}",
        fn=decode_fn,
        args=(params_specs, tok_specs, cache_specs, pos_specs),
        in_shardings=(params_ps, tok_ps, cache_ps, P()),
        out_shardings=(logits_ps, cache_ps),
        donate_argnums=(2,),
        static={"kind": "decode"},
        model=model,
        cell=cell,
        rules=rules,
    )


def _prod(it):
    out = 1
    for x in it:
        out *= x
    return out


def model_flops(arch: str, shape: str, *, global_batch: int | None = None,
                config: ModelConfig | None = None) -> dict[str, float]:
    """MODEL_FLOPS per §Roofline: 6·N·D train, 2·N·D forward-only, with
    N = active non-embedding params and D = tokens processed
    (``global_batch`` and ``config`` as ``make_plan``'s)."""
    cfg = get_config(arch) if config is None else config
    cell = SHAPE_CELLS[shape]
    if global_batch is not None:
        cell = dataclasses.replace(cell, global_batch=global_batch)
    model = Model(cfg)
    n_active = model.active_param_count()
    # exclude embedding + lm head from N (standard 6ND accounting)
    embed = cfg.vocab_size * cfg.d_model
    lm = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    if cfg.input_mode == "embeddings":
        embed = 0
    n = max(n_active - embed - lm, 0)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return {"model_flops": 6.0 * n * tokens, "n_active": float(n)}
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return {"model_flops": 2.0 * n * tokens, "n_active": float(n)}
    tokens = cell.global_batch  # one token per sequence
    return {"model_flops": 2.0 * n * tokens, "n_active": float(n)}
