"""Layer assembly and period stacking — counterpart of
``repro/models/transformer.py``.

A stack is ``head`` (unique leading layers) + ``n_periods`` repeats of the
``period`` pattern + ``tail``. The parameter tree is the reference's: each
period position's leaves are stacked on a leading ``n_periods`` axis (a
sparse FFN weight as a stacked :class:`BlockSparseMatrix`, index and mask
tensors included). The reference scans the period; the port loops over
it in Python and runs layer ``i`` on views of slice ``i``
(``tree_index``). ``remat`` has no meaning here and is ignored. On the
model's mesh a group's leaves split over ``model`` are
``tensor_parallel.Split``s, split on a dim after the stacked layer dim
(which is never split), so ``tree_index`` takes each position's slice i.
Every mixer and FFN has a split forward (``attention``, ``ssm``,
``moe``, ``layers``), and the cache paths take a group's cache
(``sharding.group_cache``): the attention caches' slots, Mamba's
channels and RWKV-6's heads as ``tensor_parallel.Split``s written in
place, the rest whole on the home device.

Under rules that split the sequence over ``model`` (``ShardingRules(
seq_axis="model")`` active around the call, ``sharding.activate``),
``apply_layer`` and ``prefill_layer`` constrain their input at the
reference's site (``sharding.constrain``): between the tensor-parallel
regions the residual is a ``tensor_parallel.Split`` along the sequence,
and the norms, post-norms and residual adds run on each position's chunk
(:func:`_norm`, :func:`_add`); each region takes it in by
a gather and hands it back by a reduce-scatter. ``decode_layer``
(S = 1) never splits.

Three execution paths per layer, all cache-structure compatible:
  * ``apply_layer``   — forward without a cache; returns (x, aux_loss)
  * ``prefill_layer`` — forward that also fills the decode cache
  * ``decode_layer``  — single-token step against the cache

The cache paths return a new cache and leave the caller's as it was;
with ``donate=True`` they write into the caller's tensors (a period
layer's cache through its ``tree_index`` views of the stacked buffers)
and return a tree of those same tensors, the same values.

Every path walks one layer list (:func:`layer_list`) and runs each
layer through one generator (:func:`_layer`), which hands a MoE FFN's
input to its caller. Where the data indices' MoE token groups cross
(``sharding.moe_groups_cross``), the groups of one call run layer by
layer (:func:`stack_groups`): each group's layer up to its MoE, the MoE
once over every group's rows on the first group's home, then each
group's layer to its end.

The paper's technique enters through ``ffn`` weights: any FFN projection
may be sparse (``layers.linear`` dispatch, ``sparsify_stack``), and the
``relu_mlp`` layer kind *is* the paper's Fig. 4 layer. ``use_kernel``
goes to every ``linear`` (``None``: the SpMM kernels on the card).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.distribution import peer, sharding
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    Init,
    apply_ffn,
    dense_init,
    init_ffn,
    init_rms_norm,
    linear,
    rms_norm,
    sparsify_ffn,
    tree_index,
    tree_map,
    tree_stack,
)

Params = dict[str, Any]


# =============================== single layer ================================


def init_layer(rng: Init, cfg: ModelConfig, spec: LayerSpec, dtype=torch.float32) -> Params:
    p: Params = {}
    d = cfg.d_model
    if spec.mixer == "attn":
        p["mixer_norm"] = init_rms_norm(rng, d)
        p["mixer"] = attn.INIT[cfg.attention.kind](rng, cfg.attention, d, dtype)
        if cfg.post_norms:
            p["mixer_post_norm"] = init_rms_norm(rng, d)
    elif spec.mixer == "mamba":
        p["mixer_norm"] = init_rms_norm(rng, d)
        p["mixer"] = ssm.init_mamba(rng, d, cfg.mamba, dtype)
    elif spec.mixer == "rwkv":
        p["mixer_norm"] = init_rms_norm(rng, d)
        p["mixer"] = ssm.init_rwkv_time_mix(rng, d, cfg.rwkv, dtype)
    elif spec.mixer != "none":
        raise ValueError(f"unknown mixer {spec.mixer!r}")

    if spec.ffn == "dense":
        p["ffn_norm"] = init_rms_norm(rng, d)
        p["ffn"] = init_ffn(rng, d, cfg.d_ff, cfg.glu, dtype)
        if cfg.post_norms:
            p["ffn_post_norm"] = init_rms_norm(rng, d)
    elif spec.ffn == "moe":
        p["ffn_norm"] = init_rms_norm(rng, d)
        p["ffn"] = moe_mod.init_moe(rng, d, cfg.moe, cfg.glu, dtype)
    elif spec.ffn == "rwkv_channel_mix":
        p["ffn_norm"] = init_rms_norm(rng, d)
        p["ffn"] = ssm.init_rwkv_channel_mix(rng, d, cfg.d_ff, dtype)
    elif spec.ffn == "relu_mlp":
        # The paper's layer: square weight + bias, no norm, no residual.
        p["ffn"] = {"w": dense_init(rng, d, d, dtype), "b": rng.zeros((d,), dtype)}
    elif spec.ffn != "none":
        raise ValueError(f"unknown ffn {spec.ffn!r}")
    return p


_SEQ = ("batch", "seq", None)  # the residual's logical axes (the reference's constraint)


def _norm(x, scale: torch.Tensor, eps: float):
    """``rms_norm`` of the residual: on each chunk of a sequence split, with
    the scale (whole on the home) copied to the chunks' positions, its
    gradient the chunks' partials added in model order."""
    if isinstance(x, tp.Split):
        scales = tp.fan_out(scale, x.devices, kind="param_copy")
        return tp.Split(tuple(rms_norm(c, s, eps) for c, s in zip(x.chunks, scales)), x.dim)
    return rms_norm(x, scale, eps)


def _add(x, y):
    """The residual add, chunk by chunk on a sequence split."""
    if isinstance(x, tp.Split):
        return tp.Split(tuple(a + b for a, b in zip(x.chunks, y.chunks)), x.dim)
    return x + y


def _relu_mlp(f: Params, x, use_kernel):
    """The paper's Fig. 4 layer: max(x W + b, 0). With ``w`` and ``b``
    split over ``model`` (output columns), each position computes its
    columns, ReLU is local, and the next layer's input is their
    concatenation in model order on ``x``'s device (for ``x`` split along
    the sequence: resharded from columns to the sequence). A sparse ``w`` is
    whole and runs where ``x`` is, with ``b`` gathered there."""
    w, b = f["w"], f["b"]
    if isinstance(w, tp.Split):
        xs = tp.region_input(x, w.devices)
        cols = [_relu_mlp({"w": w.chunks[m], "b": b.chunks[m]}, xs[m], use_kernel)
                for m in range(len(xs))]
        if isinstance(x, tp.Split):
            return tp.Split(tp.reshard(cols, -1, x.dim), x.dim)
        return tp.all_gather(cols, -1, x.device)
    if isinstance(b, tp.Split):
        b = tp.all_gather(b.chunks, 0, x.device)
    return tp.on_home(lambda h: torch.clamp_min(linear(w, h, use_kernel=use_kernel) + b, 0.0), x)


def _apply_mixer(p: Params, cfg: ModelConfig, spec: LayerSpec, x):
    h = _norm(x, p["mixer_norm"], cfg.norm_eps)
    if spec.mixer == "attn":
        out = attn.APPLY[cfg.attention.kind](p["mixer"], cfg.attention, h, window=spec.window,
                                             rope_theta=spec.rope_theta)
    elif spec.mixer == "mamba":
        out, _ = ssm.apply_mamba(p["mixer"], cfg.mamba, h)
    else:  # rwkv
        out, _ = ssm.apply_rwkv_time_mix(p["mixer"], cfg.rwkv, h)
    if cfg.post_norms:
        out = _norm(out, p["mixer_post_norm"], cfg.norm_eps)
    return _add(x, out)


def _apply_ffn_block(p: Params, cfg: ModelConfig, spec: LayerSpec, x, use_kernel):
    """The FFN block, a generator (:func:`_layer`): a MoE yields its normed
    input and is sent back its (output, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "relu_mlp":
        return _relu_mlp(p["ffn"], x, use_kernel), aux
    h = _norm(x, p["ffn_norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        out = apply_ffn(p["ffn"], h, cfg.act, cfg.glu, use_kernel=use_kernel)
    elif spec.ffn == "moe":
        out, aux = yield h
    else:  # rwkv_channel_mix
        out, _ = ssm.apply_rwkv_channel_mix(p["ffn"], h)
    return _ffn_out(p, cfg, x, out), aux


def _ffn_out(p: Params, cfg: ModelConfig, x, out):
    """An FFN block's output ``out`` post-normed and added to the residual."""
    if cfg.post_norms:
        out = _norm(out, p["ffn_post_norm"], cfg.norm_eps)
    return _add(x, out)


def apply_layer(
    p: Params, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, *,
    use_kernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (x, moe_aux_loss)."""
    x, _, aux = _finish(_layer(p, cfg, spec, x, None, None, decode=False, donate=False,
                               use_kernel=use_kernel), p, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux


def _layer(p: Params, cfg: ModelConfig, spec: LayerSpec, x, cache: Params | None,
           pos: int | None, *, decode: bool, donate: bool, use_kernel):
    """One layer, the mixer then the FFN block, as a generator: a MoE FFN
    yields its normed input and is sent back its (output, aux), so that
    :func:`stack_groups` can run the MoE of several groups' layers at once.
    Without ``cache`` the full-sequence forward (:func:`apply_layer`), with
    it the prefill's or, ``decode``, the step's at ``pos``. Returns (x, the
    layer's new cache (None without ``cache``), the MoE aux loss or None)."""
    if not decode:
        x = sharding.constrain(x, _SEQ)
    new, aux = cache, None
    if spec.mixer != "none" and cache is None:
        x = _apply_mixer(p, cfg, spec, x)
    elif spec.mixer != "none":
        x, new = _mixer_with_cache(p, cfg, spec, x, new, pos, decode=decode, donate=donate)
    if spec.ffn != "none" and cache is None:
        x, aux = yield from _apply_ffn_block(p, cfg, spec, x, use_kernel)
    elif spec.ffn != "none":
        x, new = yield from _ffn_with_cache(p, cfg, spec, x, new, decode=decode, donate=donate,
                                            use_kernel=use_kernel)
    return x, new, aux


def _finish(steps, p: Params, cfg: ModelConfig):
    """Run a layer's generator (:func:`_layer`) to its end, its MoE FFN, if
    any, by ``moe.apply_moe`` of its own rows."""
    try:
        h = next(steps)
        while True:
            h = steps.send(moe_mod.apply_moe(p["ffn"], cfg.moe, h, cfg.act, cfg.glu))
    except StopIteration as done:
        return done.value


# ------------------------------- caches --------------------------------------


def init_layer_cache(
    cfg: ModelConfig,
    spec: LayerSpec,
    batch: int,
    cache_len: int,
    dtype,
    device=None,
) -> Params:
    c: Params = {}
    d = cfg.d_model
    if spec.mixer == "attn":
        c["attn"] = attn.INIT_CACHE[cfg.attention.kind](cfg.attention, batch, cache_len,
                                                        spec.window, dtype, device)
    elif spec.mixer == "mamba":
        di = cfg.mamba.expand * d
        c["mamba"] = {
            "conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, cfg.mamba.d_state), dtype=torch.float32,
                               device=device),
        }
    elif spec.mixer == "rwkv":
        hd = cfg.rwkv.head_dim
        c["rwkv"] = {
            "shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
        }
    if spec.ffn == "rwkv_channel_mix":
        c["cmix"] = {"shift": torch.zeros((batch, d), dtype=dtype, device=device)}
    return c


def _mixer_with_cache(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    cache: Params,
    pos: int | None,
    *,
    decode: bool,
    donate: bool,
) -> tuple[torch.Tensor, Params]:
    h = _norm(x, p["mixer_norm"], cfg.norm_eps)
    new = dict(cache)
    if spec.mixer == "attn":
        kind = cfg.attention.kind
        if decode:
            out, new["attn"] = attn.DECODE[kind](p["mixer"], cfg.attention, h, cache["attn"],
                                                 pos, window=spec.window,
                                                 rope_theta=spec.rope_theta, donate=donate)
        else:
            out, new["attn"] = attn.PREFILL[kind](p["mixer"], cfg.attention, h, cache["attn"],
                                                  window=spec.window,
                                                  rope_theta=spec.rope_theta, donate=donate)
    elif spec.mixer == "mamba":
        state = cache["mamba"] if decode else None
        out, state = ssm.apply_mamba(p["mixer"], cfg.mamba, h, state)
        new["mamba"] = _store(cache["mamba"], state, donate)
    else:  # rwkv
        state = cache["rwkv"] if decode else None
        out, state = ssm.apply_rwkv_time_mix(p["mixer"], cfg.rwkv, h, state)
        new["rwkv"] = _store(cache["rwkv"], state, donate)
    if cfg.post_norms:
        out = _norm(out, p["mixer_post_norm"], cfg.norm_eps)
    return _add(x, out), new


def _store(buf: Params, state: Params, donate: bool) -> Params:
    """A recurrent layer's new ``state``, or, when ``donate``, the
    caller's ``buf`` with the state's values copied into its tensors (a
    group's split state chunk by chunk, each on its position)."""
    if not donate:
        return state

    def put(dst, value):
        if isinstance(dst, tp.Split):
            for d, v in zip(dst.chunks, value.chunks):
                d.copy_(v)
            return dst
        return dst.copy_(value)

    return {name: put(buf[name], value) for name, value in state.items()}


def _ffn_with_cache(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    cache: Params,
    *,
    decode: bool,
    donate: bool,
    use_kernel,
):
    """The FFN block with a cache, a generator as :func:`_apply_ffn_block`:
    returns (x, the new cache)."""
    new = dict(cache)
    if spec.ffn == "relu_mlp":
        return _relu_mlp(p["ffn"], x, use_kernel), new
    h = _norm(x, p["ffn_norm"], cfg.norm_eps)
    if spec.ffn == "dense":
        out = apply_ffn(p["ffn"], h, cfg.act, cfg.glu, use_kernel=use_kernel)
    elif spec.ffn == "moe":
        out, _ = yield h
    else:  # rwkv_channel_mix (stateful token shift)
        state = cache["cmix"] if decode else None
        out, state = ssm.apply_rwkv_channel_mix(p["ffn"], h, state)
        new["cmix"] = _store(cache["cmix"], state, donate)
    return _ffn_out(p, cfg, x, out), new


def prefill_layer(
    p: Params, cfg: ModelConfig, spec: LayerSpec, x: torch.Tensor, cache: Params, *,
    use_kernel: bool | None = None, donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    x, new, _ = _finish(_layer(p, cfg, spec, x, cache, None, decode=False, donate=donate,
                               use_kernel=use_kernel), p, cfg)
    return x, new


def decode_layer(
    p: Params,
    cfg: ModelConfig,
    spec: LayerSpec,
    x: torch.Tensor,
    cache: Params,
    pos: int,
    *,
    use_kernel: bool | None = None,
    donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    x, new, _ = _finish(_layer(p, cfg, spec, x, cache, pos, decode=True, donate=donate,
                               use_kernel=use_kernel), p, cfg)
    return x, new


# ============================ stacked execution ==============================


def init_stack(rng: Init, cfg: ModelConfig, dtype=torch.float32) -> Params:
    """Parameters for head + stacked period + tail."""
    stacked = rng.stacked(cfg.n_periods)
    return {
        "head": [init_layer(rng, cfg, s, dtype) for s in cfg.head],
        "period": [init_layer(stacked, cfg, s, dtype) for s in cfg.period],
        "tail": [init_layer(rng, cfg, s, dtype) for s in cfg.tail],
    }


def init_stack_cache(
    cfg: ModelConfig, batch: int, cache_len: int, dtype, device=None
) -> Params:
    def one(spec):
        return init_layer_cache(cfg, spec, batch, cache_len, dtype, device)

    period = [tree_map(lambda a: a.expand((cfg.n_periods,) + a.shape).clone(), one(spec))
              for spec in cfg.period]
    return {
        "head": [one(s) for s in cfg.head],
        "period": period,
        "tail": [one(s) for s in cfg.tail],
    }


def layer_list(p: Params, cfg: ModelConfig, cache: Params | None = None) -> list[tuple]:
    """Each layer of the stack in order, ``(params, spec, cache)``: head, the
    period's layers for each period (views of slice i, :func:`tree_index`),
    tail; the cache None without ``cache``."""
    def part(name: str, specs, i: int | None = None) -> list[tuple]:
        caches = [None] * len(specs) if cache is None else cache[name]
        at = (lambda t: t) if i is None else (lambda t: None if t is None else tree_index(t, i))
        return [(at(lp), spec, at(c)) for lp, spec, c in zip(p[name], specs, caches)]

    layers = part("head", cfg.head)
    for i in range(cfg.n_periods):
        layers += part("period", cfg.period, i)
    return layers + part("tail", cfg.tail)


def apply_stack(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                use_kernel: bool | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward through the whole stack → (x, aux_sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, spec, _ in layer_list(p, cfg):
        x, a = apply_layer(lp, cfg, spec, x, use_kernel=use_kernel)
        aux = aux + a
    return x, aux


def _stack_with_cache(step, p: Params, cfg: ModelConfig, x: torch.Tensor,
                      cache: Params, donate: bool) -> tuple[torch.Tensor, Params]:
    """``step(layer_params, spec, x, layer_cache) -> (x, new_cache)`` over
    head, the periods and tail; the period's new caches restacked, or,
    when ``donate``, written through the views into the stacked buffers."""
    new = []
    for lp, spec, c in layer_list(p, cfg, cache):
        x, nc = step(lp, spec, x, c)
        new.append(nc)
    n_head, n_period = len(cfg.head), len(cfg.period)
    per_rep = [new[n_head + i * n_period:n_head + (i + 1) * n_period]
               for i in range(cfg.n_periods)]
    new_period = cache["period"] if donate or not per_rep else tree_stack(per_rep)
    return x, {"head": new[:n_head], "period": new_period,
               "tail": new[n_head + cfg.n_periods * n_period:]}


def prefill_stack(
    p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params, *,
    use_kernel: bool | None = None, donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    def step(lp, spec, x, c):
        return prefill_layer(lp, cfg, spec, x, c, use_kernel=use_kernel, donate=donate)

    return _stack_with_cache(step, p, cfg, x, cache, donate)


def decode_stack(
    p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params, pos: int, *,
    use_kernel: bool | None = None, donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    def step(lp, spec, x, c):
        return decode_layer(lp, cfg, spec, x, c, pos, use_kernel=use_kernel, donate=donate)

    return _stack_with_cache(step, p, cfg, x, cache, donate)


# ------------------- groups whose MoE token groups cross ----------------------


def stack_groups(run, stacks: list, cfg: ModelConfig, xs: list, caches: list | None = None,
                 *, pos: int | None = None, use_kernel: bool | None = None
                 ) -> tuple[list, torch.Tensor]:
    """The stack for the groups of ``run`` (a ``sharding.GroupRun``) whose MoE
    token groups cross data indices, layer by layer: at each layer each
    group's :func:`_layer` in data order, inside its group, up to its MoE
    FFN, which then runs once over every group's rows inside group 0
    (:func:`_moe_groups`), each group's layer finishing with its rows of
    the output. ``stacks[c]``/``xs[c]``: group c's stack params and input,
    None for a group that does not compute (``run.computes``), which hands
    each MoE layer zeros of the last computing group's rows. Without
    ``caches``: :func:`apply_layer`'s forward; with them (each group's
    stack cache), :func:`prefill_layer`'s, or at ``pos``
    :func:`decode_layer`'s, the caches written in place (``donate``).
    Returns (each group's output, the MoE layers' aux losses summed in
    layer order, on group 0's home)."""
    layers = [None if s is None else layer_list(s, cfg, None if caches is None else caches[c])
              for c, s in enumerate(stacks)]
    aux = None
    for i, spec in enumerate(cfg.layer_specs()):
        steps, hs = {}, {}
        for c, x in enumerate(xs):
            if x is None:
                continue
            lp, _, lc = layers[c][i]
            with run.within(c):
                step = _layer(lp, cfg, spec, x, lc, pos, decode=pos is not None, donate=True,
                              use_kernel=use_kernel)
                try:
                    hs[c], steps[c] = next(step), step
                except StopIteration as done:
                    xs[c] = done.value[0]
        if steps:  # a MoE FFN
            outs, a = _moe_groups(run, layers[0][i][0], cfg, hs)
            aux = a if aux is None else aux + a
            for c, step in steps.items():
                with run.within(c):
                    out = outs[c]
                    if isinstance(hs[c], tp.Split):  # back to the chunks of the sequence split
                        out = tp.seq_reduce([out], hs[c].dim, hs[c].devices)
                    try:
                        step.send((out, None))
                    except StopIteration as done:
                        xs[c] = done.value[0]
    return xs, aux


def _moe_groups(run, p: Params, cfg: ModelConfig, hs: dict) -> tuple[list, torch.Tensor]:
    """One MoE layer (``p``: group 0's layer params) over the normed inputs
    ``hs`` of the groups that compute (:func:`stack_groups`), gathered whole
    on each group's home and run once inside group 0
    (``moe.apply_moe_groups``); a group that does not compute hands zeros of
    the last computing group's rows, sent as a group's. Returns (each
    group's output, whole on its home; the layer's aux loss)."""
    whole = []
    for c in range(run.groups):
        with run.within(c):
            if c in hs:
                whole.append(tp.whole_on_home(hs[c]))
                continue
            device, position = run.home(c)
            with peer.at(position):  # the dry run's shortcut
                whole.append(torch.zeros(whole[-1].shape, dtype=whole[-1].dtype, device=device))
    with run.within(0):
        return moe_mod.apply_moe_groups(p["ffn"], cfg.moe, whole, cfg.act, cfg.glu,
                                        [run.home(c) for c in range(run.groups)])


# ------------------------- the paper's technique -----------------------------


def sparsify_stack(p: Params, cfg: ModelConfig) -> Params:
    """Convert targeted FFN weights to BSR by block-magnitude pruning
    (host-side). Stacked period layers are converted slice by slice and
    restacked, so each slice keeps its own pad slots and masks."""
    sp = cfg.sparsity
    if sp is None or sp.blocks_per_row <= 0:
        return p

    def convert(layer: Params) -> Params:
        out = dict(layer)
        if "ffn" in layer and "ffn" in sp.targets:
            out["ffn"] = sparsify_ffn(layer["ffn"], sp.block_shape, sp.blocks_per_row)
        return out

    def convert_stacked(layer: Params) -> Params:
        return tree_stack([convert(tree_index(layer, i)) for i in range(cfg.n_periods)])

    return {
        "head": [convert(layer) for layer in p["head"]],
        "period": [convert_stacked(layer) for layer in p["period"]],
        "tail": [convert(layer) for layer in p["tail"]],
    }
