"""Attention-free mixers — counterpart of ``repro/models/ssm.py``: RWKV-6
(Finch) time/channel-mix and the Mamba-1 selective SSM (for Jamba), each
with a chunked-parallel form (prefill, forward) and a recurrent step
(decode).

Both recurrences are diagonal-decay linear systems
``h_t = exp(w_t) ⊙ h_{t-1} + k_t ⊗ v_t``; the chunked form turns them
into dense matmuls per chunk with an inter-chunk carried state. Every
per-step log-decay is clamped to ``≥ _LOG_DECAY_MIN`` at op entry, in
both forms, and the chunk is 16, so the within-chunk ``exp(±cumsum)``
rescaling stays inside f32 range (e^{5·16} ≈ 5.5e34 < f32 max).

Decode paths carry O(1) state: (wkv state, token shift) for RWKV;
(conv tap, ssm state) for Mamba.

On the model's mesh a group's weights split over ``model`` are
``tensor_parallel.Split``s, and each mixer has a split forward: Mamba
over its inner channels ``di``, RWKV-6's time mix over heads
(``w_r``/``w_g`` column-parallel, the rest whole on the home device) and
its channel mix over ``d_ff``. Each takes and returns its decode state
split as its weights are (a group's view of a cache placed by
``cache_pspecs``): Mamba's ``conv`` tap and ``ssm`` state by channel,
RWKV-6's ``wkv`` state by head, each position's on its device; the token
shifts stay whole on the home device. A split whose channels or heads
do not divide runs whole there, with its state whole.

With the residual split along the sequence (sequence parallelism), Mamba
gathers it on every position (its conv and scan run over the whole
sequence, channel by channel) and reduce-scatters ``out_proj``'s
partials; RWKV-6's mixes, whose token shift, decay and gate run on the
home device, take the whole sequence gathered there (a chunk's first
token then reads the previous chunk's last) and hand their output back
by chunks (``tensor_parallel.on_home``).
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, RWKVConfig
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.layers import (
    Init,
    dense_init,
    init_rms_norm,
    rms_norm,
    sigmoid,
    silu,
    softplus,
)

Params = dict[str, Any]

_LOG_DECAY_MIN = -5.0
_CHUNK = 16


def _clamp_logw(logw: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logw, _LOG_DECAY_MIN, 0.0)


# =============================== RWKV-6 ======================================


def init_rwkv_time_mix(rng: Init, d_model: int, cfg: RWKVConfig, dtype=torch.float32) -> Params:
    h = d_model // cfg.head_dim
    return {
        # data-dependent token-shift interpolation (5 targets: w,k,v,r,g)
        "mu_x": rng.zeros((d_model,), dtype),
        "mu": rng.zeros((5, d_model), dtype),
        "mix_w1": dense_init(rng, d_model, 5 * cfg.mix_lora, dtype),
        "mix_w2": 0.01 * rng.normal((5, cfg.mix_lora, d_model), dtype),
        "w_r": dense_init(rng, d_model, d_model, dtype),
        "w_k": dense_init(rng, d_model, d_model, dtype),
        "w_v": dense_init(rng, d_model, d_model, dtype),
        "w_g": dense_init(rng, d_model, d_model, dtype),
        "w_o": dense_init(rng, d_model, d_model, dtype),
        # data-dependent decay: logw = -exp(w0 + tanh(x@dw1)@dw2)
        "w0": rng.full((d_model,), -1.0, dtype),
        "decay_w1": dense_init(rng, d_model, cfg.decay_lora, dtype),
        "decay_w2": 0.01 * rng.normal((cfg.decay_lora, d_model), dtype),
        "bonus_u": 0.5 * rng.normal((h, cfg.head_dim), dtype),
        "ln_x": init_rms_norm(rng, cfg.head_dim),  # per-head group norm
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` is the carried last token (decode)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, xprev: torch.Tensor) -> list[torch.Tensor]:
    """RWKV-6 data-dependent lerp producing the 5 mixed streams."""
    b, s, _ = x.shape
    diff = xprev - x
    xx = x + diff * p["mu_x"]
    inner = torch.tanh(xx @ p["mix_w1"]).reshape(b, s, 5, -1)
    dyn = torch.einsum("bsnl,nld->nbsd", inner, p["mix_w2"])  # (5,B,S,D)
    return [x + diff * (p["mu"][i] + dyn[i]) for i in range(5)]


def wkv_chunked(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    logw: torch.Tensor,  # (B, H, T, K), ≤ 0 after clamp
    u: torch.Tensor,  # (H, K) current-token bonus
    h0: torch.Tensor,  # (B, H, K, V)
    *,
    chunk: int = _CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """out_t = r_t·(h_{t-1} + u⊙k_t⊗v_t);  h_t = e^{w_t}⊙h_{t-1} + k_t⊗v_t."""
    b, h, t, _ = r.shape
    dv = v.shape[-1]
    logw = _clamp_logw(logw.float())
    pad = (-t) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
    nc = (t + pad) // chunk

    def chunks(a):
        return a.float().reshape(b, h, nc, chunk, a.shape[-1]).permute(2, 0, 1, 3, 4)

    tri_strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    uf = u.float()
    hs = h0.float()
    ys = []
    for rc, kc, vc, wc in zip(chunks(r), chunks(k), chunks(v), chunks(logw)):
        cum = torch.cumsum(wc, dim=2)
        r_t = rc * torch.exp(cum - wc)  # decay up to t-1 (exclusive)
        k_t = kc * torch.exp(-cum)
        scores = torch.einsum("bhtk,bhsk->bhts", r_t, k_t)
        scores = torch.where(tri_strict, scores, 0.0)
        y = torch.einsum("bhts,bhsv->bhtv", scores, vc)
        y = y + torch.einsum("bhtk,bhkv->bhtv", r_t, hs)
        diag = torch.einsum("bhtk,hk->bht", rc * kc, uf)
        y = y + diag[..., None] * vc
        decay_end = torch.exp(cum[:, :, -1:, :] - cum)
        hs = hs * torch.exp(cum[:, :, -1, :])[..., None] + torch.einsum(
            "bhtk,bhtv->bhkv", kc * decay_end, vc)
        ys.append(y)
    out = torch.stack(ys, dim=2).reshape(b, h, nc * chunk, dv)[:, :, :t]
    return out, hs


def wkv_step(
    r: torch.Tensor,  # (B, H, K)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, H, V)
    logw: torch.Tensor,  # (B, H, K)
    u: torch.Tensor,  # (H, K)
    h: torch.Tensor,  # (B, H, K, V)
) -> tuple[torch.Tensor, torch.Tensor]:
    r, k, v, h = (a.float() for a in (r, k, v, h))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, h + u.float()[None, :, :, None] * kv)
    h_new = torch.exp(_clamp_logw(logw.float()))[..., None] * h + kv
    return out, h_new


def _heads(a: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, H·hd) → (B, H, S, hd)."""
    b, s, d = a.shape
    return a.reshape(b, s, d // hd, hd).transpose(1, 2)


def _rwkv_logw(p: Params, xw: torch.Tensor) -> torch.Tensor:
    return -torch.exp(p["w0"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"])


def _rwkv_gated(out: torch.Tensor, ln_x: torch.Tensor, g: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The per-head group norm of ``out`` (B, S, H, V), its heads flattened
    and gated by ``g``."""
    b, s = out.shape[:2]
    out = rms_norm(out, ln_x)  # per-head group norm
    return out.reshape(b, s, -1).to(dtype) * g


def apply_rwkv_time_mix(
    p: Params,
    cfg: RWKVConfig,
    x: torch.Tensor,
    state: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """state (decode): {"shift": (B,D), "wkv": (B,H,K,V)}; None → zeros.
    With ``w_r``/``w_g`` split over ``model``: the split forward, its
    ``wkv`` state split by heads where the heads divide."""
    if isinstance(x, tp.Split):
        return tp.on_home(lambda h: apply_rwkv_time_mix(p, cfg, h, state), x)
    if isinstance(p["w_r"], tp.Split):
        return _apply_rwkv_time_mix_split(p, cfg, x, state)
    s = x.shape[1]
    hd = cfg.head_dim
    prev = state["shift"] if state is not None else None
    xprev = _token_shift(x, prev)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xprev)

    r = _heads(xr @ p["w_r"], hd)
    k = _heads(xk @ p["w_k"], hd)
    v = _heads(xv @ p["w_v"], hd)
    g = silu(xg @ p["w_g"])
    logw = _heads(_rwkv_logw(p, xw), hd)

    out, h_fin = _wkv_gated(r, k, v, logw, p["bonus_u"], p["ln_x"], g, x.dtype,
                            None if state is None else state["wkv"],
                            step=s == 1 and state is not None)
    return out @ p["w_o"], {"shift": x[:, -1], "wkv": h_fin}


def _wkv_gated(r, k, v, logw, u, ln_x, g, dtype, h0=None,
               step: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV of the heads given (chunked, or one recurrent ``step``) from
    ``h0`` (None: zeros), through the group norm and the gate: ((B, S,
    H·V), the last state)."""
    b, h, _, hd = r.shape
    if h0 is None:
        h0 = torch.zeros((b, h, hd, v.shape[-1]), dtype=torch.float32, device=r.device)
    if step:
        out, h_fin = wkv_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], u, h0)
        out = out[:, None]
    else:
        out, h_fin = wkv_chunked(r, k, v, logw, u, h0)
        out = out.transpose(1, 2)
    return _rwkv_gated(out, ln_x, g, dtype), h_fin


def _apply_rwkv_time_mix_split(p: Params, cfg: RWKVConfig, x: torch.Tensor,
                               state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """The time mix with ``w_r``/``w_g`` split over ``model`` (output
    columns; every other leaf whole on ``x``'s device, where the token
    shift, the mix, ``k``, ``v``, the decay and ``w_o`` run once). The mixed
    streams for r and g are fanned out and each position computes its
    columns. When the columns fall on head boundaries (``d/M`` a multiple
    of ``head_dim``), ``k``, ``v`` and the decay are scattered by heads,
    ``bonus_u`` and ``ln_x`` fanned out (``bonus_u`` narrowed to the
    position's heads), each position runs the WKV of its heads, and the
    gated outputs are gathered in model order for ``w_o``. Otherwise r and
    g are gathered (exact) and the mixer runs where ``x`` is. ``state``
    (decode): the token shift on ``x``'s device and the ``wkv`` state, a
    ``Split`` by heads (whole where the split cuts a head); the new state
    comes back the same way (a prefill's, from zeros, too)."""
    hd = cfg.head_dim
    devices = p["w_r"].devices
    n = len(devices)
    step = x.shape[1] == 1 and state is not None
    xw, xk, xv, xr, xg = _ddlerp(p, x, _token_shift(x, None if state is None else
                                                    state["shift"]))
    k = _heads(xk @ p["w_k"], hd)
    v = _heads(xv @ p["w_v"], hd)
    logw = _heads(_rwkv_logw(p, xw), hd)
    xrs, xgs = tp.fan_out(xr, devices), tp.fan_out(xg, devices)
    rs = [xrs[m] @ p["w_r"].chunks[m] for m in range(n)]
    gs = [xgs[m] @ p["w_g"].chunks[m] for m in range(n)]
    h0 = None if state is None else state["wkv"]
    if (x.shape[-1] // n) % hd:  # the column split cuts a head
        r = _heads(tp.all_gather(rs, -1, x.device), hd)
        g = silu(tp.all_gather(gs, -1, x.device))
        out, h_fin = _wkv_gated(r, k, v, logw, p["bonus_u"], p["ln_x"], g, x.dtype, h0, step)
        return out @ p["w_o"], {"shift": x[:, -1], "wkv": h_fin}
    ks, vs, ws = (tp.scatter(t, 1, devices) for t in (k, v, logw))
    us, lns = tp.fan_out(p["bonus_u"], devices), tp.fan_out(p["ln_x"], devices)
    per = k.shape[1] // n
    outs, states = [], []
    for m in range(n):
        out, h_fin = _wkv_gated(_heads(rs[m], hd), ks[m], vs[m], ws[m],
                                us[m].narrow(0, m * per, per), lns[m], silu(gs[m]), x.dtype,
                                None if h0 is None else h0.chunks[m], step)
        outs.append(out)
        states.append(h_fin)
    return (tp.all_gather(outs, -1, x.device) @ p["w_o"],
            {"shift": x[:, -1], "wkv": tp.Split(tuple(states), 1)})


def init_rwkv_channel_mix(rng: Init, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return {
        "mu_k": rng.zeros((d_model,), dtype),
        "mu_r": rng.zeros((d_model,), dtype),
        "w_k": dense_init(rng, d_model, d_ff, dtype),
        "w_v": dense_init(rng, d_ff, d_model, dtype),
        "w_r": dense_init(rng, d_model, d_model, dtype),
    }


def apply_rwkv_channel_mix(
    p: Params, x: torch.Tensor, state: Params | None = None
) -> tuple[torch.Tensor, Params | None]:
    """With ``w_k``/``w_v`` split over ``model``: the split forward."""
    if isinstance(x, tp.Split):
        return tp.on_home(lambda h: apply_rwkv_channel_mix(p, h, state), x)
    prev = state["shift"] if state is not None else None
    if isinstance(p["w_k"], tp.Split):
        return _apply_rwkv_channel_mix_split(p, x, prev), {"shift": x[:, -1]}
    xprev = _token_shift(x, prev)
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    out = sigmoid(xr @ p["w_r"]) * _squared_relu_mlp(xk, p["w_k"], p["w_v"])
    return out, {"shift": x[:, -1]}


def _squared_relu_mlp(xk: torch.Tensor, w_k: torch.Tensor, w_v: torch.Tensor) -> torch.Tensor:
    k = F.relu(xk @ w_k)
    k = k * k  # squared ReLU
    return k @ w_v


def _apply_rwkv_channel_mix_split(p: Params, x: torch.Tensor,
                                  prev: torch.Tensor | None = None) -> torch.Tensor:
    """The channel mix with ``w_k`` column-parallel and ``w_v``
    row-parallel over ``model`` (``d_ff`` split): the shifted mix (``prev``:
    the carried token, decode) fanned out, each position's partial ``k @
    w_v`` added in model order on ``x``'s device, where the whole ``w_r``'s
    sigmoid gate multiplies the sum."""
    xprev = _token_shift(x, prev)
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    w_k, w_v = p["w_k"], p["w_v"]
    xks = tp.fan_out(xk, w_k.devices)
    kv = tp.fan_in([_squared_relu_mlp(xks[m], w_k.chunks[m], w_v.chunks[m])
                    for m in range(len(xks))], x.device)
    return sigmoid(xr @ p["w_r"]) * kv


# =============================== Mamba-1 =====================================


def init_mamba(rng: Init, d_model: int, cfg: MambaConfig, dtype=torch.float32) -> Params:
    di = cfg.expand * d_model
    dt_rank = cfg.dt_rank or math.ceil(d_model / 16)
    a_init = torch.arange(1, cfg.d_state + 1, dtype=torch.float32).expand(di, cfg.d_state)
    return {
        "in_proj": dense_init(rng, d_model, 2 * di, dtype),
        "conv_w": 0.1 * rng.normal((cfg.d_conv, di), dtype),
        "conv_b": rng.zeros((di,), dtype),
        "x_proj": dense_init(rng, di, dt_rank + 2 * cfg.d_state, dtype),
        "dt_proj": dense_init(rng, dt_rank, di, dtype),
        "dt_bias": rng.full((di,), -4.6, dtype),  # softplus ≈ 0.01
        "A_log": rng.const(torch.log(a_init)),
        "D": rng.full((di,), 1.0, dtype),
        "out_proj": dense_init(rng, di, d_model, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tap: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv: y_t = Σ_i w[i]·x[t-(K-1)+i] + b.
    ``tap``: (B, K-1, di) carried context (decode/prefill continuation)."""
    kk = w.shape[0]
    xp = F.pad(x, (0, 0, kk - 1, 0)) if tap is None else torch.cat([tap, x], dim=1)
    y = sum(w[i] * xp[:, i:i + x.shape[1]] for i in range(kk))
    return y + b


def mamba_scan_chunked(
    u: torch.Tensor,  # (B, T, di) conv+silu output
    delta: torch.Tensor,  # (B, T, di)
    a: torch.Tensor,  # (di, N) negative
    bm: torch.Tensor,  # (B, T, N)
    cm: torch.Tensor,  # (B, T, N)
    h0: torch.Tensor,  # (B, di, N)
    *,
    chunk: int = _CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = e^{Δ_t A}⊙h_{t-1} + (Δ_t u_t)⊗B_t ;  y_t = C_t·h_t."""
    b, t, di = u.shape
    pad = (-t) % chunk
    if pad:
        u, delta, bm, cm = (F.pad(x, (0, 0, 0, pad)) for x in (u, delta, bm, cm))
    nch = (t + pad) // chunk

    def chunks(x):
        return x.float().reshape(b, nch, chunk, x.shape[-1]).transpose(0, 1)

    tri_incl = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=u.device))
    af = a.float()
    hs = h0.float()
    ys = []
    for uc, dc, bc, cc in zip(chunks(u), chunks(delta), chunks(bm), chunks(cm)):
        da = _clamp_logw(dc[..., None] * af)  # (B, C, di, N)
        cum = torch.cumsum(da, dim=1)
        q = cc[:, :, None, :] * torch.exp(cum)
        kt = bc[:, :, None, :] * torch.exp(-cum)
        scores = torch.einsum("btcn,bscn->btsc", q, kt)
        scores = torch.where(tri_incl[None, :, :, None], scores, 0.0)
        dx = dc * uc  # (B, C, di)
        y = torch.einsum("btsc,bsc->btc", scores, dx)
        y = y + torch.einsum("btcn,bcn->btc", q, hs)
        k_end = bc[:, :, None, :] * torch.exp(cum[:, -1:] - cum)
        hs = hs * torch.exp(cum[:, -1]) + torch.einsum("bscn,bsc->bcn", k_end, dx)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nch * chunk, di)[:, :t]
    return y, hs


def mamba_step(
    u_t: torch.Tensor,  # (B, di)
    delta_t: torch.Tensor,
    a: torch.Tensor,
    b_t: torch.Tensor,  # (B, N)
    c_t: torch.Tensor,
    h: torch.Tensor,  # (B, di, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    da = torch.exp(_clamp_logw(delta_t[..., None] * a.float()))
    h_new = da * h + (delta_t * u_t)[..., None] * b_t[:, None, :]
    y = torch.einsum("bcn,bn->bc", h_new, c_t)
    return y, h_new


def apply_mamba(
    p: Params,
    cfg: MambaConfig,
    x: torch.Tensor,
    state: Params | None = None,
) -> tuple[torch.Tensor, Params | None]:
    """state (decode): {"conv": (B, d_conv-1, di), "ssm": (B, di, N)}.
    With its weights split over ``model``: the split forward, its state
    split by channels where ``di`` divides."""
    if isinstance(p["in_proj"], tp.Split):
        return _apply_mamba_split(p, cfg, x, state)
    if isinstance(x, tp.Split):  # whole weights: once on the home
        return tp.on_home(lambda h: apply_mamba(p, cfg, h, state), x)
    return _mamba_after_in_proj(x @ p["in_proj"], p, cfg, state)


def _mamba_after_in_proj(xz: torch.Tensor, p: Params, cfg: MambaConfig,
                         state: Params | None) -> tuple[torch.Tensor, Params]:
    """Mamba from its ``in_proj`` product ``xz = [x_in | z]`` on whole
    weights (``p["in_proj"]`` is not read)."""
    b, s, two_di = xz.shape
    di = two_di // 2
    x_in, z = xz[..., :di], xz[..., di:]
    tap = state["conv"] if state is not None else None
    x_c = _mamba_conv(x_in, p, tap)
    h0 = (state["ssm"] if state is not None
          else torch.zeros((b, di, cfg.d_state), dtype=torch.float32, device=xz.device))
    y, h_fin = _mamba_gated(x_c @ p["x_proj"], x_c, z, p, cfg, h0,
                            step=s == 1 and state is not None)
    out = y @ p["out_proj"]
    return out, {"conv": _next_tap(x_in, tap, cfg.d_conv - 1), "ssm": h_fin}


def _next_tap(x_in: torch.Tensor, tap: torch.Tensor | None, k1: int) -> torch.Tensor:
    """The conv's carried context after ``x_in``: its last ``k1`` inputs."""
    s = x_in.shape[1]
    if tap is not None:
        return torch.cat([tap, x_in], dim=1)[:, -k1:]
    if s >= k1:
        return x_in[:, s - k1:]
    return F.pad(x_in, (0, 0, k1 - s, 0))


def _mamba_conv(x_in: torch.Tensor, p: Params, tap: torch.Tensor | None) -> torch.Tensor:
    return silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], tap))


def _mamba_gated(proj, x_c, z, p: Params, cfg: MambaConfig, h0, *, step: bool = False):
    """The per-channel rest of Mamba for the channels ``p`` holds (every
    one, or one model position's), from ``proj = x_c @ x_proj`` (whole):
    the discretisation, the scan from ``h0``, ``D``'s skip and the ``z``
    gate → (y, the scan's last state)."""
    dt_rank = p["dt_proj"].shape[0]
    n = cfg.d_state
    dt_raw, bm, cm = (proj[..., :dt_rank], proj[..., dt_rank:dt_rank + n],
                      proj[..., dt_rank + n:])
    delta = softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    if step:
        y, h_fin = mamba_step(x_c[:, 0].float(), delta[:, 0].float(), a, bm[:, 0].float(),
                              cm[:, 0].float(), h0)
        y = y[:, None]
    else:
        y, h_fin = mamba_scan_chunked(x_c, delta, a, bm, cm, h0)
    y = y.to(x_c.dtype) + p["D"] * x_c
    return y * silu(z), h_fin


_MAMBA_CHANNELS = ("conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
                   "out_proj")


def mamba_channels(p: Params, x) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each model position's ``(x_in, z)`` of Mamba's ``in_proj`` split
    over ``model``: ``x`` fanned out (a split sequence gathered on every
    position: ``tensor_parallel.region_input``), each position's product with its
    contiguous chunk of the ``2·di`` columns, then regrouped
    (``tensor_parallel.regroup``, counted as ``"regroup"``) so position m
    holds channels ``[m·di/M, (m+1)·di/M)`` of both ``x_in`` and ``z``."""
    w = p["in_proj"]
    xs = tp.region_input(x, w.devices)
    halves = tp.regroup([xm @ c for xm, c in zip(xs, w.chunks)], -1, 2)
    return [tuple(h.chunk(2, -1)) for h in halves]


def _apply_mamba_split(p: Params, cfg: MambaConfig, x: torch.Tensor,
                       state: Params | None = None) -> tuple[torch.Tensor, Params]:
    """Mamba with ``di`` split over ``model`` (a group's
    ``tensor_parallel.Split`` weights): ``in_proj``, ``dt_proj`` and the
    per-channel leaves column-parallel, ``x_proj`` and ``out_proj``
    row-parallel. Each position takes its ``x_in`` and ``z`` channels
    (:func:`mamba_channels`) and runs the conv; the ``x_proj`` partials
    (``dt_raw``, ``B``, ``C``) are added in model order on ``x``'s device
    and fanned back out; each position discretises and scans its channels
    (state ``(B, di/M, N)``), and the ``out_proj`` partials are added in
    model order on ``x``'s device. When ``di`` does not divide over
    ``model`` (the channel leaves whole) but ``2·di`` does, the ``in_proj``
    columns are gathered (exact) and the layer runs where ``x`` is. For
    ``x`` split along the sequence the ``out_proj`` partials are
    reduce-scattered onto its chunks.
    ``state`` (decode): each position's ``conv`` tap and ``ssm`` state for
    its channels (``Split``s; whole where the channel leaves are); the new
    state comes back the same way (a prefill's, from zeros, too)."""
    b, s, d = x.shape
    di = cfg.expand * d
    if not isinstance(p["conv_w"], tp.Split):
        if isinstance(x, tp.Split):
            return tp.on_home(lambda h: _apply_mamba_split(p, cfg, h, state), x)
        w = p["in_proj"]
        xs = tp.fan_out(x, w.devices)
        xz = tp.all_gather([xm @ c for xm, c in zip(xs, w.chunks)], -1, x.device)
        return _mamba_after_in_proj(xz, p, cfg, state)
    devices = p["in_proj"].devices
    n = len(devices)
    step = s == 1 and state is not None
    taps = [None] * n if state is None else state["conv"].chunks
    pm = [{k: p[k].chunks[m] for k in _MAMBA_CHANNELS} for m in range(n)]
    channels = mamba_channels(p, x)
    x_c = [_mamba_conv(x_in, pm[m], taps[m]) for m, (x_in, _) in enumerate(channels)]
    proj = tp.fan_in([xc @ w["x_proj"] for xc, w in zip(x_c, pm)], x.device)
    projs = tp.fan_out(proj, devices)
    partials, convs, ssms = [], [], []
    for m, d in enumerate(devices):
        h0 = (torch.zeros((b, di // n, cfg.d_state), dtype=torch.float32, device=d)
              if state is None else state["ssm"].chunks[m])
        y, h_fin = _mamba_gated(projs[m], x_c[m], channels[m][1], pm[m], cfg, h0, step=step)
        partials.append(y @ pm[m]["out_proj"])
        convs.append(_next_tap(channels[m][0], taps[m], cfg.d_conv - 1))
        ssms.append(h_fin)
    return tp.region_output(partials, x), {"conv": tp.Split(tuple(convs), 2),
                                           "ssm": tp.Split(tuple(ssms), 1)}
