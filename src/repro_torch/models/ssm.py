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
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, RWKVConfig
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


def apply_rwkv_time_mix(
    p: Params,
    cfg: RWKVConfig,
    x: torch.Tensor,
    state: Params | None = None,
) -> tuple[torch.Tensor, Params]:
    """state (decode): {"shift": (B,D), "wkv": (B,H,K,V)}; None → zeros."""
    b, s, d = x.shape
    hd = cfg.head_dim
    h = d // hd
    prev = state["shift"] if state is not None else None
    xprev = _token_shift(x, prev)
    xw, xk, xv, xr, xg = _ddlerp(p, x, xprev)

    def heads(a):
        return a.reshape(b, s, h, hd).transpose(1, 2)

    r = heads(xr @ p["w_r"])
    k = heads(xk @ p["w_k"])
    v = heads(xv @ p["w_v"])
    g = silu(xg @ p["w_g"])
    logw = heads(-torch.exp(p["w0"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]))

    h0 = (state["wkv"] if state is not None
          else torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device))
    if s == 1 and state is not None:
        out, h_fin = wkv_step(r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0],
                              p["bonus_u"], h0)
        out = out[:, None]  # (B,1,H,V)
    else:
        out, h_fin = wkv_chunked(r, k, v, logw, p["bonus_u"], h0)
        out = out.transpose(1, 2)  # (B,S,H,V)
    out = rms_norm(out, p["ln_x"])  # per-head group norm
    out = out.reshape(b, s, d).to(x.dtype) * g
    out = out @ p["w_o"]
    return out, {"shift": x[:, -1], "wkv": h_fin}


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
) -> tuple[torch.Tensor, Params]:
    prev = state["shift"] if state is not None else None
    xprev = _token_shift(x, prev)
    xk = x + (xprev - x) * p["mu_k"]
    xr = x + (xprev - x) * p["mu_r"]
    k = F.relu(xk @ p["w_k"])
    k = k * k  # squared ReLU
    out = sigmoid(xr @ p["w_r"]) * (k @ p["w_v"])
    return out, {"shift": x[:, -1]}


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
) -> tuple[torch.Tensor, Params]:
    """state (decode): {"conv": (B, d_conv-1, di), "ssm": (B, di, N)}."""
    b, s, d = x.shape
    di = cfg.expand * d
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    tap = state["conv"] if state is not None else None
    x_c = silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], tap))
    proj = x_c @ p["x_proj"]
    dt_rank = p["dt_proj"].shape[0]
    n = cfg.d_state
    dt_raw, bm, cm = (proj[..., :dt_rank], proj[..., dt_rank:dt_rank + n],
                      proj[..., dt_rank + n:])
    delta = softplus(dt_raw @ p["dt_proj"] + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    h0 = (state["ssm"] if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    if s == 1 and state is not None:
        y, h_fin = mamba_step(x_c[:, 0].float(), delta[:, 0].float(), a, bm[:, 0].float(),
                              cm[:, 0].float(), h0)
        y = y[:, None]
    else:
        y, h_fin = mamba_scan_chunked(x_c, delta, a, bm, cm, h0)
    y = y.to(x.dtype) + p["D"] * x_c
    y = y * silu(z)
    out = y @ p["out_proj"]
    k1 = cfg.d_conv - 1
    if tap is not None:
        new_tap = torch.cat([tap, x_in], dim=1)[:, -k1:]
    elif s >= k1:
        new_tap = x_in[:, s - k1:]
    else:
        new_tap = F.pad(x_in, (0, 0, k1 - s, 0))
    return out, {"conv": new_tap, "ssm": h_fin}
