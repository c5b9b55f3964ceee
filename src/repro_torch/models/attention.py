"""Attention mixers — counterpart of ``repro/models/attention.py``: GQA
(full / sliding-window, QK-norm, bias) and MLA (DeepSeek-V2 latent
attention), train, prefill and decode paths.

The same arithmetic as the reference, in einsums over tensors (no fused
attention call): scores and probabilities are stored in the working
(compute) dtype and only the softmax runs in f32 (``_attend``); the
streaming form keeps an online softmax over k-tiles in f32 and skips
tiles the causal / window mask leaves dead (``_attend_streaming``).

Decode semantics: the KV cache is a fixed-size buffer (a ring buffer for
windowed layers) with an explicit ``positions`` track; batch entries
decode at a shared position. The cache writers work on a copy of each
buffer they write by default; with ``donate=True`` they write into the
caller's buffers and return them (the reference plans' donated cache,
which XLA updates in place), with the same values. A full-attention
layer writes a position past its buffer into the last slot, as the
reference's ``dynamic_update_slice`` clamps its start index. MLA decode uses the
absorbed formulation: only the (kv_lora + rope) latents are cached and
the up-projections fold into the query and output sides.

A group of the model's mesh serves with its split weights (heads over
``model``, as in training) and its view of a cache placed by
``cache_pspecs`` (``sharding.group_cache``): the K/V or latent slots
split into M equal ranges, range m on model position m, and
``positions`` whole on the home device. A prefill attends as the split
forward does and writes the prompt's keys and values (or latents) into
the positions that own their slots; a decode step writes its token's
into the owner of its slot, every range's owner scores its slots for
every query head, and the ranges' partial softmaxes are merged in model
order on the home device (``tensor_parallel.merge_softmax``, f32) before
the row-parallel output projection. A cache whose slots do not divide
over ``model`` is one range on the home device.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.layers import Init, dense_init, init_rms_norm, rms_norm, rounded

Params = dict[str, Any]

_NEG_INF = -1e30


# --- RoPE -------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                     / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B,S,hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- shared attention core ---------------------------------------------------


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, h: int):
    """KV heads repeated up to the query-head count (``jnp.repeat``)."""
    hkv = k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    return k, v


def _attend(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,  # (B, S, Hkv, dv)
    mask: torch.Tensor,  # (B, T, S) or (T, S) boolean (True = attend)
    *,
    scale: float,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Grouped scaled-dot-product attention, f32 softmax, query-chunked so
    the score matrix never exceeds (chunk × S) per head. Scores and
    probabilities are stored in the working dtype (the compute dtype);
    the softmax normalisation runs in f32."""
    b, t, h, _ = q.shape
    k, v = _repeat_kv(k, v, h)
    if mask.dim() == 2:
        mask = mask[None].expand(b, t, mask.shape[-1])
    wdt = q.dtype
    scale_w = rounded(scale, wdt)  # the reference scales by the scale in wdt

    def block(qb, mb):  # (B, tc, H, hd), (B, tc, S)
        scores = torch.einsum("bthd,bshd->bhts", qb, k) * scale_w
        scores = torch.where(mb[:, None], scores, _NEG_INF)
        m = torch.amax(scores, dim=-1, keepdim=True).detach().float()
        e = torch.exp(scores.float() - m)
        w = (e / torch.sum(e, dim=-1, keepdim=True)).to(wdt)
        return torch.einsum("bhts,bshd->bthd", w, v)

    if t <= q_chunk:
        out = block(q, mask)
    else:
        out = torch.cat([block(q[:, i:i + q_chunk], mask[:, i:i + q_chunk])
                         for i in range(0, t, q_chunk)], dim=1)
    return out.to(q.dtype)


def _attend_streaming(
    q: torch.Tensor,  # (B, T, H, hd)
    k: torch.Tensor,  # (B, S, Hkv, hd)
    v: torch.Tensor,  # (B, S, Hkv, dv)
    *,
    scale: float,
    causal_offset: int = 0,  # absolute position of q[0] minus k[0]
    window: int = 0,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-attention-2 style streaming attention: an online softmax over
    k-tiles in f32, so full (T, S) score matrices never exist. The tiles a
    query chunk covers are those the causal / window mask leaves alive,
    ``[max(0, lo − window + 1) … hi]``; dead tiles are never computed."""
    b, t, h, _ = q.shape
    k, v = _repeat_kv(k, v, h)
    s = k.shape[1]
    dv = v.shape[-1]
    nq = -(-t // q_chunk)
    nk_total = -(-s // k_chunk)
    # a ragged last k-tile: the keys are zero-padded to whole tiles and
    # the pad (positions >= s) is masked. The reference slices the tile
    # at full length from a clamped start, which labels its keys with the
    # wrong positions; the port keeps the block path's answer
    pad = nk_total * k_chunk - s
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(nq):
        q_lo = i * q_chunk
        q_hi = min(t, q_lo + q_chunk) - 1
        qb = q[:, q_lo:q_hi + 1].float()
        tc = qb.shape[1]
        k_hi_tile = min(nk_total, (q_hi + causal_offset) // k_chunk + 1)
        k_lo_tile = 0
        if window:
            k_lo_tile = max(0, (q_lo + causal_offset - window + 1) // k_chunk)
        acc = torch.zeros((b, h, tc, dv), dtype=torch.float32, device=q.device)
        m_run = torch.full((b, h, tc), -math.inf, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, h, tc), dtype=torch.float32, device=q.device)
        qpos = causal_offset + q_lo + torch.arange(tc, device=q.device)[:, None]
        for kt in range(k_lo_tile, k_hi_tile):
            kb, vb = kf[:, kt * k_chunk:(kt + 1) * k_chunk], vf[:, kt * k_chunk:(kt + 1) * k_chunk]
            sc = torch.einsum("bthd,bshd->bhts", qb, kb) * scale
            kpos = kt * k_chunk + torch.arange(k_chunk, device=q.device)[None, :]
            ok = kpos <= qpos
            if window:
                ok &= (qpos - kpos) < window
            sc = torch.where(ok, sc, _NEG_INF)
            m_new = torch.maximum(m_run, torch.amax(sc, dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p, vb)
            m_run = m_new
        out = acc / torch.clamp_min(l_run[..., None], 1e-30)
        outs.append(out.transpose(1, 2).to(q.dtype))  # (B, tc, H, dv)
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)


def attend_causal(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    window: int = 0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal self-attention dispatch: streaming for sequences longer than
    ``q_chunk``, the single-block path otherwise."""
    t = q.shape[1]
    if t > q_chunk:
        return _attend_streaming(q, k, v, scale=scale, window=window, q_chunk=q_chunk)
    return _attend(q, k, v, causal_mask(t, window, q.device), scale=scale, q_chunk=q_chunk)


def causal_mask(t: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    m = j <= i
    if window:
        m &= (i - j) < window
    return m


def cache_mask(positions_in_cache: torch.Tensor, pos: int, window: int = 0) -> torch.Tensor:
    """(S_cache,) absolute positions (−1 = empty) vs current position."""
    m = (positions_in_cache >= 0) & (positions_in_cache <= pos)
    if window:
        m &= (pos - positions_in_cache) < window
    return m


def _write_slot(buf: torch.Tensor, new: torch.Tensor, slot: int, dim: int, *,
                donate: bool = False) -> torch.Tensor:
    """``buf`` with ``new`` (length 1 along ``dim``) written at ``slot``:
    into ``buf`` itself when ``donate``, else into a copy; a slot past the
    end writes the last one (the reference's ``dynamic_update_slice``
    clamps its start index)."""
    slot = min(slot, buf.shape[dim] - 1)
    out = buf if donate else buf.clone()
    out.narrow(dim, slot, 1).copy_(new)
    return out


# --- GQA ---------------------------------------------------------------------


def init_gqa(rng: Init, cfg: AttentionConfig, d_model: int, dtype=torch.float32) -> Params:
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = rng.lead
    p = {
        "w_q": dense_init(rng, d_model, h * hd, dtype).reshape(*lead, d_model, h, hd),
        "w_k": dense_init(rng, d_model, hkv * hd, dtype).reshape(*lead, d_model, hkv, hd),
        "w_v": dense_init(rng, d_model, hkv * hd, dtype).reshape(*lead, d_model, hkv, hd),
        "w_o": dense_init(rng, h * hd, d_model, dtype).reshape(*lead, h, hd, d_model),
    }
    if cfg.qkv_bias:
        p["b_q"] = rng.zeros((h, hd), dtype)
        p["b_k"] = rng.zeros((hkv, hd), dtype)
        p["b_v"] = rng.zeros((hkv, hd), dtype)
    if cfg.qk_norm:
        p["q_norm"] = init_rms_norm(rng, hd)
        p["k_norm"] = init_rms_norm(rng, hd)
    return p


def _gqa_q(p: Params, cfg: AttentionConfig, x: torch.Tensor, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"])
    if cfg.qkv_bias:
        q = q + p["b_q"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    return apply_rope(q, positions, theta)


def _gqa_kv(p: Params, cfg: AttentionConfig, x: torch.Tensor, positions, theta):
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"])
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"])
    if cfg.qkv_bias:
        k, v = k + p["b_k"], v + p["b_v"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    return apply_rope(k, positions, theta), v


def _gqa_qkv(p: Params, cfg: AttentionConfig, x: torch.Tensor, positions, theta):
    return (_gqa_q(p, cfg, x, positions, theta), *_gqa_kv(p, cfg, x, positions, theta))


def apply_gqa(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,
    *,
    window: int = 0,
    rope_theta: float = 0.0,
    q_chunk: int = 1024,
) -> torch.Tensor:
    if isinstance(p["w_q"], tp.Split):
        return _apply_gqa_split(p, cfg, x, window=window, rope_theta=rope_theta,
                                q_chunk=q_chunk)
    if isinstance(x, tp.Split):  # whole weights: once on the home
        return tp.on_home(lambda h: apply_gqa(p, cfg, h, window=window, rope_theta=rope_theta,
                                              q_chunk=q_chunk), x)
    s = x.shape[1]
    theta = rope_theta or cfg.rope_theta
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, x, positions, theta)
    out = attend_causal(q, k, v, window=window, scale=1.0 / math.sqrt(cfg.head_dim),
                        q_chunk=q_chunk)
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"])


def kv_heads_of(h: int, hkv: int, m: int, positions: int) -> tuple[int, list[int]]:
    """The KV heads model position ``m`` of ``positions`` attends with when
    its query heads are ``[m·h/M, (m+1)·h/M)`` and the KV heads are whole
    (``hkv`` does not split): the reference repeats KV to ``h`` heads
    before it splits them, so query head j reads KV head ``j // (h/hkv)``.
    Returns (the first KV head, how many of the position's query heads read
    each KV head from there on)."""
    per, group = h // positions, h // hkv
    heads = [j // group for j in range(m * per, (m + 1) * per)]
    return heads[0], [heads.count(i) for i in range(heads[0], heads[-1] + 1)]


def _apply_gqa_split(p: Params, cfg: AttentionConfig, x: torch.Tensor, *, window: int,
                     rope_theta: float, q_chunk: int, kv: list | None = None) -> torch.Tensor:
    """GQA with its query heads split over ``model`` (a group's
    ``tensor_parallel.Split`` weights): ``w_q``/``w_k``/``w_v`` and their
    biases column-parallel, ``w_o`` row-parallel. Each position computes
    its query heads' attention and its partial output projection; the
    partials are added in model order on ``x``'s device (for ``x`` split
    along the sequence: gathered on every position, each attending over
    the whole sequence at its positions ``0 … S−1``, and the partials
    reduce-scattered onto the chunks). KV heads that do
    not split are whole: each position takes the ones its query heads
    read (:func:`kv_heads_of`), repeated as the reference repeats them.
    ``kv``, where given, receives every KV head's keys and values on
    ``x``'s device: the positions' own, gathered in model order, where
    ``w_k`` is split, else computed once there."""
    devices = p["w_q"].devices
    n = len(devices)
    theta = rope_theta or cfg.rope_theta
    per = _per_position(p, [k for k in p if k != "w_o"], devices)
    xs = tp.region_input(x, devices)
    partials, own = [], []
    for m, d in enumerate(devices):
        pm = {**per[m], "w_o": p["w_o"].chunks[m]}
        counts = None
        if not isinstance(p["w_k"], tp.Split):
            lo, counts = kv_heads_of(cfg.num_heads, cfg.num_kv_heads, m, n)
            for k, dim in (("w_k", 1), ("w_v", 1), ("b_k", 0), ("b_v", 0)):
                if k in pm:
                    pm[k] = pm[k].narrow(dim, lo, len(counts))
        positions = torch.arange(x.shape[1], device=d)[None, :]
        q, k, v = _gqa_qkv(pm, cfg, xs[m], positions, theta)
        own.append((k, v))
        if counts is not None and len(counts) != q.shape[2]:
            k, v = (torch.cat([t[:, :, i:i + 1].expand(-1, -1, c, -1)
                               for i, c in enumerate(counts)], dim=2) for t in (k, v))
        out = attend_causal(q, k, v, window=window, scale=1.0 / math.sqrt(cfg.head_dim),
                            q_chunk=q_chunk)
        partials.append(torch.einsum("bshk,hkd->bsd", out, pm["w_o"]))
    if kv is not None:
        if isinstance(p["w_k"], tp.Split):
            kv.extend(tp.all_gather(list(t), 2, x.device) for t in zip(*own))
        else:  # from the home position's copy of the whole sequence
            kv.extend(_gqa_kv(p, cfg, xs[0], torch.arange(x.shape[1], device=x.device)[None, :],
                              theta))
    return tp.region_output(partials, x)


def init_gqa_cache(
    cfg: AttentionConfig, batch: int, cache_len: int, window: int, dtype, device=None
) -> Params:
    size = min(cache_len, window) if window else cache_len
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, hkv, hd), dtype=dtype, device=device),
        "positions": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def prefill_gqa(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,
    cache: Params,
    *,
    window: int = 0,
    rope_theta: float = 0.0,
    q_chunk: int = 1024,
    donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    s = x.shape[1]
    if isinstance(p["w_q"], tp.Split):  # a group: its split forward's keys and values
        kv: list = []
        out = _apply_gqa_split(p, cfg, x, window=window, rope_theta=rope_theta,
                               q_chunk=q_chunk, kv=kv)
        return out, _fill_split(cache, dict(zip(("k", "v"), kv)), s, donate)
    if isinstance(x, tp.Split):  # whole weights: once on the home
        return tp.on_home(lambda h: prefill_gqa(p, cfg, h, cache, window=window,
                                                rope_theta=rope_theta, q_chunk=q_chunk,
                                                donate=donate), x)
    theta = rope_theta or cfg.rope_theta
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, cfg, x, positions, theta)
    out = attend_causal(q, k, v, window=window, scale=1.0 / math.sqrt(cfg.head_dim),
                        q_chunk=q_chunk)
    if isinstance(cache["k"], tp.Split):
        return (torch.einsum("bshk,hkd->bsd", out, p["w_o"]),
                _fill_split(cache, {"k": k, "v": v}, s, donate))
    size = cache["k"].shape[1]
    if size >= s:
        new_cache = _writable(cache, ("k", "v", "positions"), donate)
        new_cache["k"][:, :s] = k.to(new_cache["k"].dtype)
        new_cache["v"][:, :s] = v.to(new_cache["v"].dtype)
        new_cache["positions"][:s] = torch.arange(s, dtype=torch.int32, device=x.device)
    else:  # ring buffer smaller than the prompt: keep the last `size`
        ring = _ring_positions(size, s, x.device)
        new_cache = {
            "k": _ring_fill(cache["k"], k, s, donate),
            "v": _ring_fill(cache["v"], v, s, donate),
            "positions": cache["positions"].copy_(ring) if donate else ring,
        }
    return torch.einsum("bshk,hkd->bsd", out, p["w_o"]), new_cache


def _writable(cache: Params, names: tuple[str, ...], donate: bool) -> Params:
    """The buffers ``names`` of ``cache`` to write a prefill into: the
    caller's own when ``donate``, else copies."""
    return {name: cache[name] if donate else cache[name].clone() for name in names}


def _ring_fill(buf: torch.Tensor, seq: torch.Tensor, s: int, donate: bool) -> torch.Tensor:
    size = buf.shape[1]
    last = seq[:, s - size:]
    slots = torch.arange(s - size, s, device=buf.device) % size
    out = buf if donate else buf.clone()
    out[:, slots] = last.to(buf.dtype)
    return out


def _ring_positions(size: int, s: int, device=None) -> torch.Tensor:
    pos = torch.arange(s - size, s, dtype=torch.int32, device=device)
    out = torch.zeros((size,), dtype=torch.int32, device=device)
    out[pos.long() % size] = pos
    return out


def decode_gqa(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: Params,
    pos: int,  # current position
    *,
    window: int = 0,
    rope_theta: float = 0.0,
    donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    if isinstance(p["w_q"], tp.Split) or isinstance(cache["k"], tp.Split):
        return _decode_gqa_split(p, cfg, x, cache, pos, window=window, rope_theta=rope_theta,
                                 donate=donate)
    theta = rope_theta or cfg.rope_theta
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _gqa_qkv(p, cfg, x, positions, theta)
    size = cache["k"].shape[1]
    slot = (pos % size) if window else pos
    k_cache = _write_slot(cache["k"], k, slot, 1, donate=donate)
    v_cache = _write_slot(cache["v"], v, slot, 1, donate=donate)
    positions_c = _write_slot(cache["positions"], positions[0], slot, 0, donate=donate)
    mask = cache_mask(positions_c, pos, window)[None, None, :]  # (1,1,S)
    out = _attend(q, k_cache, v_cache, mask, scale=1.0 / math.sqrt(cfg.head_dim))
    out = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return out, {"k": k_cache, "v": v_cache, "positions": positions_c}


# --- serving over the model axis ----------------------------------------------


def _per_position(p: Params, names, devices) -> list[Params]:
    """Each model position's copy of the leaves ``names`` of ``p``: its
    chunk of a split leaf, a whole leaf fanned out from the home device."""
    per: list[Params] = [{} for _ in devices]
    for name in names:
        if name in p:
            w = p[name]
            parts = w.chunks if isinstance(w, tp.Split) else tp.fan_out(w, devices)
            for m, part in enumerate(parts):
                per[m][name] = part
    return per


def _heads_gathered(body, p: Params, names, x: torch.Tensor, positions, lead: str):
    """``body(leaves, x, positions)`` for every head on ``x``'s device: each
    position's heads (``p[lead]`` split over ``model``) gathered in model
    order along the heads dim, or ``body`` once on ``x``'s device where
    ``p[lead]`` is whole. ``body`` returns a tensor or a tuple of them,
    heads on dim 2."""
    w = p[lead]
    if not isinstance(w, tp.Split):
        return body(p, x, positions)
    devices = w.devices
    xs = tp.fan_out(x, devices)
    outs = [body(pm, xs[m], peer.to(positions, d))
            for m, (pm, d) in enumerate(zip(_per_position(p, names, devices), devices))]
    if isinstance(outs[0], tuple):
        return tuple(tp.all_gather(list(o), 2, x.device) for o in zip(*outs))
    return tp.all_gather(outs, 2, x.device)


def _as_split(buf, donate: bool) -> tp.Split:
    """A cache buffer as slot ranges over ``model`` (a whole buffer: one
    range): the caller's own tensors when ``donate``, else copies."""
    split = buf if isinstance(buf, tp.Split) else tp.Split((buf,), 1)
    return split if donate else split.map(torch.clone)


def _like(split: tp.Split, buf):
    return split if isinstance(buf, tp.Split) else split.chunks[0]


def _fill_split(cache: Params, new: Params, s: int, donate: bool) -> Params:
    """``cache`` with a prompt's ``new`` entries (name → (B, s, …)) written
    into the positions that own their slots: slots ``[0, s)``, or, for a
    ring smaller than the prompt, the last ``size`` tokens at ``t % size``
    (``_ring_fill``); ``positions`` on the home device as the one-device
    prefill writes it."""
    size = cache[next(iter(new))].shape[1]
    lo = max(0, s - size)
    slots = [t % size for t in range(lo, s)]
    out = {}
    for name, x in new.items():
        buf = _as_split(cache[name], donate)
        tp.write_slots(buf, x.narrow(1, lo, s - lo), slots)
        out[name] = _like(buf, cache[name])
    pos = cache["positions"] if donate else cache["positions"].clone()
    if lo:
        pos.copy_(_ring_positions(size, s, pos.device))
    else:
        pos[:s] = torch.arange(s, dtype=torch.int32, device=pos.device)
    out["positions"] = pos
    return out


def _write_token(cache: Params, new: Params, positions: torch.Tensor, slot: int,
                 donate: bool) -> tuple[Params, Params]:
    """``cache`` with one token's ``new`` entries written into ``slot``'s
    owner, and ``positions`` at ``slot``: (the buffers as ranges, the
    cache to return)."""
    ranges, out = {}, {}
    for name, x in new.items():
        ranges[name] = _as_split(cache[name], donate)
        tp.write_slots(ranges[name], x, [slot])
        out[name] = _like(ranges[name], cache[name])
    out["positions"] = _write_slot(cache["positions"], positions[0], slot, 0, donate=donate)
    return ranges, out


def _partial(scores: torch.Tensor, values: torch.Tensor, spec: str):
    """One slot range's partial softmax over its (masked) ``scores`` (…, S):
    ``(max, Σ exp(s - max), Σ exp(s - max)·values)``, f32, as ``_attend``
    computes its exponentials."""
    m = torch.amax(scores, dim=-1, keepdim=True).float()
    e = torch.exp(scores.float() - m)
    return m[..., 0], torch.sum(e, dim=-1), torch.einsum(spec, e, values.float())


def _row_parallel_heads(out: torch.Tensor, ws: tuple, body) -> torch.Tensor:
    """``body(out, *ws)`` with ``out``'s heads (dim 2) scattered to the
    positions of weights ``ws`` split over heads and the partials added in
    model order on ``out``'s device; ``body`` once where they are whole."""
    if not isinstance(ws[0], tp.Split):
        return body(out, *ws)
    outs = tp.scatter(out, 2, ws[0].devices)
    return tp.fan_in([body(o, *(w.chunks[m] for w in ws)) for m, o in enumerate(outs)],
                     out.device)


def _gqa_out(out, w_o):
    return torch.einsum("bshk,hkd->bsd", out, w_o)


def _decode_gqa_split(p: Params, cfg: AttentionConfig, x: torch.Tensor, cache: Params,
                      pos: int, *, window: int, rope_theta: float,
                      donate: bool) -> tuple[torch.Tensor, Params]:
    """A group's decode step: every head's query and the token's keys and
    values on the home device (heads computed on their positions and
    gathered), the keys and values written into their slot's owner, every
    range's owner scoring its slots for every query head, the partial
    softmaxes merged in model order (:func:`_partial`,
    ``tensor_parallel.merge_softmax``), then ``w_o`` row-parallel."""
    theta = rope_theta or cfg.rope_theta
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = _heads_gathered(lambda w, xm, pm: _gqa_q(w, cfg, xm, pm, theta), p,
                        ("w_q", "b_q", "q_norm"), x, positions, "w_q")
    k, v = _heads_gathered(lambda w, xm, pm: _gqa_kv(w, cfg, xm, pm, theta), p,
                           ("w_k", "w_v", "b_k", "b_v", "k_norm"), x, positions, "w_k")
    size = cache["k"].shape[1]
    slot = (pos % size) if window else min(pos, size - 1)
    ranges, new_cache = _write_token(cache, {"k": k, "v": v}, positions, slot, donate)
    mask = cache_mask(new_cache["positions"], pos, window)
    kc, vc = ranges["k"], ranges["v"]
    devices = kc.devices
    wdt = q.dtype
    scale_w = rounded(1.0 / math.sqrt(cfg.head_dim), wdt)
    qs, masks = tp.fan_out(q, devices), tp.scatter(mask, 0, devices)
    partials = []
    for r in range(len(devices)):
        kr, vr = _repeat_kv(kc.chunks[r], vc.chunks[r], q.shape[2])
        scores = torch.einsum("bthd,bshd->bhts", qs[r], kr) * scale_w
        scores = torch.where(masks[r], scores, _NEG_INF)
        partials.append(_partial(scores, vr, "bhts,bshd->bhtd"))
    out = tp.merge_softmax(partials, x.device).transpose(1, 2).to(wdt)
    return _row_parallel_heads(out, (p["w_o"],), _gqa_out), new_cache


# --- MLA (DeepSeek-V2) -------------------------------------------------------


def init_mla(rng: Init, cfg: AttentionConfig, d_model: int, dtype=torch.float32) -> Params:
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    lead = rng.lead
    return {
        "w_dq": dense_init(rng, d_model, ql, dtype),
        "q_norm": init_rms_norm(rng, ql),
        "w_uq": dense_init(rng, ql, h * (dn + dr), dtype).reshape(*lead, ql, h, dn + dr),
        "w_dkv": dense_init(rng, d_model, kl + dr, dtype),
        "kv_norm": init_rms_norm(rng, kl),
        "w_uk": dense_init(rng, kl, h * dn, dtype).reshape(*lead, kl, h, dn),
        "w_uv": dense_init(rng, kl, h * dv, dtype).reshape(*lead, kl, h, dv),
        "w_o": dense_init(rng, h * dv, d_model, dtype).reshape(*lead, h, dv, d_model),
    }


def linear_(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...i,io->...o", x, w)


def _mla_cq(p, x):
    return rms_norm(linear_(p["w_dq"], x), p["q_norm"])


def _mla_q_heads(w_uq, cfg, cq, positions, theta):
    dn = cfg.qk_nope_head_dim
    q = torch.einsum("bsl,lhk->bshk", cq, w_uq)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, theta)
    return q_nope, q_rope


def _mla_q(p, cfg, x, positions, theta):
    return _mla_q_heads(p["w_uq"], cfg, _mla_cq(p, x), positions, theta)


def _mla_latents(p, cfg, x, positions, theta):
    kl = cfg.kv_lora_rank
    ckv_full = linear_(p["w_dkv"], x)
    c_kv = rms_norm(ckv_full[..., :kl], p["kv_norm"])
    k_rope = apply_rope(ckv_full[..., kl:][:, :, None, :], positions, theta)[:, :, 0]
    return c_kv, k_rope


def _mla_heads(w: Params, cfg: AttentionConfig, cq, c_kv, k_rope, positions, theta,
               q_chunk: int) -> torch.Tensor:
    """The attention of the heads ``w`` holds (``w_uq``, ``w_uk``, ``w_uv``,
    ``w_o``: every head, or one model position's) from the shared latents,
    through their rows of the output projection."""
    b, s, _ = cq.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q_heads(w["w_uq"], cfg, cq, positions, theta)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, w["w_uk"])
    v = torch.einsum("bsl,lhk->bshk", c_kv, w["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(b, s, k_nope.shape[2], dr)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = attend_causal(q, k, v, scale=1.0 / math.sqrt(dn + dr), q_chunk=q_chunk)
    return torch.einsum("bshk,hkd->bsd", out, w["w_o"])


_MLA_HEADS = ("w_uq", "w_uk", "w_uv", "w_o")


def apply_mla(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,
    *,
    q_chunk: int = 1024,
    window: int = 0,
    rope_theta: float = 0.0,
) -> torch.Tensor:
    del window  # MLA archs here are full-attention
    if isinstance(p["w_uq"], tp.Split):
        return _apply_mla_split(p, cfg, x, q_chunk=q_chunk, rope_theta=rope_theta)
    if isinstance(x, tp.Split):  # whole weights: once on the home
        return tp.on_home(lambda h: apply_mla(p, cfg, h, q_chunk=q_chunk,
                                              rope_theta=rope_theta), x)
    theta = rope_theta or cfg.rope_theta
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    c_kv, k_rope = _mla_latents(p, cfg, x, positions, theta)
    return _mla_heads(p, cfg, _mla_cq(p, x), c_kv, k_rope, positions, theta, q_chunk)


def _apply_mla_split(p: Params, cfg: AttentionConfig, x, *, q_chunk: int,
                     rope_theta: float, latents: list | None = None):
    """MLA with its heads split over ``model`` (a group's
    ``tensor_parallel.Split`` weights): ``w_uq``/``w_uk``/``w_uv`` over
    heads, ``w_o`` row-parallel. The down-projections and their norms are
    whole: ``cq``, ``c_kv`` and the ``k_rope`` every head shares are
    computed once on ``x``'s device and fanned out (their gradients come
    back as model-order sums); each position attends with its heads, and
    the partial output projections are added in model order on ``x``'s
    device. Heads that do not divide over ``model`` leave these leaves
    whole, and :func:`apply_mla` runs where ``x`` is. For ``x`` split along
    the sequence: the sequence gathered on the home for the
    down-projections, and the partials reduce-scattered onto the chunks.
    ``latents``, where given, receives ``(c_kv, k_rope)``."""
    devices = p["w_uq"].devices
    theta = rope_theta or cfg.rope_theta
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    xh = tp.whole_on_home(x)
    c_kv, k_rope = _mla_latents(p, cfg, xh, positions, theta)
    if latents is not None:
        latents.extend((c_kv, k_rope))
    shared = [tp.fan_out(t, devices) for t in (_mla_cq(p, xh), c_kv, k_rope)]
    partials = []
    for m, d in enumerate(devices):
        w = {k: p[k].chunks[m] for k in _MLA_HEADS}
        positions = torch.arange(x.shape[1], device=d)[None, :]
        partials.append(_mla_heads(w, cfg, *(t[m] for t in shared), positions, theta, q_chunk))
    return tp.region_output(partials, x)


def init_mla_cache(
    cfg: AttentionConfig, batch: int, cache_len: int, window: int, dtype, device=None
) -> Params:
    del window
    return {
        "c_kv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device),
        "positions": torch.full((cache_len,), -1, dtype=torch.int32, device=device),
    }


def prefill_mla(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,
    cache: Params,
    *,
    q_chunk: int = 1024,
    window: int = 0,
    rope_theta: float = 0.0,
    donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    s = x.shape[1]
    theta = rope_theta or cfg.rope_theta
    if isinstance(p["w_uq"], tp.Split):  # a group: its split forward's latents
        latents: list = []
        out = _apply_mla_split(p, cfg, x, q_chunk=q_chunk, rope_theta=rope_theta,
                               latents=latents)
        return out, _fill_split(cache, dict(zip(("c_kv", "k_rope"), latents)), s, donate)
    if isinstance(x, tp.Split):  # whole weights: once on the home
        return tp.on_home(lambda h: prefill_mla(p, cfg, h, cache, q_chunk=q_chunk,
                                                rope_theta=rope_theta, donate=donate), x)
    out = apply_mla(p, cfg, x, q_chunk=q_chunk, window=window, rope_theta=rope_theta)
    positions = torch.arange(s, device=x.device)[None, :]
    c_kv, k_rope = _mla_latents(p, cfg, x, positions, theta)
    if isinstance(cache["c_kv"], tp.Split):
        return out, _fill_split(cache, {"c_kv": c_kv, "k_rope": k_rope}, s, donate)
    new_cache = _writable(cache, ("c_kv", "k_rope", "positions"), donate)
    new_cache["c_kv"][:, :s] = c_kv.to(new_cache["c_kv"].dtype)
    new_cache["k_rope"][:, :s] = k_rope.to(new_cache["k_rope"].dtype)
    new_cache["positions"][:s] = torch.arange(s, dtype=torch.int32, device=x.device)
    return out, new_cache


def decode_mla(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,  # (B, 1, D)
    cache: Params,
    pos: int,
    *,
    window: int = 0,
    rope_theta: float = 0.0,
    donate: bool = False,
) -> tuple[torch.Tensor, Params]:
    """Absorbed-matrix MLA decode: scores and outputs computed against
    the cached latents; W_uk folds into q, W_uv into the output."""
    del window
    if isinstance(p["w_uq"], tp.Split) or isinstance(cache["c_kv"], tp.Split):
        return _decode_mla_split(p, cfg, x, cache, pos, rope_theta=rope_theta, donate=donate)
    theta = rope_theta or cfg.rope_theta
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, positions, theta)  # (B,1,H,·)
    c_kv_t, k_rope_t = _mla_latents(p, cfg, x, positions, theta)
    c_kv = _write_slot(cache["c_kv"], c_kv_t, pos, 1, donate=donate)
    k_rope = _write_slot(cache["k_rope"], k_rope_t, pos, 1, donate=donate)
    positions_c = _write_slot(cache["positions"], positions[0], pos, 0, donate=donate)
    # absorb W_uk into the query: q_abs (B,1,H,kl); f32 (the reference's
    # promotion of its f32 query against the working-dtype weights)
    q_abs = torch.einsum("bthk,lhk->bthl", q_nope.float(), p["w_uk"].float())
    scores = torch.einsum("bthl,bsl->bhts", q_abs, c_kv.float()) + torch.einsum(
        "bthk,bsk->bhts", q_rope.float(), k_rope.float())
    scores = scores / math.sqrt(dn + dr)
    mask = cache_mask(positions_c, pos)[None, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out_latent = torch.einsum("bhts,bsl->bthl", w, c_kv.float())
    out = torch.einsum("bthl,lhk->bthk", out_latent, p["w_uv"].float())  # (B,1,H,dv)
    out = torch.einsum("bshk,hkd->bsd", out.to(x.dtype), p["w_o"])
    return out, {"c_kv": c_kv, "k_rope": k_rope, "positions": positions_c}


def _mla_absorbed_q(w: Params, cfg: AttentionConfig, cq, positions, theta):
    """The absorbed query ``q_nope·W_uk`` (f32, the reference's promotion)
    and the rope query of the heads ``w`` holds."""
    q_nope, q_rope = _mla_q_heads(w["w_uq"], cfg, cq, positions, theta)
    return torch.einsum("bthk,lhk->bthl", q_nope.float(), w["w_uk"].float()), q_rope


def _mla_out(dtype):
    """A merged latent's heads through ``w_uv`` (f32) and ``w_o``."""
    def body(lat, w_uv, w_o):
        out = torch.einsum("bthl,lhk->bthk", lat, w_uv.float())
        return torch.einsum("bshk,hkd->bsd", out.to(dtype), w_o)

    return body


def _decode_mla_split(p: Params, cfg: AttentionConfig, x: torch.Tensor, cache: Params,
                      pos: int, *, rope_theta: float, donate: bool) -> tuple[torch.Tensor, Params]:
    """A group's absorbed MLA decode step: ``cq`` and the token's latents
    on the home device (whole down-projections), every head's absorbed
    and rope query (each position's heads, gathered in model order), the
    latents written into their slot's owner, every range's owner scoring
    its slots of ``c_kv``/``k_rope`` for every head, the partial softmaxes
    merged in f32 in model order, and the merged ``out_latent`` through
    ``w_uv`` (f32) and ``w_o`` over heads, cast to the working dtype only
    after ``w_uv`` as the reference computes it."""
    theta = rope_theta or cfg.rope_theta
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_abs, q_rope = _heads_gathered(lambda w, cq, pm: _mla_absorbed_q(w, cfg, cq, pm, theta),
                                    p, ("w_uq", "w_uk"), _mla_cq(p, x), positions, "w_uq")
    c_kv_t, k_rope_t = _mla_latents(p, cfg, x, positions, theta)
    slot = min(pos, cache["c_kv"].shape[1] - 1)
    ranges, new_cache = _write_token(cache, {"c_kv": c_kv_t, "k_rope": k_rope_t}, positions,
                                     slot, donate)
    mask = cache_mask(new_cache["positions"], pos)
    devices = ranges["c_kv"].devices
    qas, qrs = tp.fan_out(q_abs, devices), tp.fan_out(q_rope, devices)
    masks = tp.scatter(mask, 0, devices)
    partials = []
    for r in range(len(devices)):
        c_kv = ranges["c_kv"].chunks[r].float()
        scores = torch.einsum("bthl,bsl->bhts", qas[r], c_kv) + torch.einsum(
            "bthk,bsk->bhts", qrs[r].float(), ranges["k_rope"].chunks[r].float())
        scores = torch.where(masks[r], scores / math.sqrt(dn + dr), _NEG_INF)
        partials.append(_partial(scores, c_kv, "bhts,bsl->bhtl"))
    out_latent = tp.merge_softmax(partials, x.device).transpose(1, 2)  # (B, 1, H, kl) f32
    return (_row_parallel_heads(out_latent, (p["w_uv"], p["w_o"]), _mla_out(x.dtype)),
            new_cache)


# --- dispatch ----------------------------------------------------------------

INIT = {"gqa": init_gqa, "mla": init_mla}
APPLY = {"gqa": apply_gqa, "mla": apply_mla}
INIT_CACHE = {"gqa": init_gqa_cache, "mla": init_mla_cache}
PREFILL = {"gqa": prefill_gqa, "mla": prefill_mla}
DECODE = {"gqa": decode_gqa, "mla": decode_mla}
