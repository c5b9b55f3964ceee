"""Mixture-of-Experts FFN — counterpart of ``repro/models/moe.py``: top-k
routing with GShard-style dense dispatch/combine (capacity-bounded),
shared experts, Switch aux loss.

On the model's mesh the expert banks are split over ``model`` (experts
``[m·E/M, (m+1)·E/M)`` on position m): the router, the dispatch and the
combine run once a group on its home device, each position runs its
experts on its slice of the dispatched tokens (``tensor_parallel.scatter``),
and the experts' outputs are concatenated back in model order (exact)
before the combine. The reference all-reduces the combine over ``model``
instead; the shared experts follow the FFN's column/row-parallel split.
A residual split along the sequence is gathered on the home device first
(``tensor_parallel.on_home``), so the token groups, the capacity and the
routing are the unsplit path's, and the output goes back by chunks.

The dispatch is expressed as einsums over a (groups, tokens, experts,
capacity) one-hot tensor, as the reference computes it. Tokens over
capacity are dropped (the residual passes them through). Capacity
depends on the group size, so a decode step (B tokens) and a forward
(B·S tokens) can drop differently.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.models.layers import Init, activation, dense_init, row_parallel

Params = dict[str, Any]


def init_moe(rng: Init, d_model: int, cfg: MoEConfig, glu: bool, dtype=torch.float32) -> Params:
    e, f = cfg.num_experts, cfg.d_expert

    def expert_bank(d_in, d_out):
        return rng.normal((e, d_in, d_out), dtype) * (1.0 / math.sqrt(d_in))

    p = {
        "router": dense_init(rng, d_model, e, dtype),
        "w_in": expert_bank(d_model, f),
        "w_out": expert_bank(f, d_model),
    }
    if glu:
        p["w_gate"] = expert_bank(d_model, f)
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * cfg.d_expert
        p["shared"] = {
            "w_in": dense_init(rng, d_model, fs, dtype),
            "w_gate": dense_init(rng, d_model, fs, dtype),
            "w_out": dense_init(rng, fs, d_model, dtype),
        }
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _top_k_dispatch(
    probs: torch.Tensor,  # (G, S, E) router probabilities
    top_k: int,
    capacity: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns combine (G,S,E,C) f32 and dispatch (G,S,E,C)."""
    e = probs.shape[-1]
    gate_vals, gate_idx = _top_k(probs, top_k)  # (G,S,k)
    gate_vals = gate_vals / torch.clamp_min(torch.sum(gate_vals, -1, keepdim=True), 1e-9)
    combine = torch.zeros_like(probs)
    dispatch_cnt = torch.zeros(probs.shape, dtype=torch.int32, device=probs.device)
    for i in range(top_k):
        onehot = F.one_hot(gate_idx[..., i], e)
        combine = combine + onehot.to(probs.dtype) * gate_vals[..., i:i + 1]
        dispatch_cnt = dispatch_cnt + onehot.to(torch.int32)
    # position of each token within its expert's queue (priority = seq order)
    pos_in_expert = torch.cumsum(dispatch_cnt, dim=1) - dispatch_cnt  # (G,S,E)
    keep = (dispatch_cnt > 0) & (pos_in_expert < capacity)
    # overflow maps to index `capacity`: a one-hot row of zeros (dropped)
    cap_onehot = F.one_hot(torch.where(keep, pos_in_expert, capacity).long(),
                           capacity + 1)[..., :capacity].to(probs.dtype)
    dispatch = cap_onehot * keep[..., None]  # (G,S,E,C)
    combine4 = combine[..., None] * dispatch
    return combine4, dispatch


def _group_size(total_tokens: int, target: int = 256) -> int:
    """Largest power of two ≤ target dividing total_tokens (GShard groups)."""
    g = 1
    while g < target and total_tokens % (g * 2) == 0:
        g *= 2
    return g


def apply_moe(
    p: Params,
    cfg: MoEConfig,
    x: torch.Tensor,  # (B, S, D) — flattened into (G, S_g, D) token groups
    act: str,
    glu: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss)."""
    if isinstance(x, tp.Split):
        return tp.on_home(lambda h: apply_moe(p, cfg, h, act, glu), x)
    b, s0, d = x.shape
    tokens = b * s0
    s = _group_size(tokens)
    x = x.reshape(tokens // s, s, d)
    e = cfg.num_experts
    capacity = max(1, -(-int(cfg.capacity_factor * s * cfg.top_k) // e))
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)  # (G,S,E)
    combine, dispatch = _top_k_dispatch(probs, cfg.top_k, capacity)

    # Switch/GShard load-balance loss: E · Σ_e f_e · P_e
    density = torch.mean((dispatch.sum(-1) > 0).float(), dim=1)  # (G,E) fraction routed
    mean_prob = torch.mean(probs, dim=1)
    aux = e * torch.mean(torch.sum(density * mean_prob, dim=-1))

    xe = torch.einsum("gsd,gsec->egcd", x, dispatch.to(x.dtype))  # tokens → experts
    banks = {k: p[k] for k in ("w_in", "w_gate", "w_out") if k in p}
    if isinstance(p["w_in"], tp.Split):
        # experts over model: each position runs its experts' slice of xe, and
        # their outputs come back whole (exact) for the combine, once a group
        devices = p["w_in"].devices
        xes = tp.scatter(xe, 0, devices)
        ye = tp.all_gather([_experts({k: w.chunks[m] for k, w in banks.items()}, xes[m], act,
                                     glu) for m in range(len(devices))], 0, xe.device)
    else:
        ye = _experts(banks, xe, act, glu)
    y = torch.einsum("egcd,gsec->gsd", ye, combine.to(x.dtype))  # experts → tokens

    if "shared" in p:
        y = y + row_parallel(_shared, p["shared"], x, act)
    return y.reshape(b, s0, d), aux


def _experts(p: Params, xe: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    """Each expert's FFN on its tokens: ``xe`` (E, G, C, D) → (E, G, C, D)."""
    h = torch.einsum("egcd,edf->egcf", xe, p["w_in"])
    if glu:
        gate = torch.einsum("egcd,edf->egcf", xe, p["w_gate"])
        h = activation(gate, act) * h
    else:
        h = activation(h, act)
    return torch.einsum("egcf,efd->egcd", h, p["w_out"])


def _shared(sp: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """The shared experts, a GLU FFN over every token."""
    hs = torch.einsum("gsd,df->gsf", x, sp["w_in"])
    hs = activation(torch.einsum("gsd,df->gsf", x, sp["w_gate"]), act) * hs
    return torch.einsum("gsf,fd->gsd", hs, sp["w_out"])
