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
Where one data index's rows make smaller token groups than the whole
batch's, the indices' rows run together on the first one's home
(:func:`apply_moe_groups`), as the reference's groups of the whole batch.

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
from repro_torch.distribution import peer
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
    *,
    ordered: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). ``ordered``: the input's gradient adds
    its three uses' in a fixed order where the experts are split
    (:class:`_Uses`; the crossing groups' path, :func:`apply_moe_groups`)."""
    if isinstance(x, tp.Split):
        return tp.on_home(lambda h: apply_moe(p, cfg, h, act, glu), x)
    b, s0, d = x.shape
    x = _grouped(x)
    if ordered and _split(p):
        x, x_dispatch, x_shared = _Uses.apply(x, 3)
    else:
        x_dispatch = x_shared = x
    probs, combine, dispatch = _route(p["router"], cfg, x)
    e = cfg.num_experts

    # Switch/GShard load-balance loss: E · Σ_e f_e · P_e
    density = torch.mean((dispatch.sum(-1) > 0).float(), dim=1)  # (G,E) fraction routed
    mean_prob = torch.mean(probs, dim=1)
    aux = e * torch.mean(torch.sum(density * mean_prob, dim=-1))

    xe = torch.einsum("gsd,gsec->egcd", x_dispatch, dispatch.to(x.dtype))  # tokens → experts
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
        y = y + row_parallel(_shared, p["shared"], x_shared, act)
    return y.reshape(b, s0, d), aux


def _grouped(x: torch.Tensor) -> torch.Tensor:
    """``x`` (B, S, D) as its token groups (G, S_g, D)."""
    b, s0, d = x.shape
    s = _group_size(b * s0)
    return x.reshape(b * s0 // s, s, d)


def _route(router: torch.Tensor, cfg: MoEConfig, x: torch.Tensor):
    """The router's probabilities over the token groups ``x`` (G, S_g, D),
    and the combine and dispatch tensors of the groups' capacity
    (:func:`_top_k_dispatch`)."""
    capacity = max(1, -(-int(cfg.capacity_factor * x.shape[1] * cfg.top_k)
                        // cfg.num_experts))
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # (G,S,E)
    return (probs, *_top_k_dispatch(probs, cfg.top_k, capacity))


def _split(p: Params) -> bool:
    """Whether the experts or the shared experts are split over ``model``."""
    return isinstance(p["w_in"], tp.Split) or isinstance(p.get("shared", {}).get("w_in"),
                                                        tp.Split)


class _Uses(torch.autograd.Function):
    """``x`` for ``n`` uses, whose gradients add in their order. Autograd
    adds the gradients of a tensor used by several nodes in the order the
    nodes' backwards hand them over; with cards, each card's nodes run on
    that card's own autograd thread, so that order can follow the cards'
    timing, and the gathered rows of crossing groups gave 4 cards other
    bits than 4 positions of one card."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return peer.shard_order_sum([g for g in grads if g is not None]), None


def apply_moe_groups(p: Params, cfg: MoEConfig, xs, act: str, glu: bool,
                     homes) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """:func:`apply_moe` of the data indices' rows together, where their
    token groups cross data indices: ``xs[c]`` (B_c, S, D), data index c's
    input on its home, ``homes[c]`` its ``(device, position)``. The rows
    are gathered in data order on the first home
    (``tensor_parallel.moe_gather``), :func:`apply_moe` runs once on their
    concatenation with ``p``, that group's params (the whole batch's
    groups, capacity and sequence-order priority, as the reference's
    reshape of the whole batch), and each index gets its rows of the
    output back on its home (``tensor_parallel.moe_return``). Returns
    (each index's output, the aux loss once). Call it inside the first
    group (``peer.in_group``): its experts split over that group's
    ``model`` positions."""
    devices, positions = [d for d, _ in homes], [q for _, q in homes]
    y, aux = apply_moe(p, cfg, tp.moe_gather(xs, positions, devices[0]), act, glu,
                       ordered=True)
    return tp.moe_return(y, [x.shape[0] for x in xs], devices, positions), aux


def rerouted(router: torch.Tensor, cfg: MoEConfig, x: torch.Tensor, n: int) -> int:
    """How many (token, expert) assignments of the MoE input ``x`` (B, S, D)
    the token groups of ``n`` data indices' rows each would route
    otherwise than the whole batch's groups (kept by one, dropped by the
    other): 0 where the groups do not cross or drop nothing either way."""
    def kept(rows):
        _, _, dispatch = _route(router, cfg, _grouped(rows))
        return (dispatch.sum(-1) > 0).reshape(-1, cfg.num_experts)

    with torch.no_grad():
        alone = torch.cat([kept(rows) for rows in x.chunk(n, 0)], 0)
        return int((kept(x) != alone).sum())


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
