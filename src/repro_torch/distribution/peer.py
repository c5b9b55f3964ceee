"""Copies between the cards of a multi-card mesh, and the autograd
Function that spreads row bands to every card.

A sharded plan on a multi-card mesh (``repro_torch.plan.sharded``) moves
panels between cards at every layer: each card's partial rows to the
card that owns their band, and each owner's finished band to every
card. On a one-device mesh the same calls are plain slices: a copy to
the tensor's own device is the tensor itself.

A copy between two cards is PyTorch's own cross-device ``copy_``: it
runs on the source card's current stream, behind a two-way barrier with
the destination card's current stream, so it orders itself against the
work of both cards and needs no ``record_stream``. (A send and a receive
stream for each pair of cards was tried and measured against it:
``tools/torch_cards_run.py``, phase ``copy-modes``.)

The sums are never NCCL's or ``torch.distributed``'s: their ring order
gives other bits. Every sum across shards is written out in shard order
(``plan.sharded.sum_and_relu``, :class:`_Spread`'s backward), the order
of the one-card route, so the results are the same bits.

The model API's mesh moves leaves the same way
(``repro_torch.train.trainer``): :func:`all_gather` puts a leaf's chunks
together on one device in position order, and :func:`reduce_into` /
:func:`reduce_scatter` add each group's gradients onto the positions
that own each chunk, in card order. Within a group the model code's
collectives (``repro_torch.distribution.tensor_parallel``) are built on
:func:`copy_into`, :func:`to` and :func:`shard_order_sum`.
"""

from __future__ import annotations

import torch


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst ← src`` (a slice of a panel may be either), on the same
    device or between two cards. Returns ``dst``."""
    return dst.copy_(src, non_blocking=True)


def to(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on ``device``: ``x`` itself when it is there already, else a
    copy (:func:`copy_into`); differentiable."""
    device = torch.device(device)
    if x.device == device:
        return x
    return copy_into(torch.empty(x.shape, dtype=x.dtype, device=device), x)


def shard_order_sum(terms) -> torch.Tensor:
    """``t_0 + t_1 + … + t_{S-1}``, left to right: the one-card route's order."""
    z = terms[0]
    for t in terms[1:]:
        z = z + t
    return z


class _Spread(torch.autograd.Function):
    """Row bands, each on its owner's device, → one whole panel on every
    device of ``cards``. The backward brings each card's gradient of a
    band to the band's owner and adds them in card order: an explicit
    sum, where autograd's own accumulation of a tensor used on several
    cards adds in whatever order the cards' worker threads finish."""

    @staticmethod
    def forward(ctx, rows, cards, *bands):
        ctx.rows, ctx.owners = rows, [band.device for band in bands]
        shape = (rows[-1].stop, bands[0].shape[1])
        panels = []
        for card in cards:
            panel = torch.empty(shape, dtype=bands[0].dtype, device=card)
            for r, band in zip(rows, bands):
                copy_into(panel[r], band)
            panels.append(panel)
        return tuple(panels)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(shard_order_sum([to(g[r], owner) for g in grads])
                              for r, owner in zip(ctx.rows, ctx.owners)))


def spread(bands, rows, cards) -> tuple[torch.Tensor, ...]:
    """The panel whose rows ``rows[k]`` are ``bands[k]`` (on any device
    each), on every device of ``cards``; differentiable, its backward the
    card-order sum of the cards' gradients. One band of every row is a
    scatter of one panel to the cards."""
    return _Spread.apply(tuple(rows), tuple(torch.device(c) for c in cards), *bands)


def all_gather(chunks, dim: int, device) -> torch.Tensor:
    """The chunks of a leaf split along ``dim``, one a position, put
    together on ``device`` in position order (exact); a single chunk on
    ``device`` is returned as it is."""
    device = torch.device(device)
    if len(chunks) == 1 and chunks[0].device == device:
        return chunks[0]
    return torch.cat([to(c, device) for c in chunks], dim)


def reduce_into(acc, term: torch.Tensor, sharding) -> list[torch.Tensor]:
    """One group's gradient ``term`` added onto the owners: for every
    position c, ``acc[c]`` plus c's part of ``term`` (``sharding.part``:
    its chunk of a whole tensor, or of the group's model chunks when
    ``term`` is their sequence; the whole of a replicated leaf), in f32 on
    c's device. ``acc=None`` starts the sums with copies of the parts.
    Called for groups 0, 1, … in turn, it gives each owner the card-order
    sum, with one group's gradient alive at a time."""
    out = []
    for c, device in enumerate(sharding.devices):
        part = sharding.part(term, c)
        if acc is None:
            out.append(copy_into(torch.empty_like(part, dtype=torch.float32, device=device),
                                 part))
        else:
            out.append(acc[c].add_(to(part, device).float()))
    return out


def reduce_scatter(terms, sharding) -> list[torch.Tensor]:
    """Σ over positions of ``terms`` (one whole tensor a position), each
    owner's part on its device, added in card order (:func:`reduce_into`)."""
    acc = None
    for term in terms:
        acc = reduce_into(acc, term, sharding)
    return acc
