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

Every exchange between two positions of the model's mesh is also
logged by the position that sends it, the one that receives it and its
bytes (:func:`link_counts`; :func:`axis_crossed` names the mesh axis
the link crosses). The mesh code says which position it works for: a
group's home while the group computes (:func:`in_group`), a given
position around a copy or a per-position loop (:func:`at`). The dry
run (``repro_torch.launch.dryrun``) bills the storages and FLOPs of
each op to that position. Under :func:`distinct_positions` every move
between two positions is a copy even where the positions share a
device, so that M positions on one device (or on ``meta``) hold what M
cards would hold each.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

# ------------------------------ positions ------------------------------------

_GROUP: list[tuple[object, int]] = []  # (mesh, the group's home position)
_AT: list[int] = []  # positions named by the mesh code, innermost last
_DISTINCT: list[bool] = [False]
_TRACED: list[int | None] = [None]
_LINKS: dict[tuple[str, int, int], list[int]] = {}  # (kind, src, dst) -> [calls, bytes]
_LINKS_LOCK = threading.Lock()  # backward runs on one autograd thread a card
_BACKWARD = threading.local()  # the groups a backward runs for, on its own thread


@contextlib.contextmanager
def in_group(mesh, c: int):
    """The mesh code works for data index ``c``'s group of ``mesh``: its
    home is position ``c·M``, and model index m is position ``c·M + m``."""
    _GROUP.append((mesh, c * mesh.shape.get("model", 1)))
    try:
        yield
    finally:
        _GROUP.pop()


@contextlib.contextmanager
def at(p: int | None):
    """What runs inside works for position ``p`` (None: as outside)."""
    if p is None:
        yield
        return
    _AT.append(p)
    try:
        yield
    finally:
        _AT.pop()


def current_group() -> tuple[object, int] | None:
    """The current group, ``(mesh, home position)``, or None outside one: the
    group a backward runs for (:func:`backward_for`), else :func:`in_group`'s."""
    stack = getattr(_BACKWARD, "groups", None)
    if stack:
        return stack[-1]
    return _GROUP[-1] if _GROUP else None


@contextlib.contextmanager
def backward_for(group: tuple[object, int] | None):
    """What runs inside works for ``group`` (a :func:`current_group` taken
    in a forward), on this thread alone: a backward run by an autograd
    thread, or for several groups at once, bills the group its forward
    ran in."""
    stack = _BACKWARD.__dict__.setdefault("groups", [])
    stack.append(group)
    try:
        yield
    finally:
        stack.pop()


def group_position(m: int = 0) -> int | None:
    """The position of model index ``m`` of the current group, or None
    outside a group."""
    group = current_group()
    return group[1] + m if group else None


def group_mesh():
    """The current group's mesh (:func:`in_group`)."""
    return current_group()[0]


def device_of(p: int) -> torch.device:
    """Position ``p``'s device on the current group's mesh."""
    return current_group()[0].devices[p]


def named_position() -> int | None:
    """The position the mesh code last named with :func:`at`, or None."""
    return _AT[-1] if _AT else None


def working_position() -> int | None:
    """The position the mesh code last named (:func:`at`), else the
    current group's home, else None."""
    return _AT[-1] if _AT else group_position()


@contextlib.contextmanager
def distinct_positions():
    """Every move between two positions inside is a copy (see the module
    docstring): what the dry run traces, and what a card that holds every
    position runs to be held to it."""
    _DISTINCT.append(True)
    try:
        yield
    finally:
        _DISTINCT.pop()


def distinct() -> bool:
    return _DISTINCT[-1]


@contextlib.contextmanager
def traced_groups(k: int | None):
    """Only the first ``k`` groups compute inside (None: every one): the
    others stand in with zeros of the last computing group's results, and
    every exchange between groups still runs. The dry run's shortcut: all
    groups do the same work on the same shapes."""
    _TRACED.append(k)
    try:
        yield
    finally:
        _TRACED.pop()


def computes(c: int) -> bool:
    """Whether group ``c`` computes (:func:`traced_groups`)."""
    return _TRACED[-1] is None or c < _TRACED[-1]


def record(kind: str, src: int | None, dst: int | None, nbytes: int) -> None:
    """One exchange of ``nbytes`` from position ``src`` to ``dst`` (nothing
    when either is unknown or they are one position)."""
    if src is None or dst is None or src == dst:
        return
    with _LINKS_LOCK:
        entry = _LINKS.setdefault((kind, src, dst), [0, 0])
        entry[0] += 1
        entry[1] += nbytes


def reset_link_counts() -> None:
    _LINKS.clear()


def link_counts() -> dict[tuple[str, int, int], dict[str, int]]:
    """``(kind, sending position, receiving position)`` → its calls and
    bytes since the last reset."""
    return {k: {"calls": v[0], "bytes": v[1]} for k, v in _LINKS.items()}


def axis_crossed(shape: dict, src: int, dst: int) -> str:
    """The outermost axis of a mesh of ``shape`` (name → size, row-major
    positions) on which positions ``src`` and ``dst`` differ."""
    for i, name in enumerate(shape):
        inner = math.prod(list(shape.values())[i + 1:])
        if src // inner != dst // inner:
            return name
        src, dst = src % inner, dst % inner
    raise ValueError("one position does not cross an axis")


def send(x: torch.Tensor, device, src: int | None, dst: int | None,
         kind: str | None = None) -> torch.Tensor:
    """``x``, which position ``src`` holds (None: the host or an unplaced
    tensor), for position ``dst`` on ``device``: a copy made for ``dst``
    under :func:`distinct_positions` when the positions differ, else
    :func:`to`. ``kind`` logs the bytes as an exchange (:func:`record`)."""
    if kind is not None:
        record(kind, src, dst, x.numel() * x.element_size())
    if distinct() and (src is None or src != dst):
        with at(dst):
            return copy_into(torch.empty(x.shape, dtype=x.dtype, device=device), x)
    return to(x, device)


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
    sum, with one group's gradient alive at a time. Inside a group
    (:func:`in_group`) each part's bytes are logged as ``"reduce"`` from
    the position that holds it to the owner."""
    home = group_position()
    sequence = isinstance(term, (tuple, list))
    out = []
    for c, device in enumerate(sharding.devices):
        part = sharding.part(term, c)
        src = None if home is None else home + (c % sharding.model_size if sequence else 0)
        with at(c):
            if acc is None:
                record("reduce", src, c, part.numel() * part.element_size())
                out.append(copy_into(torch.empty_like(part, dtype=torch.float32, device=device),
                                     part))
            else:
                out.append(acc[c].add_(send(part, device, src, c, "reduce").float()))
    return out


def reduce_scatter(terms, sharding) -> list[torch.Tensor]:
    """Σ over positions of ``terms`` (one whole tensor a position), each
    owner's part on its device, added in card order (:func:`reduce_into`)."""
    acc = None
    for term in terms:
        acc = reduce_into(acc, term, sharding)
    return acc
