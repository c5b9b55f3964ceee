"""The model axis within one group of positions — the port's counterpart of
what GSPMD inserts at the reference's ``constrain`` points
(``repro/models/attention.py``, ``moe.py``, ``model.py``,
``repro/distribution/sharding.py``).

On the model's mesh (``launch.mesh.make_local_mesh(data=D, model=M)``)
the M positions of a data index form a group that computes its rows
together (``train.trainer``). The group's copy of a leaf the spec splits
over ``model`` is a :class:`Split`: its M chunks, chunk m on position m's
device, each whole along ``data``. A leaf the spec does not split is a
tensor on the group's home device (model position 0), where the
activations between layers live, and a layer whose weights are whole
(a block-sparse FFN, a dim that does not divide) runs there, once a
group.

The model code moves activations with six differentiable collectives,
each an autograd Function built on ``peer.copy_into``/``peer.to`` and
``peer.shard_order_sum``:

* :func:`fan_out` — a tensor copied to the M devices; backward adds the M
  gradients in model order on the source (an explicit sum: autograd's
  own accumulation of a tensor used on several cards adds in whatever
  order the cards' worker threads finish);
* :func:`fan_in` — M partials added in model order onto one device (the
  reference's all-reduce of a row-parallel product); backward hands each
  partial the gradient;
* :func:`all_gather` — chunks concatenated in model order (exact);
  backward splits the gradient;
* :func:`scatter` — a tensor's M chunks, each to its device (exact);
  backward concatenates the gradients;
* :func:`reshard` — chunks split along one dim resplit along another
  (the tied table from d over ``model`` to vocab over ``model``, exact
  both ways);
* :func:`regroup` — chunks of a tensor made of equal parts (Mamba's
  ``[x_in | z]``), split contiguously, as chunks holding each position's
  slice of every part (an exact all-to-all both ways).

Sequence parallelism (the reference's ``ShardingRules(seq_axis="model")``,
turned on by ``sharding.constrain``) holds the residual stream between the
tensor-parallel regions as a :class:`Split` along the sequence (dim 1),
chunk m on model position m: norms, residual adds and the embedding's rows
run on each chunk. Three more collectives move it:

* :func:`seq_gather` — the chunks concatenated in model order on each
  receiving position (a region's input on every position, or the whole
  sequence on the home for a layer that runs there); backward: a
  reduce-scatter, chunk m's rows of every receiver's gradient added in
  model order on position m;
* :func:`seq_reduce` — partials, one a position, as chunks: position m
  adds every partial's rows of chunk m in model order (a row-parallel
  region's output; one partial is a scatter); backward: a gather;
* :func:`fan_out` with ``kind="param_copy"`` — a leaf the group holds
  whole on its home copied to the positions whose chunks use it (a norm's
  scale); backward: the chunks' partial gradients added in model order.

:func:`region_input`, :func:`region_output` and :func:`on_home` pick the
collective by the residual's layout, so a model's code runs the same
whether or not its sequence is split.

Every sum is written out in model order, never NCCL's, so M positions on
one device and M cards give the same bits. :func:`exchange_counts`
reports the bytes each collective moves between model positions
(forward and backward; model position 0 is the group's home), counted
whether or not the positions share a device; inside a group
(``peer.in_group``) each move is also logged by the position that sends
it and the one that receives it (``peer.link_counts``), and under
``peer.distinct_positions`` each is a copy made for its receiver.
:func:`logging_exchanges` records each call's shapes so a caller can
replay a step's exchanges on their own (:func:`replay`).

The model axis covers every layer kind of the train step: GQA and MLA
attention, Mamba, RWKV-6's time and channel mix, dense and MoE FFNs, the
paper's MLP, the embedding and the head. Serving adds a decode cache
split over ``model`` (``cache_pspecs``: the attention caches' slots, a
``cache_seq`` range a position; Mamba's and RWKV-6's states by channel
and head, which follow their weights) and three forward-only exchanges:
:func:`write_slots` (new keys, values or latents to the positions that
own their slots), :func:`merge_softmax` (each slot range's partial
softmax, ``(max, Σexp, Σexp·v)``, merged in model order on the home
device) and :func:`replicate_into` (a cache leaf every position holds
whole, copied from the position that wrote it).

A MoE layer whose token groups cross data indices (the whole batch makes
larger groups than one data index's rows) runs once, on the first data
index's home, over every index's rows: the reference's groups of the
whole batch. Two exchanges between groups move its input and output,
between each group's home and position 0, counted and logged by the
absolute positions they join (they cross ``data``, or ``pod``):

* :func:`moe_gather` — each data index's rows concatenated in data order
  on position 0 (exact); backward: each index's rows of the gradient
  handed back to its home;
* :func:`moe_return` — each data index's rows of the output sent to its
  home (exact); backward: their gradients concatenated on position 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.distribution import peer


@dataclasses.dataclass(frozen=True, eq=False)
class Split:
    """A group's copy of a leaf split over ``model``: ``chunks[m]`` on
    model position m's device, split along ``dim``. Reads like the whole
    leaf (shape, dtype) and indexes like it along a leading layer dim, which
    is never split (a period's stacked leaves). A group's view of a placed
    cache leaf is one too, its chunks the placed storages, and so is a
    residual split along the sequence (``dim`` 1)."""

    chunks: tuple[torch.Tensor, ...]
    dim: int

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(c.device for c in self.chunks)

    @property
    def shape(self) -> torch.Size:
        shape = list(self.chunks[0].shape)
        shape[self.dim] = sum(c.shape[self.dim] for c in self.chunks)
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    @property
    def ndim(self) -> int:
        return self.chunks[0].ndim

    def is_floating_point(self) -> bool:
        return self.chunks[0].is_floating_point()

    @property
    def device(self) -> torch.device:
        """The home device, model position 0's."""
        return self.chunks[0].device

    def map(self, fn) -> "Split":
        return Split(tuple(fn(c) for c in self.chunks), self.dim)

    def to(self, dtype: torch.dtype) -> "Split":
        return self.map(lambda c: c.to(dtype))

    def __getitem__(self, i: int) -> "Split":
        if not isinstance(i, int) or self.dim == 0:
            raise IndexError(f"a Split along dim {self.dim} indexes its leading dim only")
        return Split(tuple(c[i] for c in self.chunks), self.dim - 1)


# ------------------------------ accounting -----------------------------------

_COUNTS: dict[str, dict[str, int]] = {}
_BY_GROUP: dict[int, dict[str, dict[str, int]]] = {}  # a group's home → its own calls
_COUNTS_LOCK = threading.Lock()
_LOG: list | None = None


def _total(kind: str, nbytes: int, home: int | None = None) -> None:
    with _COUNTS_LOCK:  # backward runs on one autograd thread a card
        for counts in (_COUNTS, _BY_GROUP.setdefault(home, {}) if home is not None else {}):
            c = counts.setdefault(kind, {"calls": 0, "bytes": 0})
            c["calls"] += 1
            c["bytes"] += nbytes


def _count(kind: str, moves) -> None:
    """One call of ``kind`` and its ``moves``, ``(sending model index,
    receiving model index, bytes)``: the totals (and the current group's
    own, :func:`group_exchange_counts`), and each move by position
    (``peer.record``, from the current group's home)."""
    moves = list(moves)
    home = peer.group_position()
    _total(kind, sum(n for _, _, n in moves), home)
    if home is not None:
        for src, dst, n in moves:
            peer.record(kind, home + src, home + dst, n)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def reset_exchange_counts() -> None:
    _COUNTS.clear()
    _BY_GROUP.clear()


def exchange_counts() -> dict[str, dict[str, int]]:
    """Per collective, its calls (forward and backward) and the bytes they
    moved from one position to another since the last reset."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def group_exchange_counts() -> dict[int, dict[str, dict[str, int]]]:
    """:func:`exchange_counts` of the calls made inside a group
    (``peer.in_group``), by the group's home position."""
    return {home: {k: dict(v) for k, v in counts.items()} for home, counts in _BY_GROUP.items()}


@contextlib.contextmanager
def logging_exchanges():
    """Records each forward call's kind and shapes in the yielded list
    (entries for :func:`replay`)."""
    global _LOG
    prev, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = prev


def _log(kind: str, **meta) -> None:
    if _LOG is not None:
        _LOG.append((kind, meta))


# ------------------------------ collectives ----------------------------------


def _in_forward_group(cls):
    """``cls``'s backward works for the group its forward ran in
    (``peer.backward_for``): a backward taken for several groups at once
    (the layer-major train step) counts and bills each group's moves as
    its forward did."""
    forward, backward = cls.forward, cls.backward

    def forward_in_group(ctx, *args):
        ctx.group = peer.current_group()
        return forward(ctx, *args)

    def backward_in_group(ctx, *grads):
        with peer.backward_for(ctx.group):
            return backward(ctx, *grads)

    cls.forward, cls.backward = staticmethod(forward_in_group), staticmethod(backward_in_group)
    return cls


def _to(x: torch.Tensor, device: torch.device, src: int = 0, dst: int = 0) -> torch.Tensor:
    """``x``, which model index ``src`` holds, for model index ``dst`` on
    ``device``, laid out as ``peer.to`` lays out a copy on another device
    (contiguous): a view of ``x`` where it lies already, or a contiguous
    copy of it there (a copy made for ``dst`` under
    ``peer.distinct_positions`` when the indices differ). A kernel may sum
    in another order for other strides, and M positions on one device must
    give M cards' bits."""
    if x.device != device or (src != dst and peer.distinct()):
        return _send(x, device, src, dst)
    return x.view_as(x) if x.is_contiguous() else x.contiguous()


def _send(x: torch.Tensor, device: torch.device, src: int, dst: int) -> torch.Tensor:
    """``peer.send`` between model indices of the current group."""
    home = peer.group_position()
    return peer.send(x, device, None if home is None else home + src,
                     None if home is None else home + dst) if src != dst else peer.to(x, device)


def _at(m: int):
    """``peer.at`` model index ``m`` of the current group."""
    return peer.at(peer.group_position(m))


@_in_forward_group
class _FanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices, kind):
        ctx.home, ctx.kind = x.device, kind
        _count(kind, ((0, i, _nbytes(x)) for i in range(1, len(devices))))
        return tuple(_to(x, d, 0, i) for i, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        live = [(i, g) for i, g in enumerate(grads) if g is not None]
        _count(ctx.kind, ((i, 0, _nbytes(g)) for i, g in live if i))
        with _at(0):
            total = (peer.shard_order_sum([_send(g, ctx.home, i, 0) for i, g in live])
                     if live else None)
        return total, None, None


def fan_out(x: torch.Tensor, devices, *, kind: str = "fan_out") -> tuple[torch.Tensor, ...]:
    """``x`` on each of ``devices`` (where it lies already, a view of it, or a
    contiguous copy when it is not contiguous: :func:`_to`); its
    backward adds the devices' gradients in their order on ``x``'s device.
    ``kind``: the name its bytes are counted under."""
    devices = tuple(torch.device(d) for d in devices)
    _log(kind, shape=tuple(x.shape), dtype=x.dtype, home=x.device, devices=devices)
    return _FanOut.apply(x, devices, kind)


@_in_forward_group
class _FanIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *partials):
        ctx.devices = [p.device for p in partials]
        _count("fan_in", ((m, 0, _nbytes(p)) for m, p in enumerate(partials) if m))
        with _at(0):
            return peer.shard_order_sum([_send(p, device, m, 0)
                                         for m, p in enumerate(partials)])

    @staticmethod
    def backward(ctx, g):
        _count("fan_in", ((0, m, _nbytes(g)) for m in range(1, len(ctx.devices))))
        return (None, *(_to(g, d, 0, m) for m, d in enumerate(ctx.devices)))


def fan_in(partials, device) -> torch.Tensor:
    """Σ ``partials`` in their order on ``device``; the backward hands each
    partial the gradient on its own device."""
    device = torch.device(device)
    _log("fan_in", shapes=[tuple(p.shape) for p in partials], dtype=partials[0].dtype,
         home=device, devices=tuple(p.device for p in partials))
    return _FanIn.apply(device, *partials)


@_in_forward_group
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, device, *chunks):
        ctx.dim, ctx.devices = dim, [c.device for c in chunks]
        ctx.sizes = [c.shape[dim] for c in chunks]
        _count("all_gather", ((m, 0, _nbytes(c)) for m, c in enumerate(chunks) if m))
        with _at(0):
            return torch.cat([_send(c, device, m, 0) for m, c in enumerate(chunks)], dim)

    @staticmethod
    def backward(ctx, g):
        pieces = g.split(ctx.sizes, ctx.dim)
        _count("all_gather", ((0, m, _nbytes(p)) for m, p in enumerate(pieces) if m))
        return (None, None, *(_to(p, d, 0, m) for m, (p, d) in enumerate(zip(pieces,
                                                                             ctx.devices))))


def all_gather(chunks, dim: int, device) -> torch.Tensor:
    """The chunks concatenated along ``dim`` in their order on ``device``;
    the backward sends each chunk its slice of the gradient."""
    device = torch.device(device)
    dim = dim % chunks[0].ndim
    _log("all_gather", shapes=[tuple(c.shape) for c in chunks], dtype=chunks[0].dtype,
         home=device, devices=tuple(c.device for c in chunks), dim=dim)
    return _AllGather.apply(dim, device, *chunks)


@_in_forward_group
class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, devices):
        ctx.dim, ctx.home = dim, x.device
        pieces = x.chunk(len(devices), dim)
        ctx.shapes = [p.shape for p in pieces]
        _count("scatter", ((0, i, _nbytes(p)) for i, p in enumerate(pieces) if i))
        return tuple(_to(p, d, 0, i) for i, (p, d) in enumerate(zip(pieces, devices)))

    @staticmethod
    def backward(ctx, *grads):
        _count("scatter", ((i, 0, _nbytes(g)) for i, g in enumerate(grads)
                           if i and g is not None))
        dtype = next(g for g in grads if g is not None).dtype
        with _at(0):
            parts = [torch.zeros(s, dtype=dtype, device=ctx.home) if g is None else
                     _send(g, ctx.home, i, 0) for i, (s, g) in enumerate(zip(ctx.shapes, grads))]
            return torch.cat(parts, ctx.dim), None, None


def scatter(x: torch.Tensor, dim: int, devices) -> tuple[torch.Tensor, ...]:
    """``x``'s M equal chunks along ``dim``, chunk m on ``devices[m]``; the
    backward concatenates the gradients on ``x``'s device."""
    devices = tuple(torch.device(d) for d in devices)
    if x.shape[dim] % len(devices):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {len(devices)}")
    _log("scatter", shape=tuple(x.shape), dtype=x.dtype, home=x.device, devices=devices, dim=dim)
    return _Scatter.apply(x, dim, devices)


def _resplit(chunks, devices, whole_dim: int, split_dim: int):
    """Chunk ``m`` of the result: every chunk's m-th slice along
    ``split_dim``, concatenated along ``whole_dim`` on ``devices[m]``."""
    size = chunks[0].shape[split_dim] // len(devices)
    moves = [(j, m, _nbytes(c) // len(devices)) for j, c in enumerate(chunks)
             for m in range(len(devices)) if j != m]
    out = []
    for m, d in enumerate(devices):
        with _at(m):
            out.append(torch.cat([_send(c.narrow(split_dim, m * size, size), d, j, m)
                                  for j, c in enumerate(chunks)], whole_dim))
    return moves, tuple(out)


@_in_forward_group
class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src_dim, dst_dim, *chunks):
        ctx.src_dim, ctx.dst_dim = src_dim, dst_dim
        ctx.devices = [c.device for c in chunks]
        moved, out = _resplit(chunks, ctx.devices, src_dim, dst_dim)
        _count("reshard", moved)
        return out

    @staticmethod
    def backward(ctx, *grads):
        moved, out = _resplit(grads, ctx.devices, ctx.dst_dim, ctx.src_dim)
        _count("reshard", moved)
        return (None, None, *out)


def reshard(chunks, src_dim: int, dst_dim: int) -> tuple[torch.Tensor, ...]:
    """Chunks of one tensor split along ``src_dim`` (chunk m on its device)
    as its chunks split along ``dst_dim``, chunk m on the same device;
    the backward resplits the gradients back (both exact)."""
    if chunks[0].shape[dst_dim] % len(chunks):
        raise ValueError(f"dim {dst_dim} of {tuple(chunks[0].shape)} does not split over "
                         f"{len(chunks)}")
    _log("reshard", shapes=[tuple(c.shape) for c in chunks], dtype=chunks[0].dtype,
         devices=tuple(c.device for c in chunks), src_dim=src_dim, dst_dim=dst_dim)
    return _Reshard.apply(src_dim, dst_dim, *chunks)


def _move_pieces(tensors, devices, dim: int, parts: int, source):
    """Tensor ``i`` of the result, on ``devices[i]``: its ``parts`` slots
    concatenated along ``dim``, slot ``k`` being piece ``q`` (of ``parts``
    equal pieces along ``dim``) of ``tensors[j]``, ``(j, q) = source(i,
    k)``. Also returns the moves of the pieces that change position."""
    width = tensors[0].shape[dim] // parts
    pieces = [t.split(width, dim) for t in tensors]
    moves, out = [], []
    for i, d in enumerate(devices):
        got = []
        with _at(i):
            for k in range(parts):
                j, q = source(i, k)
                if j != i:
                    moves.append((j, i, _nbytes(pieces[j][q])))
                got.append(_send(pieces[j][q], d, j, i))
            out.append(torch.cat(got, dim))
    return moves, tuple(out)


@_in_forward_group
class _Regroup(torch.autograd.Function):
    """Piece ``r`` of chunk ``m`` is global slice ``f = parts·m + r``: part
    ``f // M``, slice ``f % M``. Chunk ``o`` of the result holds slice
    ``o`` of each part, in part order."""

    @staticmethod
    def forward(ctx, dim, parts, *chunks):
        ctx.dim, ctx.parts = dim, parts
        ctx.devices = [c.device for c in chunks]
        n = len(chunks)
        moved, out = _move_pieces(chunks, ctx.devices, dim, parts,
                                  lambda o, part: divmod(part * n + o, parts))
        _count("regroup", moved)
        return out

    @staticmethod
    def backward(ctx, *grads):
        n, parts = len(grads), ctx.parts
        moved, out = _move_pieces(grads, ctx.devices, ctx.dim, parts,
                                  lambda m, r: divmod(parts * m + r, n)[::-1])
        _count("regroup", moved)
        return (None, None, *out)


def regroup(chunks, dim: int, parts: int) -> tuple[torch.Tensor, ...]:
    """Chunks (chunk m on its device) of a tensor made of ``parts`` equal
    parts along ``dim`` and split contiguously along it over ``model``, as
    M chunks of the same size: chunk m, on the same device, the
    concatenation of slice m of every part (Mamba's ``in_proj`` product
    ``[x_in | z]`` as each position's ``[x_in_m | z_m]``). Exact both
    ways; a piece that stays on its position is not counted."""
    dim = dim % chunks[0].ndim
    if chunks[0].shape[dim] % parts:
        raise ValueError(f"chunks of {tuple(chunks[0].shape)} along dim {dim} do not hold "
                         f"{parts} parts that split over {len(chunks)}")
    _log("regroup", shapes=[tuple(c.shape) for c in chunks], dtype=chunks[0].dtype,
         devices=tuple(c.device for c in chunks), dim=dim, parts=parts)
    return _Regroup.apply(dim, parts, *chunks)


# --------------------------- sequence parallelism -----------------------------


@_in_forward_group
class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, receivers, devices, *chunks):
        ctx.dim, ctx.receivers = dim, receivers
        ctx.devices = [c.device for c in chunks]
        ctx.sizes = [c.shape[dim] for c in chunks]
        _count("seq_gather", ((m, r, _nbytes(c)) for r in receivers
                              for m, c in enumerate(chunks) if m != r))
        shared: dict = {}  # positions sharing a device share its copy, as fan_out's views
        out = []
        for r, d in zip(receivers, devices):
            if not peer.distinct() and d in shared:
                out.append(shared[d].view_as(shared[d]))
                continue
            with _at(r):
                whole = torch.cat([_send(c, d, m, r) for m, c in enumerate(chunks)], dim)
            shared[d] = whole
            out.append(whole)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        live = [(r, g) for r, g in zip(ctx.receivers, grads) if g is not None]
        moves, out = [], []
        for m, (d, n) in enumerate(zip(ctx.devices, ctx.sizes)):
            o = sum(ctx.sizes[:m])
            with _at(m):
                pieces = [_send(g.narrow(ctx.dim, o, n), d, r, m) for r, g in live]
                moves += [(r, m, _nbytes(p)) for (r, _), p in zip(live, pieces) if r != m]
                out.append(_own(peer.shard_order_sum(pieces)) if pieces else None)
        _count("seq_gather", moves)
        return (None, None, None, *out)


def _own(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous: a chunk a position holds as a card would."""
    return x if x.is_contiguous() else x.contiguous()


def seq_gather(x: Split, receivers=None) -> tuple[torch.Tensor, ...]:
    """The whole sequence of ``x`` (a :class:`Split` along it) on each of
    the model indices ``receivers`` (default every one), its chunks
    concatenated in model order there (exact; positions that share a
    device share one copy, except under ``peer.distinct_positions``). The
    backward is a reduce-scatter: chunk m's gradient is the sum of every
    receiver's gradient rows of chunk m, in model order, on position m."""
    receivers = tuple(range(len(x.chunks)) if receivers is None else receivers)
    devices = tuple(x.chunks[r].device for r in receivers)
    _log("seq_gather", shapes=[tuple(c.shape) for c in x.chunks], dtype=x.dtype,
         devices=x.devices, dim=x.dim, receivers=receivers)
    return _SeqGather.apply(x.dim, receivers, devices, *x.chunks)


@_in_forward_group
class _SeqReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *partials):
        ctx.dim, ctx.homes = dim, [p.device for p in partials]
        n = partials[0].shape[dim] // len(devices)
        moves, out = [], []
        for m, d in enumerate(devices):
            with _at(m):
                pieces = [_send(p.narrow(dim, m * n, n), d, j, m) for j, p in enumerate(partials)]
                out.append(_own(peer.shard_order_sum(pieces)))
            moves += [(j, m, _nbytes(p)) for j, p in enumerate(pieces) if j != m]
        _count("seq_reduce", moves)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        moves, out = [], []
        for j, d in enumerate(ctx.homes):
            with _at(j):
                out.append(torch.cat([_send(g, d, m, j) for m, g in enumerate(grads)], ctx.dim))
            moves += [(m, j, _nbytes(g)) for m, g in enumerate(grads) if m != j]
        _count("seq_reduce", moves)
        return (None, None, *out)


def seq_reduce(partials, dim: int, devices) -> Split:
    """Partials of a sequence (partial j on model index j, each whole along
    ``dim``) as a :class:`Split` along ``dim`` over ``devices``: chunk m, on
    ``devices[m]``, the sum of every partial's rows of the m-th of
    ``len(devices)`` equal chunks, in model order (one partial: a scatter,
    exact). The backward gathers the chunks' gradients on each partial's
    position."""
    devices = tuple(torch.device(d) for d in devices)
    dim = dim % partials[0].ndim
    if partials[0].shape[dim] % len(devices):
        raise ValueError(f"dim {dim} of {tuple(partials[0].shape)} does not split over "
                         f"{len(devices)}")
    _log("seq_reduce", shapes=[tuple(p.shape) for p in partials], dtype=partials[0].dtype,
         homes=tuple(p.device for p in partials), devices=devices, dim=dim)
    return Split(_SeqReduce.apply(dim, devices, *partials), dim)


def region_input(x, devices) -> tuple[torch.Tensor, ...]:
    """A tensor-parallel region's input on each of ``devices`` (a group's
    positions): ``x`` fanned out from the home, or, for ``x`` split along the
    sequence, gathered on every position (:func:`seq_gather`)."""
    if isinstance(x, Split):
        if tuple(torch.device(d) for d in devices) != x.devices:
            raise ValueError(f"a sequence split over {x.devices} enters a region over {devices}")
        return seq_gather(x)
    return fan_out(x, devices)


def region_output(partials, x):
    """A row-parallel region's partials (one a position) combined in model
    order, laid out as the region's input ``x``: summed on its home
    device, or, for ``x`` split along the sequence, reduce-scattered onto
    its chunks (:func:`seq_reduce`)."""
    if isinstance(x, Split):
        return seq_reduce(partials, x.dim, x.devices)
    return fan_in(partials, x.device)


def whole_on_home(x) -> torch.Tensor:
    """``x`` whole on the home device: a sequence split gathered there."""
    return seq_gather(x, (0,))[0] if isinstance(x, Split) else x


def on_home(fn, x):
    """``fn(x)`` for a layer that runs once a group on the home device: for
    ``x`` split along the sequence, ``fn`` of the whole sequence gathered
    there, and its result (a tensor, or a tuple whose first item is the
    layer's output) handed back as chunks (a scatter)."""
    if not isinstance(x, Split):
        return fn(x)
    out = fn(whole_on_home(x))
    if isinstance(out, tuple):
        return (seq_reduce([out[0]], x.dim, x.devices), *out[1:])
    return seq_reduce([out], x.dim, x.devices)


def last_tokens(x, n: int = 1) -> torch.Tensor:
    """The last ``n`` positions of a sequence on the home device: ``x[:,
    -n:]``, or, for ``x`` split along it, the last chunk's sent there
    (counted as ``"seq_gather"``; ``n`` must fit in the chunk)."""
    if not isinstance(x, Split):
        return x[:, -n:]
    last = len(x.chunks) - 1
    piece = x.chunks[last].narrow(x.dim, x.chunks[last].shape[x.dim] - n, n)
    _count("seq_gather", [(last, 0, _nbytes(piece))])
    with _at(0):
        return _own(_send(piece, x.device, last, 0))


def embed_lookup(table: Split, ids: torch.Tensor, *, by_sequence: bool = False):
    """``table[ids]`` for a table split along d over ``model``: each
    position looks its chunk's columns up, and the rows are concatenated in
    model order on ``ids``' device (exact). ``by_sequence``: the rows
    resharded from d to the sequence instead (:func:`reshard`, exact), a
    :class:`Split` along dim 1, each position its chunk of the tokens with
    every column; nothing is gathered on the home."""
    rows = [c[_send(ids, c.device, 0, m).long()] for m, c in enumerate(table.chunks)]
    if by_sequence:
        return Split(reshard(rows, rows[0].ndim - 1, 1), 1)
    return all_gather(rows, -1, ids.device)


# ------------------------ serving: the split cache --------------------------


def slot_runs(slots, per: int) -> list[tuple[int, int, int, int]]:
    """``(first entry, owner, first local slot, length)`` of each run of
    consecutive entries of ``slots`` (host ints) that land on consecutive
    slots of one owner, where owner m holds slots ``[m·per, (m+1)·per)``."""
    runs: list[list[int]] = []
    for i, slot in enumerate(slots):
        owner, local = divmod(slot, per)
        if runs and runs[-1][1] == owner and runs[-1][2] + runs[-1][3] == local:
            runs[-1][3] += 1
        else:
            runs.append([i, owner, local, 1])
    return [tuple(r) for r in runs]


def write_slots(cache: Split, x: torch.Tensor, slots) -> None:
    """``x``'s entries along ``cache.dim`` written, in place, into the
    slots ``slots`` (host ints, one an entry) of the cache split into
    equal slot ranges over ``model``: each run of them to the position
    that owns its slots (slot s: position ``s // (size/M)``), cast to the
    cache's dtype. Forward only (serving has no backward); the bytes that
    leave ``x``'s position for another are counted as ``"write"``."""
    dim, per = cache.dim, cache.chunks[0].shape[cache.dim]
    runs = slot_runs(slots, per)
    _log("write", shape=tuple(x.shape), dtype=x.dtype, home=x.device, devices=cache.devices,
         dim=dim, runs=runs)
    moves = []
    for i, owner, local, n in runs:
        piece = x.narrow(dim, i, n)
        if owner:
            moves.append((0, owner, _nbytes(piece)))
        peer.copy_into(cache.chunks[owner].narrow(dim, local, n), piece)
    _count("write", moves)


def merge_softmax(partials, device) -> torch.Tensor:
    """The softmax-weighted sum over every slot range, from each range's
    partial ``(m, l, acc)``: its scores' max ``m`` (…, T), ``l = Σ exp(s -
    m)`` (…, T) and ``acc = Σ exp(s - m)·v`` (…, T, dv), all f32, one range
    a model position. Moved to ``device`` and merged in model order:
    ``Σ_r e^{m_r - M}·acc_r / Σ_r e^{m_r - M}·l_r`` with ``M = max_r m_r``. A
    range whose every slot is masked (scores -1e30) weighs exactly 0 as
    long as one range holds a live slot. Forward only (serving has no
    backward); the partials of positions past the home are counted as
    ``"merge"``."""
    device = torch.device(device)
    _log("merge", shapes=[tuple(t.shape) for t in partials[0]], dtype=partials[0][2].dtype,
         home=device, devices=tuple(p[2].device for p in partials))
    _count("merge", ((r, 0, sum(_nbytes(t) for t in p)) for r, p in enumerate(partials) if r))
    with _at(0):
        parts = [tuple(_send(t, device, r, 0) for t in p) for r, p in enumerate(partials)]
        top = parts[0][0]
        for m, _, _ in parts[1:]:
            top = torch.maximum(top, m)
        num = den = None
        for m, l, acc in parts:
            w = torch.exp(m - top)
            num = w[..., None] * acc if num is None else num + w[..., None] * acc
            den = w * l if den is None else den + w * l
        return num / den[..., None]


def replicate_into(copies, source: torch.Tensor, *, positions=None) -> None:
    """``source`` copied into each tensor of ``copies`` that is not
    ``source`` itself (a cache leaf every position of a group, or of the
    mesh, holds whole, after the position that computed it wrote its
    own). Forward only; counted as ``"replicate"``, and by position where
    ``positions`` names them: ``(source's, [each copy's])``."""
    copies = list(copies)
    _log("replicate", shape=tuple(source.shape), dtype=source.dtype, home=source.device,
         devices=tuple(c.device for c in copies),
         source=next((i for i, c in enumerate(copies) if c is source), None))
    src, dsts = positions if positions is not None else (None, [None] * len(copies))
    moved = 0
    for dst, p in zip(copies, dsts):
        if dst is not source:
            moved += _nbytes(source)
            peer.record("replicate", src, p, _nbytes(source))
            peer.copy_into(dst, source)
    _total("replicate", moved)


# ---------------------- MoE token groups across data -------------------------


def _cross(kind: str, moves) -> None:
    """One call of ``kind`` between groups and its ``moves``, ``(sending
    position, receiving position, bytes)`` by absolute position."""
    moves = list(moves)
    _total(kind, sum(n for _, _, n in moves))
    for src, dst, n in moves:
        peer.record(kind, src, dst, n)


def _hand(x: torch.Tensor, device: torch.device, src: int, dst: int) -> torch.Tensor:
    """``x``, which position ``src`` holds, for position ``dst`` on
    ``device``: :func:`_to`'s rule between absolute positions (a copy made
    for ``dst`` on another device or under ``peer.distinct_positions``,
    else a view)."""
    if x.device != device or (src != dst and peer.distinct()):
        with peer.at(dst):
            return peer.send(x, device, src, dst)
    return x.view_as(x) if x.is_contiguous() else x.contiguous()


class _MoEGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, device, *xs):
        ctx.positions, ctx.devices = positions, [x.device for x in xs]
        ctx.sizes = [x.shape[0] for x in xs]
        _cross("moe_gather", ((q, positions[0], _nbytes(x))
                              for q, x in zip(positions[1:], xs[1:])))
        with peer.at(positions[0]):
            return torch.cat([_hand(x, device, q, positions[0])
                              for q, x in zip(positions, xs)], 0)

    @staticmethod
    def backward(ctx, g):
        home, pieces = ctx.positions[0], g.split(ctx.sizes, 0)
        _cross("moe_gather", ((home, q, _nbytes(p))
                              for q, p in zip(ctx.positions[1:], pieces[1:])))
        return (None, None, *(_hand(p, d, home, q)
                              for p, d, q in zip(pieces, ctx.devices, ctx.positions)))


def moe_gather(xs, positions, device) -> torch.Tensor:
    """The data indices' rows ``xs`` (index c's held by position
    ``positions[c]``) concatenated along dim 0 in data order on ``device``,
    for position ``positions[0]`` (exact); the backward hands each index
    its rows of the gradient on its own device."""
    device, positions = torch.device(device), tuple(positions)
    _log("moe_gather", shapes=[tuple(x.shape) for x in xs], dtype=xs[0].dtype, home=device,
         devices=tuple(x.device for x in xs), positions=positions)
    return _MoEGather.apply(positions, device, *xs)


class _MoEReturn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sizes, devices, positions, y):
        ctx.positions, ctx.home = positions, y.device
        pieces = y.split(sizes, 0)
        _cross("moe_return", ((positions[0], q, _nbytes(p))
                              for q, p in zip(positions[1:], pieces[1:])))
        return tuple(_hand(p, d, positions[0], q) for p, d, q in zip(pieces, devices, positions))

    @staticmethod
    def backward(ctx, *grads):
        home = ctx.positions[0]
        _cross("moe_return", ((q, home, _nbytes(g))
                              for q, g in zip(ctx.positions[1:], grads[1:])))
        with peer.at(home):
            return None, None, None, torch.cat([_hand(g, ctx.home, q, home)
                                                for q, g in zip(ctx.positions, grads)], 0)


def moe_return(y: torch.Tensor, sizes, devices, positions) -> tuple[torch.Tensor, ...]:
    """``y``'s rows handed back to the data indices: index c's ``sizes[c]``
    rows, in data order, on ``devices[c]`` for position ``positions[c]``
    (exact); the backward concatenates their gradients on ``y``'s device."""
    devices, positions = tuple(torch.device(d) for d in devices), tuple(positions)
    _log("moe_return", shape=tuple(y.shape), dtype=y.dtype, home=y.device, devices=devices,
         positions=positions, sizes=tuple(sizes))
    return _MoEReturn.apply(tuple(sizes), devices, positions, y)


# ---------------------------------- replay -----------------------------------


def replay(entry) -> None:
    """One logged exchange (:func:`logging_exchanges`) run on fresh
    tensors of its shapes, devices and dtype: forward and backward, or
    forward alone for the serving exchanges (``"write"``, ``"merge"``,
    ``"replicate"``)."""
    kind, meta = entry
    dtype = meta["dtype"]

    def fresh(shape, device, grad=True):
        return torch.ones(shape, dtype=dtype, device=device, requires_grad=grad)

    if kind == "write":
        shape = list(meta["shape"])
        shape[meta["dim"]] = max(local + n for _, o, local, n in meta["runs"])
        cache = Split(tuple(torch.zeros(shape, dtype=dtype, device=d) for d in meta["devices"]),
                      meta["dim"])
        slots = [o * shape[meta["dim"]] + local + k for _, o, local, n in meta["runs"]
                 for k in range(n)]
        write_slots(cache, fresh(meta["shape"], meta["home"], False), slots)
        return
    if kind == "merge":
        merge_softmax([tuple(fresh(s, d, False) for s in meta["shapes"])
                       for d in meta["devices"]], meta["home"])
        return
    if kind == "replicate":
        copies = [torch.zeros(meta["shape"], dtype=dtype, device=d) for d in meta["devices"]]
        i = meta["source"]
        replicate_into(copies, fresh(meta["shape"], meta["home"], False) if i is None
                       else copies[i].fill_(1))
        return
    if kind == "moe_gather":
        outs = (moe_gather([fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])],
                           meta["positions"], meta["home"]),)
    elif kind == "moe_return":
        outs = moe_return(fresh(meta["shape"], meta["home"]), meta["sizes"], meta["devices"],
                          meta["positions"])
    elif kind in ("fan_out", "param_copy"):
        outs = fan_out(fresh(meta["shape"], meta["home"]), meta["devices"], kind=kind)
    elif kind == "seq_gather":
        x = Split(tuple(fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])),
                  meta["dim"])
        outs = seq_gather(x, meta["receivers"])
    elif kind == "seq_reduce":
        outs = seq_reduce([fresh(s, d) for s, d in zip(meta["shapes"], meta["homes"])],
                          meta["dim"], meta["devices"]).chunks
    elif kind == "scatter":
        outs = scatter(fresh(meta["shape"], meta["home"]), meta["dim"], meta["devices"])
    elif kind == "fan_in":
        outs = (fan_in([fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])],
                       meta["home"]),)
    elif kind == "all_gather":
        outs = (all_gather([fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])],
                           meta["dim"], meta["home"]),)
    elif kind == "regroup":
        outs = regroup([fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])],
                       meta["dim"], meta["parts"])
    else:
        outs = reshard([fresh(s, d) for s, d in zip(meta["shapes"], meta["devices"])],
                       meta["src_dim"], meta["dst_dim"])
    torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])
