"""Sharding rules — counterpart of ``repro/distribution/sharding.py``:
parameter, cache and batch partition specs over a mesh, the activation
constraint context, and where the sparse stack's shard axis lands.

The rules resolve names: each leaf of a params or cache tree gets a
tuple of logical axes from the tables below, keyed by its context
("mixer" / "ffn" / "shared" / top level) and name, and
:class:`ShardingRules` maps logical axes onto mesh axes. Every rule is a
preference: an axis whose size does not divide the dim is dropped, and
no mesh axis is used twice in one spec. The resolver reads only
``mesh.shape``, so any object with a name → size dict works, and its
specs are the reference's, held to them on the reference's mesh shapes.

Leaves are named as the reference's key paths name them: dict keys,
sequence indices and a sparse matrix's tensors by index
(``repro_torch.train.checkpoint``'s order), so a sparse FFN weight's
tensors match no rule and are replicated in both packages.

On the model's mesh (``repro_torch.launch.mesh.make_local_mesh``, ``data``
× ``model``, position ``c·M + m``) a spec places its leaf:
:func:`shardings_for` gives each leaf a :class:`Sharding` (the
reference's ``NamedSharding``) and :func:`place` stores it as a
:class:`Placed` leaf, one chunk a position. A spec splits at most one dim
over ``data`` (D contiguous chunks, chunk c at data index c; on the pod
mesh over ``("pod", "data")``, or over ``data`` alone and replicated over
``pod``, the reference's pure data axis that only the gradient reduce
crosses) and one over ``model`` (M chunks, chunk m at model index m): heads, the FFN's hidden
dim, the MoE's experts, the embedding's d and the head's vocab go over
``model``, d_model-like dims over ``data``. A dim that does not divide,
norms, the router and every tensor of a sparse FFN weight are whole
along that axis. A spec the placement cannot honour (one dim over both
axes, an axis the mesh does not have) raises.

The batch's rows split over ``data`` only (:func:`split_batch`): the M
positions of a data index, its group, share their rows. A group computes
its rows together (``repro_torch.train.trainer``): each position's copy of
a leaf is its ``model`` chunk, whole along the ``data``-split dim
(:meth:`Placed.gather` with ``m``), and a leaf the spec does not split
over ``model`` is whole on the group's home position; the model code runs
the collectives that GSPMD inserts at the reference's ``constrain``
points (``repro_torch.distribution.tensor_parallel``), and
:func:`constrain_like_params` adds each group's gradients onto the owners
in card order, per ``model`` chunk. Inside a group, rules whose ``seq``
resolves to ``model`` make :func:`constrain` split the residual along
the sequence (sequence parallelism, :func:`seq_chunks`); outside a group
it is the identity and :func:`embed_lookup` is ``table[ids]``: the
reference's vocab-parallel lookup gives the same rows. :func:`group_params`
gives each group its copy of the params (for the train step and for
serving), and :func:`group_cache` a group's view of a decode cache placed by
:func:`cache_pspecs`: the placed chunks themselves (a serving step
writes them in place), a leaf split over ``model`` as a
``tensor_parallel.Split`` of the group's chunks (the attention caches'
slots, Mamba's channels, RWKV-6's heads) and every other leaf the home
position's own tensor; :func:`sync_replicas` then copies what the
positions that ran wrote into every other position's copy. Where a
data index's rows make smaller MoE token groups than the whole batch
(:func:`moe_groups_cross`), the groups run one call together layer by
layer (:class:`GroupRun`), each MoE layer once over every index's rows.
The sparse stack runs across cards too: :func:`shard_device` says where shard s runs and
:func:`row_bands` which rows each position owns in the shard-order sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp

Params = dict[str, Any]


class PartitionSpec(tuple):
    """One leaf's spec: per dim a mesh axis name, a tuple of them, or None
    (replicated), held as ``jax.sharding.PartitionSpec`` holds it (a
    one-axis tuple as the axis, an empty one as None). A leaf of a tree
    (``checkpoint.map_with_path`` walks plain tuples only)."""

    def __new__(cls, *axes):
        return super().__new__(cls, ((a[0] if a else None) if isinstance(a, tuple) and len(a) <= 1
                                     else a for a in axes))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec

# ---------------------- activation-constraint context ------------------------
# Model code calls ``constrain(x, logical_axes)`` at the reference's sites
# (the embedding's rows, each layer's input); outside an
# ``activate(mesh, rules)`` scope, and outside a group of the model's mesh
# inside one, it returns ``x`` as it is. Inside a group, rules whose
# ``seq`` resolves to a ``model`` axis of more than one position split the
# sequence (sequence parallelism).

_ACTIVE: list[tuple[Any, "ShardingRules"]] = []


@contextlib.contextmanager
def activate(mesh, rules: "ShardingRules | None" = None):
    _ACTIVE.append((mesh, rules or ShardingRules()))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_rules() -> "ShardingRules | None":
    return _ACTIVE[-1][1] if _ACTIVE else None


def seq_chunks(logical: tuple, shape) -> int:
    """Into how many chunks the active rules split the ``"seq"`` dim of an
    activation of ``logical`` axes and ``shape`` in the current group
    (``peer.in_group``): the group's M positions where ``seq`` resolves to
    the ``model`` axis (M > 1, dividing the dim; else the reference's
    divisibility fallback), else 1. An unknown logical axis raises."""
    if not _ACTIVE:
        return 1
    mesh, rules = _ACTIVE[-1]
    spec = _resolve_spec(tuple(logical), tuple(shape), mesh, rules)
    if "seq" not in logical or peer.group_position() is None:
        return 1
    dim = tuple(logical).index("seq")
    if (spec[dim] if dim < len(spec) else None) != "model":
        return 1
    m_size = peer.group_mesh().shape.get("model", 1)
    if m_size != mesh.shape["model"]:
        raise ValueError(f"rules active on a mesh of shape {mesh.shape} inside a group of "
                         f"{m_size} model positions: activate them on the group's own mesh")
    return m_size


def constrain(x, logical: tuple):
    """``x`` pinned to the spec of ``logical`` on the active mesh, the
    reference's ``with_sharding_constraint``: the spec is resolved (an
    unknown logical axis raises, as in the reference) and, where it splits
    the ``"seq"`` dim over the group's ``model`` positions
    (:func:`seq_chunks`), ``x`` comes back a ``tensor_parallel.Split``
    along it (a whole ``x`` on the home scattered; one split already, as it
    is). Otherwise ``x`` as it is: on the model's mesh the other layouts
    change where the model code calls ``tensor_parallel``'s collectives."""
    n = seq_chunks(logical, x.shape)
    if n == 1 or isinstance(x, tp.Split):
        return x
    home = peer.group_position()
    return tp.seq_reduce([x], tuple(logical).index("seq"),
                         [peer.device_of(home + m) for m in range(n)])


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``ids``: ``table[ids]`` on the whole table (a
    group's table split over ``model`` goes through
    ``tensor_parallel.embed_lookup``). The reference's vocab-parallel
    lookup (a masked local take per vocab shard and a psum that adds each
    row to zeros) gives the same rows."""
    return table[ids.long()]


def constrain_like_params(tree, *, owners=None, into=None):
    """A param-shaped tree (gradients) pinned to the parameter rules.

    Without ``owners``: the identity, a tree on one device (the
    reference's constraint has nothing to shard there). With ``owners``
    (the flat list of :class:`Placed` params the gradients follow),
    ``tree`` is one group's gradients, a flat list of the same order
    (None for an index leaf; a leaf split over ``model`` as the group's M
    chunks, ``tensor_parallel.Split``, each whole along ``data``), and
    each leaf is added onto the positions that own it
    (``peer.reduce_into``): ``into`` holds the sums so far (None at the
    first group), and the new sums come back. Called for the groups in
    order, each owner's chunk is the card-order sum; a leaf whole along an
    axis has the same sum on every position of that axis."""
    if owners is None:
        return tree
    into = into or [None] * len(owners)
    return [None if g is None else peer.reduce_into(acc, getattr(g, "chunks", g), leaf.sharding)
            for g, acc, leaf in zip(tree, into, owners)]


# ------------------------------ rules ----------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical → mesh axis assignment, the reference's fields and defaults."""

    batch_axes: tuple[str, ...] = ("pod", "data")  # batch dim of activations
    fsdp_axis: str | None = "data"  # weight "replicated-ish" dims
    tp_axis: str | None = "model"  # heads / mlp / experts / vocab
    shard_vocab: bool = True  # embed+lm_head over tp_axis
    cache_seq_axis: str | None = "model"  # decode KV/latent cache seq dim
    seq_axis: str | None = None  # sequence parallelism (prefill/train)

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes
        if logical == "fsdp":
            return self.fsdp_axis
        if logical == "tp":
            return self.tp_axis
        if logical == "vocab":
            return self.tp_axis if self.shard_vocab else None
        if logical == "cache_seq":
            return self.cache_seq_axis
        if logical == "seq":
            return self.seq_axis
        if logical == "row_blocks":
            # the sparse stack's shard axis: a dedicated "row_blocks" mesh
            # axis when the mesh has one (launch.mesh.make_row_blocks_mesh),
            # else every compute axis; absent names drop at resolution
            axes = ("row_blocks",) + tuple(a for a in (self.fsdp_axis, self.tp_axis) if a)
            return axes or None
        raise ValueError(f"unknown logical axis {logical!r}")


# (context, name) -> logical axes per dim. "fsdp" ~ d_model-like dims,
# "tp" ~ heads / mlp / expert dims.
_MIXER = {
    # GQA
    "w_q": ("fsdp", "tp", None),
    "w_k": ("fsdp", "tp", None),
    "w_v": ("fsdp", "tp", None),
    "w_o": ("tp", None, "fsdp"),
    "b_q": ("tp", None),
    "b_k": ("tp", None),
    "b_v": ("tp", None),
    # MLA
    "w_dq": ("fsdp", None),
    "w_uq": (None, "tp", None),
    "w_dkv": ("fsdp", None),
    "w_uk": (None, "tp", None),
    "w_uv": (None, "tp", None),
    # Mamba (di = expand·d_model is the "tp" dim)
    "in_proj": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "x_proj": ("tp", None),
    "dt_proj": (None, "tp"),
    "dt_bias": ("tp",),
    "A_log": ("tp", None),
    "D": ("tp",),
    "out_proj": ("tp", "fsdp"),
    # RWKV-6 time mix
    "w_r": ("fsdp", "tp"),
    "w_g": ("fsdp", "tp"),
    "mix_w1": ("fsdp", None),
    "mix_w2": (None, None, "fsdp"),
    "decay_w1": ("fsdp", None),
    "decay_w2": (None, "fsdp"),
    "mu_x": (None,),
    "mu": (None, None),
    "w0": (None,),
    "bonus_u": (None, None),
}
_FFN = {
    # dense FFN / GLU
    "w_in": ("fsdp", "tp"),
    "w_gate": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"),
    # MoE router
    "router": ("fsdp", None),
    # RWKV channel mix
    "w_k": ("fsdp", "tp"),
    "w_v": ("tp", "fsdp"),
    "w_r": ("fsdp", None),
    "mu_k": (None,),
    "mu_r": (None,),
    # the paper's MLP layer
    "w": ("fsdp", "tp"),
    "b": ("tp",),
}
_MOE_BANK = {  # 3-D expert banks (experts over tp, expert FF dim over fsdp)
    "w_in": ("tp", None, "fsdp"),
    "w_gate": ("tp", None, "fsdp"),
    "w_out": ("tp", "fsdp", None),
}
_TOP = {
    "embed": ("fsdp", "tp"),
    "lm_head": ("fsdp", "vocab"),
}
# BSR weight tensors by name (output-major: row blocks = output dim → tp).
# Key paths name a sparse matrix's tensors by index, so, in the reference
# as here, these never match (see the module docstring).
_BSR = {
    "blocks": ("tp", None, None, None),
    "col_idx": ("tp", None),
    "block_mask": ("tp", None),
}


def _path_names(path: str) -> list[str]:
    """A leaf's key (``repro_torch.train.checkpoint``'s ``//``-joined
    path) as the reference's list of names."""
    from repro_torch.train.checkpoint import SEP

    return path.split(SEP) if path else []


def _logical_axes(names: list[str], ndim: int) -> tuple:
    leaf = names[-1]
    in_period = "period" in names
    eff_ndim = ndim - 1 if in_period else ndim  # stacked leading layer dim

    if leaf in _BSR:
        spec = _BSR[leaf]
    elif "mixer" in names and leaf in _MIXER:
        spec = _MIXER[leaf]
    elif ("ffn" in names or "shared" in names) and leaf in _FFN:
        spec = _MOE_BANK[leaf] if (leaf in _MOE_BANK and eff_ndim == 3) else _FFN[leaf]
    elif leaf in _TOP:
        spec = _TOP[leaf]
    else:
        spec = (None,) * eff_ndim  # norms, scalars, unknowns → replicated
    if len(spec) != eff_ndim:
        spec = (None,) * eff_ndim  # rank mismatch (e.g. biases) → replicate
    if in_period:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def _resolve_spec(logical: tuple, shape: tuple[int, ...], mesh,
                  rules: ShardingRules) -> PartitionSpec:
    axes = []
    used: set[str] = set()
    for dim, lg in enumerate(logical):
        assignment = rules.resolve(lg)
        if assignment is None:
            axes.append(None)
            continue
        names = assignment if isinstance(assignment, tuple) else (assignment,)
        names = tuple(a for a in names if a in mesh.shape and a not in used)
        size = 1
        for a in names:
            size *= mesh.shape[a]
        if not names or shape[dim] % size != 0:
            axes.append(None)  # divisibility fallback → replicate this dim
            continue
        used.update(names)
        axes.append(names if len(names) > 1 else names[0])
    while axes and axes[-1] is None:
        axes.pop()
    return PartitionSpec(*axes)


def _map_with_names(fn, tree):
    from repro_torch.train.checkpoint import map_with_path

    return map_with_path(lambda path, leaf: fn(_path_names(path), leaf), tree)


# ------------------------------ public API -----------------------------------


def param_pspecs(cfg, params: Params, mesh, rules: ShardingRules | None = None) -> Params:
    """A :class:`PartitionSpec` for every tensor of ``params``, in its
    structure (a sparse matrix keeps its class, a spec per tensor)."""
    del cfg
    rules = rules or ShardingRules()
    return _map_with_names(
        lambda names, leaf: _resolve_spec(_logical_axes(names, leaf.ndim), tuple(leaf.shape),
                                          mesh, rules), params)


# cache leaf table: name -> logical axes (dims after the leading batch dim)
_CACHE = {
    "k": ("batch", "cache_seq", None, None),
    "v": ("batch", "cache_seq", None, None),
    "c_kv": ("batch", "cache_seq", None),
    "k_rope": ("batch", "cache_seq", None),
    "positions": (None,),
    "conv": ("batch", None, "tp"),
    "ssm": ("batch", "tp", None),
    "wkv": ("batch", "tp", None, None),
    "shift": ("batch", None),
}


def cache_pspecs(cfg, cache: Params, mesh, rules: ShardingRules | None = None) -> Params:
    del cfg
    rules = rules or ShardingRules()

    def one(names, leaf):
        in_period = "period" in names
        logical = _CACHE.get(names[-1], ("batch",) + (None,) * (leaf.ndim - 1))
        eff = leaf.ndim - 1 if in_period else leaf.ndim
        if len(logical) != eff:
            logical = (None,) * eff
        if in_period:
            logical = (None,) + tuple(logical)
        return _resolve_spec(tuple(logical), tuple(leaf.shape), mesh, rules)

    return _map_with_names(one, cache)


def batch_pspecs(mesh, rules: ShardingRules | None = None) -> dict[str, PartitionSpec]:
    """Specs for a train/serve batch: batch dim over the DP axes, optional
    sequence sharding of the token dim."""
    rules = rules or ShardingRules()
    b = tuple(a for a in rules.batch_axes if a in mesh.shape)
    s = rules.resolve("seq")
    s = s if (s is None or s in mesh.shape) else None
    return {"inputs": PartitionSpec(b, s), "labels": PartitionSpec(b, s)}


def _positions(entry, mesh) -> int:
    """How many positions a spec entry (an axis, a tuple of them, None)
    splits its dim over."""
    return math.prod(mesh.shape[a] for a in _axis_names(entry))


def _axis_names(entry) -> tuple:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf lives on a mesh, the reference's ``NamedSharding``:
    the mesh and the leaf's spec. The positions of one ``model`` index
    are the mesh's groups, D of them (``data_size``: every position over
    ``model``), group c in row-major order over the other axes
    (``pod``, ``data``). :attr:`data_dim` is the dim split over some of
    those axes (:attr:`data_ways` chunks: over ``("pod", "data")`` one a
    group; over ``data`` alone, the reference's FSDP dims on the pod
    mesh, one a group of each pod, replicated over ``pod``), and
    :attr:`model_dim` the dim split over ``model`` (M chunks); position
    ``c·M + m`` holds chunk (its group's data chunk, m). On a mesh without
    a ``model`` axis, or with ``model`` = 1, every axis but ``model``
    counts as data."""

    mesh: Any
    spec: PartitionSpec

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return self.mesh.devices

    @property
    def model_size(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def data_size(self) -> int:
        return len(self.mesh.devices) // self.model_size

    @functools.cached_property
    def _split(self) -> tuple[int | None, int | None, tuple[str, ...]]:
        data_dim = model_dim = None
        data_axes: tuple[str, ...] = ()
        for d, entry in enumerate(self.spec):
            names = tuple(a for a in _axis_names(entry) if self.mesh.shape[a] > 1)
            if not names:
                continue
            if names == ("model",):
                model_dim = d
            elif "model" not in names and data_dim is None:
                data_dim, data_axes = d, names
            else:
                raise ValueError(f"{self.spec} splits dim {d} over {names} on a mesh of shape "
                                 f"{self.mesh.shape}: a placed leaf splits one dim over data "
                                 "axes and one over the model axis")
        return data_dim, model_dim, data_axes

    @property
    def data_dim(self) -> int | None:
        return self._split[0]

    @property
    def model_dim(self) -> int | None:
        return self._split[1]

    @property
    def data_ways(self) -> int:
        """How many chunks :attr:`data_dim` is split into (1: none)."""
        return math.prod(self.mesh.shape[a] for a in self._split[2])

    @property
    def dim(self) -> int | None:
        """The one dim the leaf is split along (over ``data`` or ``model``),
        or None for a leaf every position holds whole; a leaf split along
        two dims raises (read :attr:`data_dim` and :attr:`model_dim`)."""
        data_dim, model_dim, _ = self._split
        if data_dim is not None and model_dim is not None:
            raise ValueError(f"{self.spec} splits two dims: read data_dim and model_dim")
        return model_dim if data_dim is None else data_dim

    def _group_coords(self, c: int) -> dict[str, int]:
        """Group ``c``'s coordinates on the axes other than ``model``."""
        axes = [a for a in self.mesh.shape if a != "model"]
        coords = {}
        for a in reversed(axes):
            c, coords[a] = divmod(c, self.mesh.shape[a])
        return coords

    def data_index(self, c: int) -> int:
        """Group ``c``'s chunk along :attr:`data_dim`."""
        coords, k = self._group_coords(c), 0
        for a in self._split[2]:
            k = k * self.mesh.shape[a] + coords[a]
        return k

    def data_holders(self, c: int, m: int) -> list[int]:
        """The positions of model index ``m`` from which group ``c`` gathers
        the leaf whole along ``data``: one a chunk, in chunk order, from the
        groups that share ``c``'s coordinates on the axes the leaf is not
        split over (its pod, for a leaf split over ``data`` alone)."""
        if c not in self._peer_groups:
            mine = self._group_coords(c)
            kept = [a for a in mine if a not in self._split[2]]
            peers = [g for g in range(self.data_size)
                     if all(self._group_coords(g)[a] == mine[a] for a in kept)]
            self._peer_groups[c] = sorted(peers, key=self.data_index)
        return [g * self.model_size + m for g in self._peer_groups[c]]

    @functools.cached_property
    def _peer_groups(self) -> dict[int, list[int]]:
        return {}

    def data_part(self, x: torch.Tensor, c: int) -> torch.Tensor:
        """Group ``c``'s chunk of ``x``, whole along ``data`` (a view), or
        ``x`` for a leaf whole along ``data``."""
        dim = self.data_dim
        if dim is None:
            return x
        size = x.shape[dim] // self.data_ways
        return x.narrow(dim, self.data_index(c) * size, size)

    def model_part(self, x: torch.Tensor, m: int) -> torch.Tensor:
        """Model index ``m``'s chunk of ``x`` (a view), or ``x``."""
        dim = self.model_dim
        if dim is None:
            return x
        size = x.shape[dim] // self.model_size
        return x.narrow(dim, m * size, size)

    def part(self, x, p: int) -> torch.Tensor:
        """Position ``p``'s part: its chunk of the whole leaf ``x`` (a view),
        or, for ``x`` a sequence of the M model chunks (a group's), its data
        chunk of chunk ``p mod M``. A leaf every position holds whole: ``x``."""
        c, m = divmod(p, self.model_size)
        if isinstance(x, (tuple, list)):
            return self.data_part(x[m], c)
        return self.data_part(self.model_part(x, m), c)


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """A leaf stored on a mesh: ``chunks[p]`` is position p's, on its device
    (:class:`Sharding`). Reports the whole leaf's shape, dtype and size, so
    a placed tree reads like the tree it was placed from (parameter
    counts, checkpoint templates, ``collectives.bucketed``)."""

    chunks: tuple[torch.Tensor, ...]
    sharding: Sharding

    @property
    def shape(self) -> torch.Size:
        shape = list(self.chunks[0].shape)
        s = self.sharding
        data_dim, model_dim, _ = s._split
        if data_dim is not None:
            shape[data_dim] *= s.data_ways
        if model_dim is not None:
            shape[model_dim] *= s.model_size
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.chunks[0].dtype

    @property
    def ndim(self) -> int:
        return self.chunks[0].ndim

    @property
    def device(self) -> torch.device:
        """The home device, position 0's."""
        return self.chunks[0].device

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.chunks[0].element_size()

    def is_floating_point(self) -> bool:
        return self.chunks[0].is_floating_point()

    def gather(self, device, m: int | None = None, *, position: int | None = None
               ) -> torch.Tensor:
        """The leaf on ``device``, put together in position order
        (``peer.all_gather``): with ``m``, model index m's chunk, whole along
        ``data`` (a group position's copy); without, the whole leaf. A part
        held whole is the copy of the first position on ``device`` that
        holds it, else the first such position's copied there.

        ``position``: the copy is that position's (model index ``m``, or
        the home of its group for a leaf whole along ``model``): its own
        chunk where it holds the part whole, else the chunks of its group's
        :meth:`Sharding.data_holders` sent to it (``peer.send``, logged as
        ``"gather"``) and concatenated there."""
        device = torch.device(device)
        s = self.sharding
        data_dim, model_dim, _ = s._split
        if position is not None:
            if data_dim is None:
                return self.chunks[position]
            holders = s.data_holders(position // s.model_size, m or 0)
            with peer.at(position):
                return torch.cat([peer.send(self.chunks[h], device, h, position, "gather")
                                  for h in holders], data_dim)
        if m is None and model_dim is not None:
            return peer.all_gather([self.gather(device, k) for k in range(s.model_size)],
                                   model_dim, device)
        holders = [self.chunks[h] for h in s.data_holders(0, m or 0)]
        if data_dim is not None:
            return peer.all_gather(holders, data_dim, device)
        if m is None:
            holders = list(self.chunks)
        own = [h for h in holders if h.device == device]
        return own[0] if own else peer.to(holders[0], device)

    def map(self, fn) -> "Placed":
        """``fn`` over each chunk, the same sharding."""
        return Placed(tuple(fn(c) for c in self.chunks), self.sharding)


def place_leaf(x: torch.Tensor, sharding: Sharding) -> Placed:
    """``x`` stored as ``sharding`` says: each position's part copied onto
    its device, a tensor of its own (positions sharing a device included)."""
    return Placed(tuple(peer.copy_into(torch.empty(part.shape, dtype=x.dtype, device=device),
                                       part)
                        for device, part in ((d, sharding.part(x, p))
                                             for p, d in enumerate(sharding.devices))),
                  sharding)


def shardings_for(tree, mesh, pspecs):
    """Each spec of ``pspecs`` as a :class:`Sharding` on ``mesh``: the
    reference's ``NamedSharding`` tree."""
    del tree
    from repro_torch.train.checkpoint import map_with_path

    return map_with_path(lambda _path, spec: Sharding(mesh, spec), pspecs)


def place(tree, shardings):
    """``tree`` stored as ``shardings`` (a tree of its structure) says, the
    reference's ``jax.device_put``: each tensor leaf a :class:`Placed`,
    a leaf whose sharding is None left as it is. A training state and its
    shardings are matched by the checkpoint's keys
    (``checkpoint.state_tree``)."""
    from repro_torch.train.checkpoint import map_with_path, state_from_tree, state_tree

    by_key: dict = {}
    map_with_path(lambda key, s: by_key.setdefault(key, s), state_tree(shardings))
    return state_from_tree(map_with_path(
        lambda key, leaf: leaf if by_key[key] is None else place_leaf(leaf, by_key[key]),
        state_tree(tree)))


def split_batch(batch: dict, mesh, microbatches: int = 1,
                rules: ShardingRules | None = None) -> list[list[dict]]:
    """A global batch's rows as each microbatch's rows on each data index:
    ``out[i][c]`` holds views of the rows data index ``c`` (its group of
    ``model`` positions) computes in microbatch ``i``. Microbatch i is rows
    ``[i·B/k, (i+1)·B/k)``, as the reference's ``split``, and data index c
    takes the c-th of its D equal parts, along the dim
    :func:`batch_pspecs` splits over the data positions (``model`` takes
    no part: the batch lives on ``("pod", "data")``). Raises when the rows
    do not split evenly."""
    specs = batch_pspecs(mesh, rules)
    n = len(mesh.devices) // mesh.shape.get("model", 1)
    out: list[list[dict]] = [[{} for _ in range(n)] for _ in range(microbatches)]
    for key, x in batch.items():
        spec = specs.get(key, specs["inputs"])
        rows = x.shape[0]
        if rows % microbatches or (rows // microbatches) % n:
            raise ValueError(f"a global batch of {rows} rows does not split into "
                             f"{microbatches} microbatches of {n} positions")
        if n > 1 and (not len(spec) or _positions(spec[0], mesh) != n):
            raise ValueError(f"batch spec {spec} does not split the rows over the mesh's "
                             f"{n} data positions")
        per_mb = rows // microbatches
        per_pos = per_mb // n
        for i in range(microbatches):
            for c in range(n):
                out[i][c][key] = x.narrow(0, i * per_mb + c * per_pos, per_pos)
    return out


# ------------------------------ groups ---------------------------------------


def group_params(state_params, owners: list, mesh, groups: int | None = None) -> list:
    """Each group's params tree (the first ``groups`` data indices' groups,
    default every one), from the placed ``state_params`` and their flat
    leaves ``owners``: a leaf split over ``model`` as a
    ``tensor_parallel.Split`` of its positions' chunks (each whole along
    ``data``), every other leaf whole on the group's home device. Copies
    are shared between groups whose positions share a device, except
    under ``peer.distinct_positions``, where each position gathers its
    own (``Placed.gather`` with ``position``, the exchanges logged as
    ``"gather"``), as it does on a mesh of one card a position. The train
    step gathers them once a step, a serving call once a call."""
    from repro_torch.train import checkpoint

    m_size = mesh.shape.get("model", 1)
    own = peer.distinct() or len(mesh.cards) == len(mesh.devices)
    copies: dict = {}

    def copy(j, p, m=None):
        key = (j, p) if own else (j, mesh.devices[p], m)
        if key not in copies:
            copies[key] = (owners[j].gather(mesh.devices[p], m, position=p) if own else
                           owners[j].gather(mesh.devices[p], m))
        return copies[key]

    trees = []
    for c in range(len(mesh.devices) // m_size if groups is None else groups):
        home = c * m_size
        leaves = []
        for j, leaf in enumerate(owners):
            dim = leaf.sharding.model_dim
            leaves.append(copy(j, home) if dim is None else
                          tp.Split(tuple(copy(j, home + m, m) for m in range(m_size)), dim))
        trees.append(checkpoint.with_leaves(state_params, leaves))
    return trees


def group_cache(cache, mesh, c: int):
    """Group ``c``'s view of a decode cache placed by :func:`cache_pspecs`:
    the placed chunks of its positions themselves, never gathered (a
    serving step writes them in place). A leaf split over ``model`` (the
    GQA/MLA caches along ``cache_seq``, Mamba's ``conv``/``ssm`` along
    ``di``, RWKV-6's ``wkv`` along heads) is a ``tensor_parallel.Split`` of
    the group's M chunks, each holding the group's rows when the batch
    splits over ``data`` (all rows when it does not, and group 0 runs
    them); every other leaf (``positions``, the token shifts, a dim that
    does not divide) is the home position's own chunk."""
    from repro_torch.train.checkpoint import map_with_path

    m_size = mesh.shape.get("model", 1)

    def view(_key, leaf):
        if not isinstance(leaf, Placed):
            return leaf
        chunks = leaf.chunks[c * m_size:(c + 1) * m_size]
        dim = leaf.sharding.model_dim
        return chunks[0] if dim is None else tp.Split(tuple(chunks), dim)

    return map_with_path(view, cache)


def sync_replicas(cache, mesh, groups: int) -> None:
    """After a serving step in which the first ``groups`` groups wrote their
    :func:`group_cache` views, each chunk no group wrote is made a copy of
    the chunk written in its place (``tensor_parallel.replicate_into``): a
    leaf whole along ``model`` takes its group's home position's, and,
    when only group 0 ran (a batch that does not split over ``data``),
    every group takes group 0's chunks."""
    from repro_torch.train import checkpoint

    m_size = mesh.shape.get("model", 1)
    for leaf in checkpoint.leaves(cache):
        if not isinstance(leaf, Placed):
            continue
        by_source: dict[int, list[int]] = {}
        for p in range(len(leaf.chunks)):
            c, m = divmod(p, m_size)
            src = (c if c < groups else 0) * m_size
            if leaf.sharding.model_dim is not None:
                src += m
            by_source.setdefault(src, []).append(p)
        for src, dsts in by_source.items():
            tp.replicate_into([leaf.chunks[p] for p in dsts], leaf.chunks[src],
                              positions=(src, dsts))


def moe_groups_cross(cfg, rows: dict, n: int) -> bool:
    """Whether the MoE token groups of ``n`` data indices' ``rows`` each
    (one index's, ``rows["inputs"]``) cross data indices: the whole batch's
    groups (``moe._group_size`` of all ``n`` indices' tokens) are larger
    than one index's rows make. Then each MoE layer runs once over every
    index's rows (:class:`GroupRun`), as the reference's groups of the
    whole batch; else each group routes its own rows."""
    if n == 1 or not any(spec.ffn == "moe" for spec in cfg.layer_specs()):
        return False
    from repro_torch.models.moe import _group_size

    x = rows["inputs"]
    tokens = x.shape[0] * (x.shape[1] if cfg.input_mode != "features" and x.dim() > 1 else 1)
    return _group_size(tokens) != _group_size(tokens * n)


@dataclasses.dataclass(frozen=True)
class GroupRun:
    """The first ``groups`` data indices' groups of ``mesh`` computing one
    call together, layer by layer, where their MoE token groups cross data
    indices (:func:`moe_groups_cross`): each group's work runs inside its
    own ``peer.in_group`` (:meth:`within`), a MoE layer once inside group
    0's over every group's rows (``models.moe.apply_moe_groups``). Under
    ``peer.traced_groups`` a group that does not compute (:meth:`computes`)
    hands each MoE layer zeros of its rows' shape, so its exchanges run."""

    mesh: Any
    groups: int

    def within(self, c: int):
        return peer.in_group(self.mesh, c)

    def computes(self, c: int) -> bool:
        return peer.computes(c)

    def home(self, c: int) -> tuple[torch.device, int]:
        """Group ``c``'s home device and position."""
        p = c * self.mesh.shape.get("model", 1)
        return self.mesh.devices[p], p


# ----------------------- sharded sparse weights ------------------------------


def row_block_axes(mesh, rules: ShardingRules | None = None) -> tuple[str, ...]:
    """Mesh axes the ``row_blocks`` logical axis lands on, in order:
    ``("row_blocks",)`` for a dedicated shard mesh, ``("data", "model")``
    style for compute meshes, ``()`` when nothing matches (unsharded)."""
    names = (rules or ShardingRules()).resolve("row_blocks") or ()
    return tuple(a for a in names if a in mesh.shape)


def mesh_shard_count(mesh, rules: ShardingRules | None = None) -> int:
    """How many row-block shards this mesh carries (Π of the resolved
    ``row_blocks`` axes' sizes)."""
    n = 1
    for a in row_block_axes(mesh, rules):
        n *= mesh.shape[a]
    return n


def shard_device(mesh, s: int, rules: ShardingRules | None = None) -> torch.device:
    """The device shard ``s`` runs on: the mesh's one device, or on a
    multi-card mesh position ``s``'s card (there the shard axes must span
    every position, one shard a card)."""
    if len(set(mesh.devices)) == 1:
        return mesh.device
    n = mesh_shard_count(mesh, rules)
    if n != len(mesh.devices):
        raise ValueError(f"{n} row-block shards over a mesh of {len(mesh.devices)} cards: "
                         "a multi-card mesh runs one shard a card")
    return mesh.devices[s]


def row_bands(n_row_blocks: int, n_bands: int) -> tuple[tuple[int, int], ...]:
    """The ``[start, stop)`` row blocks each of ``n_bands`` positions owns
    in a sharded layer's shard-order sum: contiguous, near-equal, every
    row block in exactly one band (a band is empty when there are more
    positions than row blocks)."""
    return tuple((c * n_row_blocks // n_bands, (c + 1) * n_row_blocks // n_bands)
                 for c in range(n_bands))
