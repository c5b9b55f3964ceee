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

For the model API the port's mesh is one device (``repro_torch.launch.mesh``),
and a spec places nothing: :func:`shardings_for` maps every leaf to that
device (a multi-card mesh's home card), and :func:`constrain`,
:func:`constrain_like_params` and :func:`embed_lookup` are the identity
and ``table[ids]`` inside an :func:`activate` scope as outside it. The
model API's specs across several cards, and the collectives between
them, wait for the model API on several cards. The sparse stack does run
across cards: :func:`shard_device` says where shard s runs and
:func:`row_bands` which rows each position owns in the shard-order sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

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
# Model code may call ``constrain(x, logical_axes)``; outside an
# ``activate(mesh, rules)`` scope, and on the port's one-device mesh
# inside one, it returns ``x`` as it is.

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


def constrain(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """``x`` pinned to the spec of ``logical`` on the active mesh: the spec
    is resolved (an unknown logical axis raises, as in the reference)
    and ``x`` returned as it is, every position being one device."""
    if _ACTIVE:
        mesh, rules = _ACTIVE[-1]
        _resolve_spec(tuple(logical), tuple(x.shape), mesh, rules)
    return x


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``ids``: ``table[ids]``. The reference's
    vocab-parallel lookup (a masked local take per vocab shard and a
    psum) gives the same rows; on one device it is the gather itself."""
    return table[ids.long()]


def constrain_like_params(tree):
    """A param-shaped tree (gradients) pinned to the parameter rules: the
    identity on one device, where the reference's constraint that keeps
    gradient accumulators sharded has nothing to shard."""
    return tree


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


def shardings_for(tree, mesh, pspecs):
    """Each spec of ``pspecs`` as where its leaf lives: the mesh's one
    device (``Mesh.device``); the reference's ``NamedSharding`` tree."""
    del tree
    from repro_torch.train.checkpoint import map_with_path

    return map_with_path(lambda _path, _spec: mesh.device, pspecs)


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
