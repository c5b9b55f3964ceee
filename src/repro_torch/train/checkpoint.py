"""Atomic checkpoints of training state — counterpart of
``repro/train/checkpoint.py``, in its on-disk format.

* **Atomic**: the state is written to ``<dir>/tmp.<step>`` and then
  ``os.replace``d to ``<dir>/step_<step:08d>``, so a crash mid-write
  never leaves a half-written step where :func:`latest_step` looks.
* **The reference's format**: ``arrays.npz`` holds one array per leaf,
  keyed by the leaf's path joined with ``//`` as ``jax.tree_util`` names
  it (a NamedTuple field by name, a tuple or list entry and a sparse
  matrix's tensors by index, a dict entry by key), and ``manifest.json``
  holds the step, the leaf count, the sorted keys and the caller's
  metadata. A training state is written as the reference's tree of the
  same state (:func:`state_tree`): its optimizer moments (flat lists
  here) are keyed like the parameters they follow, ``opt//mu//<param
  path>`` — for a :class:`~repro_torch.train.sparse.SparseMLPState`
  ``opt//mu//0//<layer>//<tensor>`` and ``opt//mu//1//<layer>``. Either
  package restores a checkpoint the other wrote.
* Leaves keep their dtypes (int32 and bool topology included); bf16
  tensors, which numpy cannot hold, are stored as float32, exactly, and
  cast back to the template's dtype on restore.

A placed state (the model's data mesh, ``distribution.sharding.Placed``
leaves) is written whole: each leaf's chunks gathered to the host in
position order, so a checkpoint does not depend on the mesh that wrote
it. Restoring places each leaf as ``shardings=`` says (a tree of
``distribution.sharding.Sharding`` leaves, the reference's
``NamedSharding`` tree, or of devices; None keeps the template's
place), or else as its template leaf lies: a placed leaf on its
template's positions, a tensor on its template's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distribution.sharding import Placed, Sharding, place_leaf
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.train.optimizer import OptState

SEP = "//"

LEAF_FIELDS = {  # a sparse matrix's tensors, in the reference's leaf order
    BlockSparseMatrix: ("blocks", "col_idx", "block_mask"),
    BlockCSRMatrix: ("values", "row_ptr", "row_id", "col_idx", "valid"),
}


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in ``jax.tree_util``'s order and
    naming, or None for a leaf."""
    fields = LEAF_FIELDS.get(type(node))
    if fields is not None:
        return [(str(i), getattr(node, f)) for i, f in enumerate(fields)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if type(node) in (tuple, list):  # a subclass is a leaf, as in jax.tree_util
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    return None


def _rebuild(node, children: list) -> Any:
    """``node``'s class over new children (the order of :func:`_children`)."""
    fields = LEAF_FIELDS.get(type(node))
    if fields is not None:
        return dataclasses.replace(node, **dict(zip(fields, children)))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dict(zip(sorted(node), children))


def map_with_path(fn: Callable[[str, Any], Any], node, path: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of ``node``, ``path`` the leaf's
    key (names joined with ``//``); the results in ``node``'s structure."""
    kids = _children(node)
    if kids is None:
        return fn(path, node)
    return _rebuild(node, [map_with_path(fn, child, f"{path}{SEP}{k}" if path else k)
                           for k, child in kids])


def leaves(tree) -> list:
    """The tensors of ``tree`` in ``jax.tree_util``'s leaf order: dict keys
    sorted, sequence entries in order, a sparse matrix's tensors in its
    ``tree_flatten`` order (values, then topology)."""
    out: list = []
    map_with_path(lambda _key, leaf: out.append(leaf), tree)
    return out


def with_leaves(like, new_leaves) -> Any:
    """``like``'s structure (classes, static shapes) over ``new_leaves``, in
    the order :func:`leaves` gives; the inverse of :func:`leaves`."""
    it = iter(new_leaves)
    return map_with_path(lambda _key, _leaf: next(it), like)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, Placed):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def state_tree(state):
    """``state`` as the reference's tree of the same state, what a
    checkpoint keys by: a training state's optimizer moments (flat lists
    here) shaped like ``state.params``, the tree they follow, as the
    reference's ``OptState`` holds them (index leaves as zeros of their
    own dtype); a scalar moment (SGD's unused ``nu``) stays as it is.
    Anything without an ``OptState`` under ``opt`` is its own tree. Works
    on a tree of devices of the state's structure too."""
    opt = getattr(state, "opt", None)
    if not isinstance(opt, OptState):
        return state

    def shaped(moments):
        return with_leaves(state.params, moments) if isinstance(moments, list) else moments

    return state._replace(opt=opt._replace(mu=shaped(opt.mu), nu=shaped(opt.nu)))


def state_from_tree(tree):
    """Inverse of :func:`state_tree`."""
    opt = getattr(tree, "opt", None)
    if not isinstance(opt, OptState):
        return tree

    def flat(moments):
        return moments if isinstance(moments, torch.Tensor) else leaves(moments)

    return tree._replace(opt=opt._replace(mu=flat(opt.mu), nu=flat(opt.nu)))


def _flatten(tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _host(leaf)
        return leaf

    map_with_path(put, state_tree(tree))
    return flat


def save(directory: str, step: int, state: Any, *, metadata: dict | None = None) -> str:
    """Atomically write ``state`` under ``directory/step_<step:08d>``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(state)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {"step": step, "num_leaves": len(flat), "keys": sorted(flat), **(metadata or {})}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(
    directory: str, like: Any, *, step: int | None = None, shardings: Any = None
) -> tuple[Any, dict]:
    """Restore the checkpoint at ``step`` (default: the latest) into the
    structure of ``like``; returns ``(state, manifest)``. Each leaf takes
    its template leaf's dtype and place (a placed template leaf's
    sharding); a missing leaf raises KeyError, a leaf of another shape
    ValueError. ``shardings``: a tree of ``like``'s structure whose
    leaves say where to restore each leaf, a ``Sharding`` (placed on its
    mesh) or a device (None: the template's place); the reference's
    elastic restore onto the current mesh."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    places: dict = {}
    if shardings is not None:
        map_with_path(lambda key, d: places.setdefault(
            key, d if d is None or isinstance(d, Sharding) else torch.device(d)),
            state_tree(shardings))
    with np.load(os.path.join(path, "arrays.npz")) as arrays:

        def load(key, leaf):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            host = arrays[key]
            if tuple(host.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {host.shape} != model {tuple(leaf.shape)}")
            if not isinstance(leaf, (torch.Tensor, Placed)):
                return host.astype(leaf.dtype)
            where = places.get(key)
            if where is None:
                where = leaf.sharding if isinstance(leaf, Placed) else leaf.device
            if isinstance(where, Sharding):
                return place_leaf(torch.from_numpy(host).to(leaf.dtype), where)
            return torch.from_numpy(host).to(where, leaf.dtype)

        tree = map_with_path(load, state_tree(like))
    return state_from_tree(tree), manifest


def retention(directory: str, *, keep_last: int = 3, keep_every: int = 0) -> None:
    """Prune old checkpoints: keep the newest ``keep_last`` and every step
    divisible by ``keep_every`` (0 = off)."""
    steps = _steps(directory)
    protected = set(steps[-keep_last:]) if keep_last else set()
    if keep_every:
        protected |= {s for s in steps if s % keep_every == 0}
    for s in steps:
        if s not in protected:
            shutil.rmtree(os.path.join(directory, f"step_{s:08d}"))
