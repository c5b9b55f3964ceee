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
  metadata. A :class:`~repro_torch.train.sparse.SparseMLPState` is
  written as the reference's tree of the same state: its optimizer
  moments (flat lists here) are keyed like the parameters they follow,
  ``opt//mu//0//<layer>//<tensor>`` and ``opt//mu//1//<layer>``. Either
  package restores a checkpoint the other wrote.
* Leaves keep their dtypes (int32 and bool topology included); bf16
  tensors, which numpy cannot hold, are stored as float32, exactly, and
  cast back to the template's dtype on restore.

Restoring places each leaf on its template leaf's device, or on the
device ``shardings=`` names for it: the reference's ``NamedSharding``
leaves become ``torch.device`` leaves (a mesh of the port is one
device, ``repro_torch.launch.mesh``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.train.sparse import LEAF_FIELDS, SparseMLPState, state_from_tree, state_tree

SEP = "//"


def _children(node) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of an inner node in ``jax.tree_util``'s order and
    naming, or None for a leaf."""
    fields = LEAF_FIELDS.get(type(node))
    if fields is not None:
        return [(str(i), getattr(node, f)) for i, f in enumerate(fields)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # a NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
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


def _map_leaves(fn: Callable[[str, Any], Any], node, path: str = "") -> Any:
    kids = _children(node)
    if kids is None:
        return fn(path, node)
    return _rebuild(node, [_map_leaves(fn, child, f"{path}{SEP}{k}" if path else k)
                           for k, child in kids])


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _as_tree(state):
    return state_tree(state) if isinstance(state, SparseMLPState) else state


def _flatten(tree) -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _host(leaf)
        return leaf

    _map_leaves(put, _as_tree(tree))
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
    its template leaf's dtype and device; a missing leaf raises KeyError,
    a leaf of another shape ValueError. ``shardings``: a tree of
    ``like``'s structure whose leaves are the devices to restore each
    leaf onto (the reference's elastic restore onto the current mesh)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    places: dict[str, torch.device] = {}
    if shardings is not None:
        _map_leaves(lambda key, d: places.setdefault(key, torch.device(d)),
                    _as_tree(shardings))
    with np.load(os.path.join(path, "arrays.npz")) as arrays:

        def load(key, leaf):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            host = arrays[key]
            if tuple(host.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {host.shape} != model {tuple(leaf.shape)}")
            if not isinstance(leaf, torch.Tensor):
                return host.astype(leaf.dtype)
            return torch.from_numpy(host).to(places.get(key, leaf.device), leaf.dtype)

        tree = _map_leaves(load, _as_tree(like))
    return (state_from_tree(tree) if isinstance(like, SparseMLPState) else tree), manifest


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
