"""Values derived from tensors, cached on the tensors themselves.

A derived value (a re-tiled copy of a matrix, the digest of its index
arrays) is cached on the identity of the tensors it was derived from and
on their in-place versions (``Tensor._version``): an in-place change of
any of them derives the value again, and the entry goes when any of them
is freed.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

_cache: dict[tuple, tuple[tuple, tuple, object]] = {}


def cached_on(tensors: tuple[torch.Tensor, ...], extra: tuple, build: Callable[[], object]):
    """``build()``, cached on the identity and ``_version`` of ``tensors``
    plus the hashable ``extra``; dropped when any of the tensors is freed."""
    key = tuple(id(t) for t in tensors) + extra
    hit = _cache.get(key)
    versions = tuple(t._version for t in tensors)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)) and hit[1] == versions:
        return hit[2]
    value = build()

    def forget(ref, key=key):
        entry = _cache.get(key)
        if entry is not None and any(r is ref for r in entry[0]):
            del _cache[key]

    _cache[key] = (tuple(weakref.ref(t, forget) for t in tensors), versions, value)
    return value
