"""Semiring algebra over torch tensors — counterpart of ``repro/core/semiring.py``.

A semiring bundles an additive monoid (⊕, 0̸) and a multiplicative
operation (⊗, 1̂) such that ⊕ is commutative and associative, ⊗
distributes over ⊕, and 0̸ is the additive identity and the
multiplicative annihilator (a ⊗ 0̸ = 0̸) — which is what lets a GraphBLAS
implementation skip stored zeros (paper §II).

``add``/``mul`` act elementwise on tensors; ``add_reduce(x, dim)`` is ⊕
along one dimension (all of them for ``dim=None``); ``matmul(A, B)`` is
the generalized product ``C(i,j) = ⊕_k A(i,k) ⊗ B(k,j)``. The boolean
semirings (``lor_land``, ``xor_and``) return bool tensors, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Elements of the (…, m, chunk, n) broadcast one step of the general
# matmul may hold: 2^26 f32 values = 256 MiB. The reference broadcasts
# the whole contraction axis at once, which for an 8192 × 8192 operand
# against a 256-column panel would be 64 GiB.
_CHUNK_ELEMS = 1 << 26


def _all_dims(fn):
    """``fn(x, dim)`` that reduces every dimension when ``dim`` is None."""

    def reduce(x, dim=None):
        return fn(x.reshape(-1), 0) if dim is None else fn(x, dim)

    return reduce


def _parity(x: torch.Tensor, dim=None) -> torch.Tensor:
    # GF(2) sum: an integer count of true terms, exact at any length
    return _all_dims(lambda t, d: t.to(torch.int32).sum(d) % 2 == 1)(x, dim)


def contract(sr, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A ⊕.⊗ B`` for (…, m, l) × (…, l, n) under any object with the
    semiring's ``name``/``mul``/``add``/``add_reduce`` (a
    :class:`Semiring` or its f32 kernel lowering).

    ``plus_times`` is ``torch.matmul``. Every other semiring broadcasts
    ⊗ over a slab of the contraction axis, ⊕-reduces the slab and
    ⊕-merges it into the running result, so the temporary stays under
    ``_CHUNK_ELEMS`` values whatever ``l`` is.
    """
    if sr.name == "plus_times":
        return torch.matmul(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    outer = a.shape[-2] * b.shape[-1]
    for d in batch:
        outer *= d
    step = max(1, _CHUNK_ELEMS // max(outer, 1))
    out = None
    for s in range(0, a.shape[-1], step):
        part = sr.add_reduce(
            sr.mul(a[..., :, s : s + step, None], b[..., None, s : s + step, :]),
            -2,
        )
        out = part if out is None else sr.add(out, part)
    return out


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗, 0̸, 1̂) semiring over torch tensors.

    Attributes:
      name: stable identifier (kernel dispatch and plan keys).
      add: commutative associative binary op (the monoid ⊕).
      mul: binary op ⊗ distributing over ⊕.
      zero: additive identity / multiplicative annihilator 0̸.
      one: multiplicative identity 1̂.
      add_reduce: ⊕ along a dimension, ``add_reduce(x, dim=None)``.
    """

    name: str
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float
    one: float
    add_reduce: Callable[..., torch.Tensor]

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Semiring) and other.name == self.name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """C = A ⊕.⊗ B (paper §II-D). Shapes: (…, m, l) × (…, l, n)."""
        return contract(self, a, b)

    def vecmat(self, v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        """vᵀ A over the semiring (GraphBLAS vxm)."""
        return self.matmul(v[None, :], a)[0]

    def matvec(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """A v over the semiring (GraphBLAS mxv)."""
        return self.matmul(a, v[:, None])[..., 0]


INF = float("inf")

PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, 0.0, 1.0,
                      _all_dims(torch.sum))
"""S1 = (ℝ, +, ×, 0, 1): standard arithmetic — correlation of inputs."""

MAX_PLUS = Semiring("max_plus", torch.maximum, torch.add, -INF, 0.0,
                    _all_dims(torch.amax))
"""S2 = ({-∞}∪ℝ, max, +, -∞, 0): optimal-path selection; carries ReLU."""

MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, INF, 0.0,
                    _all_dims(torch.amin))
"""Tropical shortest-path semiring."""

MAX_MIN = Semiring("max_min", torch.maximum, torch.minimum, -INF, INF,
                   _all_dims(torch.amax))
"""Bottleneck-path semiring."""

MIN_MAX = Semiring("min_max", torch.minimum, torch.maximum, INF, -INF,
                   _all_dims(torch.amin))

LOR_LAND = Semiring("lor_land", torch.logical_or, torch.logical_and, 0.0, 1.0,
                    _all_dims(torch.any))
"""Boolean reachability semiring."""

XOR_AND = Semiring("xor_and", torch.logical_xor, torch.logical_and, 0.0, 1.0, _parity)
"""GF(2) — finite-field semiring from paper §II-C."""

def logsumexp_reduce(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``log_plus``'s ⊕-reduce: ``logsumexp`` along ``dim`` (every dim for
    None), the reference's public name."""
    if dim is None:
        out = torch.logsumexp(x.reshape(-1), 0)
        return out.reshape((1,) * x.ndim) if keepdim else out
    return torch.logsumexp(x, dim, keepdim=keepdim)


LOG_PLUS = Semiring("log_plus", torch.logaddexp, torch.add, -INF, 0.0, logsumexp_reduce)
"""Log-probability semiring (smooth max-plus)."""

REGISTRY: dict[str, Semiring] = {
    s.name: s
    for s in (PLUS_TIMES, MAX_PLUS, MIN_PLUS, MAX_MIN, MIN_MAX, LOR_LAND, XOR_AND, LOG_PLUS)
}


def get_semiring(name: str) -> Semiring:
    try:
        return REGISTRY[name]
    except KeyError as e:
        raise KeyError(
            f"unknown semiring {name!r}; available: {sorted(REGISTRY)}"
        ) from e
