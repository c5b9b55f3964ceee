"""The f32 lowering of every registry semiring — counterpart of
``repro/kernels/semirings.py``.

The kernels compute in f32, so each semiring of ``core.semiring.REGISTRY``
is lowered to a :class:`KernelSemiring`: the elementwise ⊗, the binary ⊕
that merges a partial into the accumulator, ⊕ along a dimension, and
``init`` — the ⊕-identity, which is also the ⊗-annihilator, so the one
value is the accumulator's start, the k-padding fill and the value of an
empty block-row. ``id`` is the number the C entry points of the CUDA
kernels switch on (``csrc/semiring.cuh``).

Boolean semirings run in the {0.0, 1.0} ⊂ f32 encoding: ⊗ canonicalises
each operand with ``!= 0`` (NaN counts as true, as in ``jnp``), ∨ is max
on {0, 1} and ⊻ is sum mod 2, so the result is the f32 encoding of the
boolean one.

The reference also carries ``K_CHUNK = 8``, the k-slab of its VPU
broadcast, sized for the TPU's 8 sublanes. It has no Hopper meaning: the
CUDA kernels reduce each output sequentially in a register, one product
at a time. The plain versions here chunk the contraction axis only to
bound their temporaries (``core.semiring.contract``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core import semiring as _core


@dataclasses.dataclass(frozen=True)
class KernelSemiring:
    """One registry semiring lowered to f32 kernel ops."""

    name: str
    id: int  # the C entry points' semiring switch (csrc/semiring.cuh)
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # ⊗
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # binary ⊕
    add_reduce: Callable[..., torch.Tensor]  # ⊕ along a dimension
    init: float  # ⊕-identity / ⊗-annihilator

    @property
    def zero(self) -> float:
        """``init`` under the algebra's name (what ``sparse.ops`` reads)."""
        return self.init

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``A ⊕.⊗ B`` in the f32 encoding, any batch dims."""
        return _core.contract(self, a, b)


def _f32_and(a, b):
    return ((a != 0) & (b != 0)).float()


def _f32_xor(a, b):
    return ((a != 0) ^ (b != 0)).float()


def _f32_parity(x, dim=None):
    # sums of {0, 1} in f32 are exact far beyond any contraction length here
    return torch.remainder(x.sum(dim) if dim is not None else x.sum(), 2.0)


# The order of the registry's semirings in csrc/semiring.cuh's switch.
SEMIRING_IDS = {
    "plus_times": 0, "max_plus": 1, "min_plus": 2, "max_min": 3,
    "min_max": 4, "lor_land": 5, "xor_and": 6, "log_plus": 7,
}

# ⊗ of the registry → its f32 form, keyed by the op the Semiring carries
_MUL_F32 = {
    torch.mul: torch.mul,
    torch.add: torch.add,
    torch.minimum: torch.minimum,
    torch.maximum: torch.maximum,
    torch.logical_and: _f32_and,
}

# ⊕ of the registry → (binary f32 merge, f32 reduce along a dimension)
_ADD_F32 = {
    torch.add: (torch.add, _core.PLUS_TIMES.add_reduce),
    torch.maximum: (torch.maximum, _core.MAX_PLUS.add_reduce),
    torch.minimum: (torch.minimum, _core.MIN_PLUS.add_reduce),
    torch.logical_or: (torch.maximum, _core.MAX_PLUS.add_reduce),
    torch.logical_xor: (_f32_xor, _f32_parity),
    torch.logaddexp: (torch.logaddexp, _core.LOG_PLUS.add_reduce),
}


@functools.cache
def kernel_semiring(name: str) -> KernelSemiring:
    """The f32 lowering of registry semiring ``name`` (KeyError for a
    name the registry does not hold)."""
    sr = _core.get_semiring(name)
    add, add_reduce = _ADD_F32[sr.add]
    return KernelSemiring(name, SEMIRING_IDS[name], _MUL_F32[sr.mul], add,
                          add_reduce, float(sr.zero))


def kernel_zero(name: str) -> float:
    """⊕-identity / ⊗-annihilator fill for ``name`` (f32 encoding)."""
    return kernel_semiring(name).init


def supported() -> tuple[str, ...]:
    """Every semiring the kernels speak — the whole core registry."""
    return tuple(sorted(_core.REGISTRY))
