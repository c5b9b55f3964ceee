"""Deterministic RadiX-net-style GraphChallenge topology generator.

Port of ``repro/data/radixnet.py``: the topology, the seeded input panel
and the numpy reference are that module's code unchanged (the parity
tests hold them bit-identical); ``conn_to_bsr``/``radixnet_weights``
build the port's torch layouts on a chosen device.

The MIT/IEEE Sparse DNN GraphChallenge (arXiv 2004.01181) benchmarks
inference over synthetic deep ReLU nets whose layers are RadiX-net
mixed-radix Kronecker topologies (arXiv 1905.00416): every neuron has
EXACTLY ``fan_in = 32`` inbound edges, all weights are 1/16, and each
network size carries a fixed bias constant. This module reproduces that
workload shape deterministically — no downloads, no RNG in the topology
— so the conformance suite (`tests/test_challenge.py`) can pin
ground-truth categories.

Topology. For ``n = 32**k * q`` neurons (``q`` a power of two < 32) the
generator cycles layers through ``k`` radix-32 butterfly phases plus, when
``q > 1``, one mixed radix-``q`` ⊗ radix-``32/q`` phase:

* phase ``t < k`` connects row ``r`` to the 32 columns that differ from
  ``r`` only in base-32 digit ``t`` (stride ``32**t`` butterfly);
* the mixed phase replaces the top radix-``q`` digit (stride ``32**k``)
  AND the low ``32/q`` remainder jointly — ``q · 32/q = 32`` edges.

Layer ``l`` uses phase ``l mod num_phases``, so any window of
``num_phases`` consecutive layers composes to a full Kronecker mixing of
all ``n`` coordinates — the RadiX-net "all inputs reach all outputs"
property.

Reference semantics. ``reference_forward`` is the pure-numpy oracle:
``Y ← max(Wᵀ-gather(Y)·(1/16) + bias, 0)`` per layer, computed by index
gather (never densified). Because 1/16 is a power of two and the seeded
input panel is {0, 1}-valued, the first layer is EXACT in float32 under
any summation order; deeper layers differ between execution paths only
at ulp order, which the fixed-seed conformance configs keep away from
the category threshold. NOTE the official challenge additionally clamps
activations at ``YMAX = 32``; this repo's engine semantics are plain
ReLU throughout, so the generator deliberately omits the clamp (see
``docs/benchmarks.md``) — categories here are defined against the same
un-clamped reference every execution path implements.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sparse.bsr import BlockSparseMatrix

FAN_IN = 32
WEIGHT_VALUE = 1.0 / 16.0  # exact in binary floating point

# The GraphChallenge per-size bias constants (arXiv 2004.01181 table 1).
CHALLENGE_BIAS = {
    1024: -0.3,
    4096: -0.35,
    16384: -0.4,
    65536: -0.45,
}


def challenge_bias(neurons: int) -> float:
    """The official bias for a challenge size, else the nearest smaller
    size's constant (small test configs reuse the 1024-neuron bias)."""
    if neurons in CHALLENGE_BIAS:
        return CHALLENGE_BIAS[neurons]
    smaller = [n for n in sorted(CHALLENGE_BIAS) if n <= neurons]
    return CHALLENGE_BIAS[smaller[-1]] if smaller else CHALLENGE_BIAS[1024]


def _factor(neurons: int) -> tuple[int, int]:
    """``neurons = 32**k * q`` with q a power of two in [1, 32)."""
    if neurons < FAN_IN or neurons & (neurons - 1):
        raise ValueError(
            f"RadiX-net sizes must be powers of two >= {FAN_IN}; got "
            f"{neurons}"
        )
    k, rest = 0, neurons
    while rest % FAN_IN == 0:
        k += 1
        rest //= FAN_IN
    return k, rest


def num_phases(neurons: int) -> int:
    k, q = _factor(neurons)
    return k + (1 if q > 1 else 0)


@dataclasses.dataclass(frozen=True)
class RadixNetSpec:
    """One challenge configuration: ``neurons × layers`` at the official
    bias, fan-in 32, weight 1/16."""

    neurons: int
    layers: int
    bias: float = None  # type: ignore[assignment]  # None → official constant

    def __post_init__(self):
        _factor(self.neurons)  # validate
        if self.layers < 1:
            raise ValueError("layers must be >= 1")
        if self.bias is None:
            object.__setattr__(self, "bias", challenge_bias(self.neurons))

    @property
    def edges(self) -> int:
        """Stored nonzeros of the whole net — the challenge's work unit."""
        return self.layers * self.neurons * FAN_IN

    def connectivity(self, layer: int) -> np.ndarray:
        return radixnet_connectivity(self.neurons, layer)


def radixnet_connectivity(neurons: int, layer: int) -> np.ndarray:
    """The (neurons, 32) int32 column indices of layer ``layer``.

    Row ``r`` of the layer's weight matrix has exactly these 32 nonzero
    columns (all valued 1/16). Deterministic — a pure function of
    (neurons, layer).
    """
    k, q = _factor(neurons)
    phase = layer % num_phases(neurons)
    r = np.arange(neurons, dtype=np.int64)[:, None]
    if phase < k:
        # radix-32 butterfly on base-32 digit `phase` (stride 32**phase)
        stride = FAN_IN**phase
        digit = (r // stride) % FAN_IN
        base = r - digit * stride
        cols = base + np.arange(FAN_IN, dtype=np.int64)[None, :] * stride
    else:
        # mixed phase: top radix-q digit (stride 32**k) ⊗ low 32/q bits
        stride = FAN_IN**k
        g = FAN_IN // q
        digit = (r // stride) % q
        base = r - digit * stride - r % g
        hi = np.arange(q, dtype=np.int64)[:, None] * stride  # (q, 1)
        lo = np.arange(g, dtype=np.int64)[None, :]  # (1, 32/q)
        cols = base + (hi + lo).reshape(1, FAN_IN)
    return cols.astype(np.int32)


def radixnet_input_panel(
    neurons: int, n_inputs: int, *, density: float = 0.3, seed: int = 0
) -> np.ndarray:
    """Seeded sparse {0, 1} float32 input panel, shape (neurons, n_inputs).

    Columns are inputs (the challenge's 60 000 MNIST-derived rows live
    here transposed — this repo's activation panels are column-major
    batches). Philox-keyed: a pure function of (neurons, n_inputs,
    density, seed).
    """
    rng = np.random.Generator(
        np.random.Philox(key=seed, counter=[0, 0, neurons, n_inputs])
    )
    panel = rng.random((neurons, n_inputs), dtype=np.float32) < density
    return panel.astype(np.float32)


# ---------------------------------------------------------------------
# Pure-numpy reference inference (the conformance ground truth)
# ---------------------------------------------------------------------


def reference_forward(
    conns: Sequence[np.ndarray],
    biases: Sequence[float],
    y0: np.ndarray,
) -> np.ndarray:
    """Gather-based reference: per layer
    ``Y ← max((1/16)·Σ_{c∈conn[r]} Y[c] + bias, 0)``.

    Never densifies a weight matrix — ``y[conn]`` is an
    (neurons, 32, n_inputs) gather, summed over the fan-in axis. float32
    throughout to match the kernels' accumulate dtype.
    """
    y = np.asarray(y0, dtype=np.float32)
    w = np.float32(WEIGHT_VALUE)
    for conn, b in zip(conns, biases):
        z = (y[conn] * w).sum(axis=1, dtype=np.float32) + np.float32(b)
        y = np.maximum(z, np.float32(0.0))
    return y


def reference_categories(y_final: np.ndarray) -> np.ndarray:
    """The challenge's answer set: indices of inputs (panel columns) with
    any positive neuron in the final activation."""
    return np.flatnonzero(np.asarray(y_final).max(axis=0) > 0).astype(
        np.int64
    )


# ---------------------------------------------------------------------
# Connectivity → block-sparse weights (the engine-side representation)
# ---------------------------------------------------------------------


def conn_to_bsr(
    conn: np.ndarray,
    *,
    block_size: int = 16,
    pad_blocks_per_row: int | None = None,
    dtype=None,
    device=None,
):
    """Lower a (n, 32) connectivity to an ELL :class:`BlockSparseMatrix`.

    Every block-row's occupied column blocks become stored
    ``block_size²`` tiles holding 1/16 at the exact (row, col) positions
    of ``conn`` and 0 elsewhere. ``pad_blocks_per_row`` right-pads the
    ELL slot axis with masked-off blocks so layers of different phases
    can stack homogeneously. Built in numpy, then moved to ``device``
    (default: the GPU, raising if there is none).
    """
    device = resolve_device(device)
    n = conn.shape[0]
    bs = block_size
    if n % bs:
        raise ValueError(f"neurons ({n}) must divide block_size ({bs})")
    nrb = n // bs
    block_cols = np.asarray(conn, dtype=np.int64) // bs  # (n, 32)
    per_row_blocks = block_cols.reshape(nrb, bs * FAN_IN)
    col_idx_rows = [np.unique(per_row_blocks[rb]) for rb in range(nrb)]
    mbpr = max(len(c) for c in col_idx_rows)
    if pad_blocks_per_row is not None:
        if pad_blocks_per_row < mbpr:
            raise ValueError(
                f"pad_blocks_per_row={pad_blocks_per_row} < required "
                f"{mbpr}"
            )
        mbpr = pad_blocks_per_row
    col_idx = np.zeros((nrb, mbpr), dtype=np.int32)
    block_mask = np.zeros((nrb, mbpr), dtype=bool)
    blocks = np.zeros((nrb, mbpr, bs, bs), dtype=np.float32)
    r_local = np.repeat(np.arange(bs, dtype=np.int64), FAN_IN)
    cols = np.asarray(conn, dtype=np.int64).reshape(nrb, bs * FAN_IN)
    for rb in range(nrb):
        occupied = col_idx_rows[rb]
        col_idx[rb, : len(occupied)] = occupied
        block_mask[rb, : len(occupied)] = True
        # ELL slot of each stored entry in this block-row
        slots = np.searchsorted(occupied, per_row_blocks[rb])
        blocks[rb, slots, r_local, cols[rb] % bs] = WEIGHT_VALUE
    return BlockSparseMatrix(
        torch.from_numpy(blocks).to(device=device, dtype=dtype or torch.float32),
        torch.from_numpy(col_idx).to(device),
        torch.from_numpy(block_mask).to(device),
        (n, n),
        (bs, bs),
    )


def radixnet_weights(
    spec: RadixNetSpec, *, block_size: int = 16, dtype=None, device=None
):
    """The spec's full homogeneous BSR stack + bias vectors, on
    ``device`` (default: the GPU, raising if there is none).

    All layers share one ``max_blocks_per_row`` (the max over the spec's
    phases), so the stack is eligible for the fused single-launch
    routes. Layers of the same phase share one matrix object.
    """
    device = resolve_device(device)
    phases = num_phases(spec.neurons)
    phase_conns = [
        radixnet_connectivity(spec.neurons, p) for p in range(phases)
    ]
    phase_mats = {}
    mbpr = 0
    for p, conn in enumerate(phase_conns):
        m = conn_to_bsr(conn, block_size=block_size, dtype=dtype, device=device)
        phase_mats[p] = m
        mbpr = max(mbpr, m.max_blocks_per_row)
    for p, conn in enumerate(phase_conns):
        if phase_mats[p].max_blocks_per_row != mbpr:
            phase_mats[p] = conn_to_bsr(
                conn,
                block_size=block_size,
                pad_blocks_per_row=mbpr,
                dtype=dtype,
                device=device,
            )
    weights = [phase_mats[l % phases] for l in range(spec.layers)]
    bias = torch.full(
        (spec.neurons,), spec.bias, dtype=dtype or torch.float32, device=device
    )
    biases = [bias] * spec.layers
    return weights, biases


def radixnet_reference(
    spec: RadixNetSpec, y0: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(final activations, ground-truth categories) of the numpy oracle."""
    phases = num_phases(spec.neurons)
    phase_conns = [
        radixnet_connectivity(spec.neurons, p) for p in range(phases)
    ]
    conns = [phase_conns[l % phases] for l in range(spec.layers)]
    y = reference_forward(conns, [spec.bias] * spec.layers, y0)
    return y, reference_categories(y)
