"""Whole-stack fused forward: the two CUDA kernels and their plain version.

Counterpart of ``repro/kernels/fused_mlp.py``: ``_kernel`` (launch at
``fused_mlp.py:214``, panel resident on chip) and ``_tiled_kernel``
(launch at ``fused_mlp.py:409``, panel in off-chip scratch). Both run
all L layers of a homogeneous square ``stack_bsr`` stack in one launch,
read ``y0`` and write only ``Y[L]``. The kernel source is
``repro_torch/csrc/fused_mlp.cu``; its header says how it is laid out.

Launch geometry (:func:`launch_geometry`). In both kernels the lanes of
a :class:`Tile` fold one output tile (a block-row × ``cn`` columns of one
layer) with a ring of :data:`STAGES` cp.async weight stages of its own; a
CTA has :data:`WARPS` warps (:data:`WIDE_BLOCK_WARPS` at block size 32).

* resident: one thread-block cluster of ``cluster`` CTAs per column
  stripe of :data:`STRIPE` columns, whatever ``block_n`` the wrappers pad
  to (:func:`cluster_size`: stripes × cluster near the card's SMs, in
  one wave of clusters, at most :data:`MAX_CLUSTER`). Each CTA holds a
  replica of the stripe's ``(2, m, STRIPE)`` ping-pong panel and folds
  every ``cluster``-th block-row of each layer, two tiles a warp.
* tiled: a persistent cooperative grid of SMs × the CTAs an SM holds
  over one ``(2, m, n)`` global scratch; every layer's (block-row,
  32-column) tiles are shared out over all warps, one grid barrier a
  layer.

On-chip budget: the reference's ``VMEM_SOFT_LIMIT_BYTES`` (12 MiB of
TPU VMEM) becomes :data:`SMEM_LIMIT_BYTES`, the shared memory one Hopper
block can hold, and ``fused_mlp_vmem_bytes`` becomes
:func:`fused_mlp_smem_bytes`, the bytes the resident kernel allocates:
the panel pair and its warps' weight rings (y0 and Y[L] stay in global
memory).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import build as _build
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bsr import BlockSparseMatrix

# Shared memory one thread block can hold on Hopper (H100/H200): 227 KB
# of the SM's 256 KB, reachable as dynamic shared memory after
# cudaFuncSetAttribute (the kernels' launchers do that).
SMEM_LIMIT_BYTES = 232_448

# Mirrors of csrc/fused_mlp.cu (tests/test_torch_fused_geometry.py holds
# them to the source).
STAGES = 3  # kStages: cp.async stages of a tile's weight ring
WARPS = 16  # kWarps: warps a CTA at block sizes up to 16
WIDE_BLOCK_WARPS = 4  # kWideBlockWarps: warps a CTA at block size 32
ROWS = 4  # kRows: thread rows of a tile
BLOCK_SIZES = (4, 8, 16, 32)  # the block sizes the kernels are built for
BLOCK_NS = (8, 16)  # column tiles the wrappers may pad to (n % 8 == 0 for both kernels)
MAX_CLUSTER = 8  # the largest portable thread-block cluster
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Tile:
    """An output tile: a block-row × ``cn`` columns, ``tn`` columns a
    lane; ``staged`` when the gathered panel rows come by cp.async (the
    tiled kernel) rather than straight from the shared-memory panel."""

    cn: int
    tn: int
    staged: bool

    @property
    def lanes(self) -> int:
        """Lanes that fold one tile: ROWS thread rows × cn / tn columns."""
        return ROWS * self.cn // self.tn

    @property
    def per_warp(self) -> int:
        return 32 // self.lanes


TILES = {
    "resident": Tile(cn=8, tn=2, staged=False),  # two tiles a warp
    "tiled": Tile(cn=32, tn=4, staged=True),  # one tile a warp
}
STRIPE = TILES["resident"].cn  # columns of a resident cluster's panel

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # blocks, col_idx, mask, y0, bias, out, n_layers, nrb, mbpr, bs, n,
    # panel_bf16, cluster, stream
    "fused_mlp_resident": (_P,) * 6 + (_I,) * 7 + (_P,),
    # ... the same with the scratch pointer after out, and grid for cluster
    "fused_mlp_tiled": (_P,) * 7 + (_I,) * 7 + (_P,),
    # tiled, nrb, bs, panel_bf16, cluster, result
    "fused_mlp_occupancy": (_I,) * 5 + (_P,),
}

PANEL_DTYPES = {None: torch.float32, "float32": torch.float32,
                "bfloat16": torch.bfloat16}


def panel_torch_dtype(panel_dtype) -> torch.dtype:
    """Canonical activation-panel dtype: f32 unless the caller opts into
    bf16 panels (``None``, a name, or a torch dtype)."""
    if isinstance(panel_dtype, torch.dtype):
        if panel_dtype in (torch.float32, torch.bfloat16):
            return panel_dtype
    elif panel_dtype in PANEL_DTYPES:
        return PANEL_DTYPES[panel_dtype]
    raise ValueError(f"panel_dtype must be float32 or bfloat16, got {panel_dtype!r}")


def _itemsize(panel_dtype) -> int:
    return torch.finfo(panel_torch_dtype(panel_dtype)).bits // 8


def warps(block_size: int) -> int:
    """Warps a CTA of either kernel at this block size."""
    return WARPS if block_size <= 16 else WIDE_BLOCK_WARPS


def ring_bytes(block_size: int, tile: Tile, panel_dtype=None) -> int:
    """A CTA's weight rings: per tile, ``STAGES`` blocks with rows padded
    to ``bs + 4`` floats, and for staged tiles ``bs × cn`` panel values."""
    panel = block_size * tile.cn * _itemsize(panel_dtype) if tile.staged else 0
    return (warps(block_size) * tile.per_warp * STAGES
            * (block_size * (block_size + 4) * 4 + panel))


def fused_mlp_smem_bytes(m: int, panel_dtype=None, block_size: int = 16) -> int:
    """Shared-memory bytes the resident kernel allocates a CTA for an
    m-neuron stack: the (2, m, STRIPE) ping-pong panel in ``panel_dtype``
    and the weight rings of its tiles."""
    return (2 * m * STRIPE * _itemsize(panel_dtype)
            + ring_bytes(block_size, TILES["resident"], panel_dtype))


def _kernel_shape(w: BlockSparseMatrix) -> bool:
    """Square layers of square blocks of a size the kernels are built for."""
    m, k = w.shape
    bs_r, bs_c = w.block_shape
    return m == k and bs_r == bs_c and bs_r in BLOCK_SIZES


def fused_mlp_eligible(
    w: BlockSparseMatrix,
    block_n: int = DEFAULT_BLOCK_N,
    *,
    panel_dtype=None,
    smem_limit: int | None = None,
) -> bool:
    """A stack the resident kernel takes: its CTA's panel pair and rings
    fit the shared-memory budget, and the wrappers pad to a ``block_n``
    the kernels take. ``smem_limit`` (the counterpart of the reference's
    ``vmem_limit``) lowers the budget from :data:`SMEM_LIMIT_BYTES`; a
    budget above it is refused, since no launch could hold it."""
    if smem_limit is None:
        smem_limit = SMEM_LIMIT_BYTES
    elif smem_limit > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"shared-memory budget {smem_limit} B exceeds the {SMEM_LIMIT_BYTES} B "
            "one Hopper thread block can hold")
    return (_kernel_shape(w) and block_n in BLOCK_NS
            and fused_mlp_smem_bytes(w.shape[0], panel_dtype,
                                     w.block_shape[0]) <= smem_limit)


def fused_mlp_tiled_eligible(w: BlockSparseMatrix) -> bool:
    """A stack the tiled kernel takes, of any height: the panel lives in
    global scratch, so there is no panel-size ceiling."""
    return _kernel_shape(w)


def cluster_size(stripes: int, nrb: int, sms: int = H100_SMS, max_clusters=None) -> int:
    """CTAs a resident cluster: the largest power of two up to
    :data:`MAX_CLUSTER` with stripes × cluster ≤ sms, no more CTAs than
    block-rows, and (where ``max_clusters(c)`` gives the clusters of c
    CTAs the card holds at once) all stripes' clusters in one wave; 1
    when the stripes alone fill the card."""
    c = 1
    while 2 * c <= MAX_CLUSTER and stripes * 2 * c <= sms and 2 * c <= nrb:
        c *= 2
    while c > 1 and max_clusters is not None and max_clusters(c) < stripes:
        c //= 2
    return c


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One fused launch: ``ctas`` CTAs of ``threads`` threads in clusters
    of ``cluster`` (1 for the tiled grid), ``smem_bytes`` of dynamic
    shared memory a CTA."""

    ctas: int
    cluster: int
    threads: int
    smem_bytes: int


def launch_geometry(
    stacked_w: BlockSparseMatrix,
    n: int,
    *,
    tiled: bool,
    panel_dtype=None,
    sms: int = H100_SMS,
    blocks_per_sm: int = 1,
    max_clusters=None,
) -> Geometry:
    """The launch of either fused kernel on an (m, n) panel, n a multiple
    of 8: the resident kernel's clusters (:func:`cluster_size`),
    or the tiled kernel's cooperative grid of ``sms × blocks_per_sm``
    CTAs (the launcher asks the card for these numbers)."""
    _, nrb, _ = stacked_w.col_idx.shape
    bs = stacked_w.block_shape[0]
    threads = 32 * warps(bs)
    if tiled:
        return Geometry(sms * blocks_per_sm, 1, threads,
                        ring_bytes(bs, TILES["tiled"], panel_dtype))
    stripes = n // STRIPE
    c = cluster_size(stripes, nrb, sms, max_clusters)
    return Geometry(stripes * c, c, threads, fused_mlp_smem_bytes(nrb * bs, panel_dtype, bs))


def grid_steps(stacked_w: BlockSparseMatrix, n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """Block products either fused launch walks, in ``block_n``-wide
    column tiles whatever width a warp covers: every tile visits every
    slot of every layer (``n_tiles × L × nrb × mbpr``) — the sum of the
    layers' ELL bills."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    return n_layers * nrb * mbpr * (-(-n // block_n))


def fused_mlp_plain(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    panel_dtype=None,
) -> torch.Tensor:
    """Both kernels' function in plain PyTorch, layer by layer, on any
    device: the panel is rounded to ``panel_dtype`` after every layer
    (and on entry), accumulation is f32, the result is f32."""
    pdt = panel_torch_dtype(panel_dtype)
    n_layers = stacked_b.shape[0]
    y = y0.to(pdt)
    for l in range(n_layers):
        w_l = BlockSparseMatrix(
            stacked_w.blocks[l].float(),
            stacked_w.col_idx[l],
            stacked_w.block_mask[l],
            stacked_w.shape,
            stacked_w.block_shape,
        )
        z = sparse_ops.bsr_matmul(w_l, y.float()) + stacked_b[l].float()[:, None]
        y = sparse_ops.relu(z).to(pdt)
    return y.float()


def _occupancy(lib, tiled: bool, nrb: int, bs: int, bf16: bool, cluster: int) -> int:
    result = ctypes.c_int(0)
    err = lib.fused_mlp_occupancy(int(tiled), nrb, bs, int(bf16), cluster, ctypes.byref(result))
    _build.check(lib, err, "fused_mlp_occupancy")
    return result.value


_geometries: dict[tuple, tuple[Geometry, int]] = {}


def card_geometry(
    stacked_w: BlockSparseMatrix,
    n: int,
    *,
    tiled: bool,
    panel_dtype=None,
    device=None,
) -> tuple[Geometry, int]:
    """(the launch, its co-residency) on the card: the tiled grid sized
    from the device's SMs and the CTAs one SM holds; the resident
    clusters sized from the SMs and the clusters of each size the card
    holds at once, and that number for the chosen size (0 refuses the
    launch: there is no smaller fallback cluster). The card is asked once
    per (stack shape, width, kernel, panel type, device), so a launch
    that a CUDA graph captures after a first eager call asks it nothing."""
    _, nrb, _ = stacked_w.col_idx.shape
    bs = stacked_w.block_shape[0]
    bf16 = panel_torch_dtype(panel_dtype) == torch.bfloat16
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    key = (nrb, bs, n, tiled, bf16, index)
    if key not in _geometries:
        _geometries[key] = _ask_card(stacked_w, n, tiled, panel_dtype, nrb, bs, bf16, device)
    return _geometries[key]


def _ask_card(stacked_w, n, tiled, panel_dtype, nrb, bs, bf16, device):
    lib = _build.load("fused_mlp", SIGNATURES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if tiled:
        per_sm = _occupancy(lib, True, nrb, bs, bf16, 1)
        return launch_geometry(stacked_w, n, tiled=True, panel_dtype=panel_dtype,
                               sms=sms, blocks_per_sm=per_sm), per_sm
    fits = functools.cache(lambda c: _occupancy(lib, False, nrb, bs, bf16, c))
    geo = launch_geometry(stacked_w, n, tiled=False, panel_dtype=panel_dtype,
                          sms=sms, max_clusters=fits)
    return geo, fits(geo.cluster)


def fused_mlp_cuda(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    tiled: bool,
    block_n: int,
    panel_dtype=None,
) -> torch.Tensor:
    """Launch the resident (``tiled=False``) or tiled kernel on CUDA
    tensors: f32 stack of square blocks of a size in
    :data:`BLOCK_SIZES`, ``y0`` (m, n) f32 contiguous, n % block_n == 0,
    block_n 8 or 16, at :func:`card_geometry`'s launch; a launch the card
    cannot hold raises."""
    n_layers, nrb, mbpr = stacked_w.col_idx.shape
    bs_r, bs_c = stacked_w.block_shape
    m, k = stacked_w.shape
    n = y0.shape[1]
    pdt = panel_torch_dtype(panel_dtype)
    need = functools.partial(_build.require, "fused MLP")
    need(stacked_w.blocks.dtype == y0.dtype == stacked_b.dtype == torch.float32,
         "f32 weights, panel and bias")
    need(stacked_w.col_idx.dtype == torch.int32 and stacked_w.block_mask.dtype == torch.bool,
         "int32 col_idx and bool block_mask")
    _build.require_contiguous_on(y0.device, "fused MLP", stacked_w.blocks,
                                 stacked_w.col_idx, stacked_w.block_mask, stacked_b, y0)
    need(m == k and bs_r == bs_c, "square layers of square blocks")
    need(bs_r in BLOCK_SIZES, f"a block size in {BLOCK_SIZES}")
    need(block_n in BLOCK_NS, "block_n 8 or 16")
    need(y0.shape[0] == k and n % block_n == 0 and tuple(stacked_b.shape) == (n_layers, m),
         f"y0 ({k}, n) with n % {block_n} == 0 and bias ({n_layers}, {m})")
    _build.require_aligned("fused MLP", stacked_w.blocks)
    if not tiled:
        need(fused_mlp_smem_bytes(m, pdt, bs_r) <= SMEM_LIMIT_BYTES,
             f"a panel pair and weight rings within {SMEM_LIMIT_BYTES} B of shared memory")
    with _build.on_card(y0.device):
        geometry, _ = card_geometry(stacked_w, n, tiled=tiled, panel_dtype=pdt, device=y0.device)
        lib = _build.load("fused_mlp", SIGNATURES)
        out = torch.empty((m, n), dtype=torch.float32, device=y0.device)
        p = _build.pointer
        head = (p(stacked_w.blocks), p(stacked_w.col_idx), p(stacked_w.block_mask),
                p(y0), p(stacked_b), p(out))
        shape = (n_layers, nrb, mbpr, bs_r, n, int(pdt == torch.bfloat16))
        stream = _build.stream_handle(y0.device)
        if tiled:
            scratch = torch.empty((2, m, n), dtype=pdt, device=y0.device)  # the ping-pong panel
            err = lib.fused_mlp_tiled(*head, p(scratch), *shape, geometry.ctas, stream)
        else:
            err = lib.fused_mlp_resident(*head, *shape, geometry.cluster, stream)
        _build.check(lib, err, "fused_mlp_tiled" if tiled else "fused_mlp_resident")
    return out
