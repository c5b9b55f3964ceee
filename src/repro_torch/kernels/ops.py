"""Public wrappers around the kernels — counterpart of ``repro/kernels/ops.py``.

One wrapper per kernel: ``semiring_matmul`` (dense), ``bsr_spmm`` (ELL),
``bcsr_spmm`` (block-CSR), ``fused_mlp_forward`` (panel in shared
memory) and ``fused_mlp_tiled_forward`` (panel in global scratch). The
first three take any registry semiring by name. Each pads the panel's
columns to the tile width the launch runs at (:func:`effective_block_n`;
the dense wrapper also pads m and, with the semiring zero, k; the SpMM
wrappers re-tile a block shape their kernel cannot take,
``kernels.retile``), then:

* on CUDA tensors launches its CUDA kernel — there is no fallback: a
  kernel that cannot build or launch raises;
* on CPU tensors runs the kernel module's plain PyTorch version.

Each CUDA launch adds one to the wrapper's count in :func:`launch_counts`
(and nothing else does), so a run can show which kernels it went
through; ``launch_counts(device=)`` splits the counts by card, so a run
over a multi-card mesh can show each card ran its own shards. A launch
made while a CUDA graph is being captured does not run then: it goes
into the capture's :class:`LaunchRecord`
(:func:`recording_launches`), and each replay of the graph adds that
record to the counts (:func:`add_replayed`). The two SpMM wrappers are
differentiable in ``plus_times`` (``kernels.autodiff``); the fused
wrappers refuse autograd: their activations never exist outside the
kernel, so there is nothing to differentiate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re

import torch
import torch.nn.functional as F

from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.kernels import bcsr_spmm as _bcsr
from repro_torch.kernels import bsr_spmm as _bsr
from repro_torch.kernels import fused_mlp as _fmlp
from repro_torch.kernels import retile as _retile
from repro_torch.kernels import semiring_matmul as _smm
from repro_torch.kernels.semirings import kernel_zero
from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

KERNELS = ("semiring_matmul", "bsr_spmm", "bcsr_spmm", "fused_mlp_forward",
           "fused_mlp_tiled_forward")
# the wrapper of each ``__global__`` function in ``csrc/``
_KERNEL_SYMBOLS = {"semiring_matmul_kernel": "semiring_matmul", "bsr_spmm_kernel": "bsr_spmm",
                   "bcsr_spmm_kernel": "bcsr_spmm", "fused_resident_kernel": "fused_mlp_forward",
                   "fused_tiled_kernel": "fused_mlp_tiled_forward"}
_launches = dict.fromkeys(KERNELS, 0)
_launch_shapes: dict[str, set] = {name: set() for name in KERNELS}
_device_launches: dict[str, dict[str, int]] = {}  # card → wrapper → launches


def _zero_counts() -> dict[str, int]:
    return dict.fromkeys(KERNELS, 0)


@dataclasses.dataclass
class LaunchRecord:
    """The launches one CUDA graph capture recorded: per wrapper, how
    many, and the block shapes the SpMM launches took."""

    counts: dict[str, int] = dataclasses.field(default_factory=_zero_counts)
    shapes: dict[str, set] = dataclasses.field(
        default_factory=lambda: {name: set() for name in KERNELS})
    by_device: dict[str, dict[str, int]] = dataclasses.field(default_factory=dict)


_recording: LaunchRecord | None = None


def _count(name: str, device: torch.device, block_shape=None) -> None:
    """One launch of ``name`` on ``device``: counted, or recorded when a
    capture is on."""
    counts, shapes, by_device = ((_launches, _launch_shapes, _device_launches)
                                 if _recording is None else
                                 (_recording.counts, _recording.shapes, _recording.by_device))
    counts[name] += 1
    by_device.setdefault(str(device), _zero_counts())[name] += 1
    if block_shape is not None:
        shapes[name].add(block_shape)


@contextlib.contextmanager
def recording_launches():
    """Record, and do not count, the wrappers' launches in this block: a
    CUDA graph capture, whose kernels run only when the graph replays.
    Yields the :class:`LaunchRecord`."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a launch record is already open (captures do not nest)")
    _recording = LaunchRecord()
    try:
        yield _recording
    finally:
        _recording = None


def add_replayed(record: LaunchRecord) -> None:
    """Count one replay of a captured graph: the launches it recorded."""
    for name, k in record.counts.items():
        _launches[name] += k
        _launch_shapes[name].update(record.shapes[name])
    for device, counts in record.by_device.items():
        mine = _device_launches.setdefault(device, _zero_counts())
        for name, k in counts.items():
            mine[name] += k


def wrapper_of(kernel_name: str) -> str | None:
    """The wrapper whose kernel a device function name (mangled, as
    libcuda gives it, or demangled) belongs to; None for another kernel."""
    for sym, wrapper in _KERNEL_SYMBOLS.items():
        # Itanium mangling writes an identifier as <length><name>
        if f"{len(sym)}{sym}" in kernel_name or re.search(rf"\b{sym}\b", kernel_name):
            return wrapper
    return None


def launch_counts(device=None) -> dict[str, int]:
    """CUDA launches per wrapper since the last reset (a graph replay
    counts the launches its capture recorded): all of them, or those on
    ``device``'s card (``"cuda"`` alone is the current card)."""
    if device is None:
        return dict(_launches)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return dict(_device_launches.get(str(device), _zero_counts()))


def launched_block_shapes() -> dict[str, list[tuple[int, int]]]:
    """The block shapes each SpMM wrapper's CUDA launches took since the
    last reset (after re-tiling, ``kernels.retile``)."""
    return {name: sorted(shapes) for name, shapes in _launch_shapes.items() if shapes}


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0
        _launch_shapes[name].clear()
    _device_launches.clear()


def _ceil_mult(size: int, base: int = 8) -> int:
    """Largest power-of-two tile ≤ DEFAULT_BLOCK_N that keeps the pad small."""
    b = DEFAULT_BLOCK_N
    while b > base and size < b:
        b //= 2
    return b


def effective_block_n(n: int, block_n: int = DEFAULT_BLOCK_N) -> int:
    """The column-tile width a wrapper actually runs for an (·, n) panel
    — the clamp every wrapper below applies, exposed so the cost model
    (``repro_torch.plan.cost``) bills the grid the kernels launch."""
    return min(block_n, _ceil_mult(n))


def dense_block_sizes(
    m: int, n: int, k: int, block_n: int = DEFAULT_BLOCK_N
) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) the dense wrapper launches for an
    (m, k) × (k, n) product — each tile clamped like the column tile."""
    bm = min(DEFAULT_BLOCK_N, _ceil_mult(m))
    bk = min(DEFAULT_BLOCK_N, _ceil_mult(k))
    return bm, effective_block_n(n, block_n), bk


def _pad_to(x: torch.Tensor, dim: int, mult: int, fill: float = 0.0) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if not pad:
        return x
    return F.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, pad], value=fill)


def _contiguous16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary (the SpMM and
    dense kernels copy rows with 16-byte ``cp.async``); a view at an odd
    offset is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _bias_or_zeros(bias, m: int, like: torch.Tensor, fuse_bias_relu: bool):
    if fuse_bias_relu and bias is None:
        raise ValueError("fuse_bias_relu requires bias")
    if bias is None:
        return torch.zeros((m,), dtype=torch.float32, device=like.device)
    return bias


def semiring_matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Padded dense ``C = A ⊕.⊗ B`` (+ fused ``max(C + bias, 0)``).

    k is padded with the semiring zero on both operands (the ⊕-identity
    and ⊗-annihilator, so padded products change nothing in any
    semiring — 0 would be a free edge under ``min_plus``); m and n with 0,
    and those rows and columns are cut off again. The pads keep the rows
    16-byte aligned for the kernel's copies; the kernel masks the ragged
    edge of its larger CTA tile itself.
    """
    m, k = a.shape
    n = b.shape[1]
    bm, bn, bk = dense_block_sizes(m, n, k, block_n)
    zero = kernel_zero(semiring_name)
    bias = _bias_or_zeros(bias, m, b, fuse_bias_relu)
    ap = _pad_to(_pad_to(a, 0, bm), 1, bk, fill=zero)
    bp = _pad_to(_pad_to(b, 0, bk, fill=zero), 1, bn)
    biasp = _pad_to(bias, 0, bm)
    if bp.is_cuda:
        out = _smm.semiring_matmul_cuda(
            _contiguous16(ap), _contiguous16(bp), biasp.contiguous(),
            semiring_name=semiring_name, fuse_bias_relu=fuse_bias_relu,
        )
        _count("semiring_matmul", bp.device)
    else:
        out = _smm.semiring_matmul_plain(ap, bp, biasp, semiring_name=semiring_name,
                                         fuse_bias_relu=fuse_bias_relu)
    return out[:m, :n]


def _spmm(name, launch, plain, tile_for, a, b, bias, semiring_name, fuse_bias_relu, block_n):
    """One SpMM wrapper's forward: pad the panel's columns, re-tile a block
    shape the kernel cannot take (``kernels.retile``), then launch (CUDA)
    or run the plain version (CPU)."""
    n = b.shape[1]
    block_n = effective_block_n(n, block_n)
    bias = _bias_or_zeros(bias, a.shape[0], b, fuse_bias_relu)
    bp = _pad_to(b, 1, block_n)
    a, bp = _retile.for_launch(a, bp, tile_for(bp.shape[1]), semiring_name)
    if bp.is_cuda:
        out = launch(a, _contiguous16(bp), bias.contiguous(), semiring_name=semiring_name,
                     fuse_bias_relu=fuse_bias_relu)
        _count(name, bp.device, a.block_shape)
    else:
        out = plain(a, bp, bias, semiring_name=semiring_name, fuse_bias_relu=fuse_bias_relu)
    return out[:, :n]


def _wants_grad(values: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None) -> bool:
    # spelled out: this runs on every serving call
    return torch.is_grad_enabled() and (
        values.requires_grad or b.requires_grad or (bias is not None and bias.requires_grad))


def _require_plus_times(name: str, semiring_name: str) -> None:
    if semiring_name != "plus_times":
        raise NotImplementedError(
            f"{name} is differentiable only in plus_times, not {semiring_name}: the "
            "other semirings keep the forward-only kernel path"
        )


def bsr_spmm(
    a: BlockSparseMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    transpose_plan: BcsrTransposePlan | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Padded ELL-BSR ``C = A ⊕.⊗ B`` (+ fused ``max(C + bias, 0)``).

    Differentiable in ``plus_times``: when grad is enabled and
    ``a.blocks``, ``b`` or ``bias`` requires it, the call goes through
    ``kernels.autodiff`` (dW at stored slots, dX a ``bcsr_spmm`` launch on
    the block-CSR transpose of the stored slots, which ``transpose_plan``,
    ``sparse.bcsr.ell_transpose_plan(a)``, supplies without a sort);
    without grad it launches exactly as a serving call."""
    if _wants_grad(a.blocks, b, bias):
        from repro_torch.kernels import autodiff

        _require_plus_times("bsr_spmm", semiring_name)
        return autodiff.bsr_spmm_diff(a, b, _bias_or_zeros(bias, a.shape[0], b, fuse_bias_relu),
                                      transpose_plan, fuse_bias_relu=fuse_bias_relu,
                                      block_n=block_n)
    return _spmm("bsr_spmm", _bsr.bsr_spmm_cuda, _bsr.bsr_spmm_plain, _bsr.tile_for,
                 a, b, bias, semiring_name, fuse_bias_relu, block_n)


def bcsr_spmm(
    a: BlockCSRMatrix,
    b: torch.Tensor,
    bias: torch.Tensor | None = None,
    transpose_plan: BcsrTransposePlan | None = None,
    *,
    semiring_name: str = "plus_times",
    fuse_bias_relu: bool = False,
    block_n: int = DEFAULT_BLOCK_N,
) -> torch.Tensor:
    """Padded occupancy-exact block-CSR ``C = A ⊕.⊗ B`` (+ fused epilogue).

    Block-rows with no stored block come out as the epilogue of the
    semiring zero (``max(zero + bias, 0)`` when fused, else the zero) —
    the kernel writes them itself, the plain version gets them from its
    segment-⊕. One launch a call, long block-rows cut into pieces or not.

    Differentiable in ``plus_times`` like :func:`bsr_spmm`; its dX
    launches this wrapper again on the transpose, which
    ``transpose_plan`` (``a.transpose_plan()``, or a differentiable
    ``StackPlan``'s) supplies without a sort. Only the backward reads it.
    """
    if _wants_grad(a.values, b, bias):
        from repro_torch.kernels import autodiff

        _require_plus_times("bcsr_spmm", semiring_name)
        return autodiff.bcsr_spmm_diff(a, b, _bias_or_zeros(bias, a.shape[0], b, fuse_bias_relu),
                                       transpose_plan, fuse_bias_relu=fuse_bias_relu,
                                       block_n=block_n)
    return _spmm("bcsr_spmm", _bcsr.bcsr_spmm_cuda, _bcsr.bcsr_spmm_plain, _bcsr.tile_for,
                 a, b, bias, semiring_name, fuse_bias_relu, block_n)


def _refuse_autograd(name: str, where: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward: the {where} kernel never "
            "materializes per-layer activations, so there is nothing to "
            "checkpoint for the backward pass. Differentiate the layered "
            "kernel path instead (repro_torch.core.dnn.dnn_forward_trainable, "
            "or SparseDNNEngine(differentiable=True), which routes around "
            "the fused kernels)."
        )


def _fused(name, tiled, stacked_w, stacked_b, y0, block_n, panel_dtype):
    n = y0.shape[1]
    block_n = effective_block_n(n, block_n)
    yp = _pad_to(y0, 1, block_n)
    if yp.is_cuda:
        out = _fmlp.fused_mlp_cuda(
            stacked_w, stacked_b.contiguous(), yp.contiguous(),
            tiled=tiled, block_n=block_n, panel_dtype=panel_dtype,
        )
        _count(name, yp.device)
    else:
        out = _fmlp.fused_mlp_plain(stacked_w, stacked_b, yp, panel_dtype=panel_dtype)
    return out[:, :n]


def fused_mlp_forward(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> torch.Tensor:
    """Padded whole-stack forward, ONE launch, the ping-pong panel in
    shared memory. ``stacked_w`` carries a leading L axis
    (``repro_torch.core.dnn.stack_bsr``); square layers only.
    ``panel_dtype="bfloat16"`` halves the panel's shared-memory bill
    (f32 accumulation, f32 result). Not differentiable."""
    _refuse_autograd("fused_mlp_forward", "shared-memory-resident",
                     stacked_w.blocks, stacked_b, y0)
    return _fused("fused_mlp_forward", False, stacked_w, stacked_b, y0,
                  block_n, panel_dtype)


def fused_mlp_tiled_forward(
    stacked_w: BlockSparseMatrix,
    stacked_b: torch.Tensor,
    y0: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
) -> torch.Tensor:
    """Padded whole-stack forward, ONE launch, the ping-pong panel in
    global scratch — the route for stacks past the shared-memory budget.
    Same contract as :func:`fused_mlp_forward`, forward-only."""
    _refuse_autograd("fused_mlp_tiled_forward", "global-scratch",
                     stacked_w.blocks, stacked_b, y0)
    return _fused("fused_mlp_tiled_forward", True, stacked_w, stacked_b, y0,
                  block_n, panel_dtype)
