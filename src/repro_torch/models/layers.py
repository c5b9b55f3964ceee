"""Shared model building blocks — counterpart of ``repro/models/layers.py``.

Parameters are nested dicts and lists of tensors (the reference's pytree,
leaf for leaf). Every FFN projection goes through :func:`linear`, which
dispatches on the weight's type — a dense tensor, or a
:class:`BlockSparseMatrix` / :class:`BlockCSRMatrix` — so the paper's
sparse-weight technique is an option for any FFN, and on the card a
sparse weight runs on the hand-written SpMM kernels.

Initializers draw from an :class:`Init`: a ``torch.Generator`` and the
device it draws on, or the ``meta`` device (shapes only, the counterpart
of ``jax.eval_shape``). Its values differ from ``jax.random``'s by
design; parity tests convert the reference's weights
(``repro_torch.convert.model_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.distribution import peer
from repro_torch.distribution import tensor_parallel as tp
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

Params = dict[str, Any]
SPARSE = (BlockSparseMatrix, BlockCSRMatrix)


# --- params trees -----------------------------------------------------------


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a params tree (dicts, lists, tuples); a
    sparse matrix is one leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _map_fields(fn: Callable, leaf):
    """``fn`` over a leaf's tensors: the tensor itself, or every tensor
    field of a sparse matrix (values and index tensors alike)."""
    if isinstance(leaf, SPARSE):
        return dataclasses.replace(leaf, **{
            f.name: fn(getattr(leaf, f.name)) for f in dataclasses.fields(leaf)
            if isinstance(getattr(leaf, f.name), torch.Tensor)})
    return fn(leaf)


def tree_index(tree, i: int):
    """Slice ``i`` of a tree stacked on a leading axis: views of every
    tensor, a stacked sparse matrix as one layer's matrix."""
    return tree_map(lambda leaf: _map_fields(lambda t: t[i], leaf), tree)


def tree_stack(trees: list):
    """The trees stacked leaf by leaf on a new leading axis (a sparse
    matrix's values and index tensors alike, so masks stay with their
    slots)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack(list(xs)) for xs in zip(*trees))
    if isinstance(first, tp.Split):  # a group's split cache leaf: chunk by chunk
        return tp.Split(tuple(torch.stack(cs) for cs in zip(*(t.chunks for t in trees))),
                        first.dim + 1)
    if isinstance(first, SPARSE):
        return dataclasses.replace(first, **{
            f.name: torch.stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first)
            if isinstance(getattr(first, f.name), torch.Tensor)})
    return torch.stack(trees)


# --- init helpers ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Init:
    """Where parameters are drawn: ``generator`` on ``device`` (``None``
    on the ``meta`` device, which holds shapes only). ``lead`` prefixes
    every shape: a period's layers are drawn stacked, ``(n_periods, ...)``."""

    generator: torch.Generator | None
    device: torch.device
    lead: tuple[int, ...] = ()

    def stacked(self, n: int) -> "Init":
        return dataclasses.replace(self, lead=self.lead + (n,))

    def normal(self, shape, dtype) -> torch.Tensor:
        return torch.randn(self.lead + tuple(shape), generator=self.generator, dtype=dtype,
                           device=self.device)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return self.full(shape, 0.0, dtype)

    def const(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` (made on the CPU) repeated over ``lead``."""
        return value.to(self.device).expand(self.lead + tuple(value.shape)).clone()


def dense_init(rng: Init, d_in: int, d_out: int, dtype=torch.float32) -> torch.Tensor:
    return rng.normal((d_in, d_out), dtype) * (1.0 / math.sqrt(d_in))


def embed_init(rng: Init, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    return rng.normal((vocab, d), dtype) * 0.02


# --- primitive ops --------------------------------------------------------


def _kernel_product(w, xt: torch.Tensor, transpose_plan) -> torch.Tensor:
    """``w @ xt`` through the SpMM kernel wrappers. The kernels take f32
    operands, so bf16 values and panels are read as f32 (exact), the
    products summed in f32 and the result cast to the operands' type —
    the reference kernel's own arithmetic (f32 accumulation, output in
    the result type)."""
    from repro_torch.kernels import ops as kernel_ops

    out_dtype = torch.promote_types(w.dtype, xt.dtype)
    w32, xt32 = w.astype(torch.float32), xt.to(torch.float32)
    if isinstance(w, BlockCSRMatrix):
        out = kernel_ops.bcsr_spmm(w32, xt32, None, transpose_plan)
    else:
        out = kernel_ops.bsr_spmm(w32, xt32)
    return out.to(out_dtype)


def linear(
    w,
    x: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    use_kernel: bool | None = None,
    transpose_plan=None,
) -> torch.Tensor:
    """y = x @ W (+ b). ``w`` is dense (d_in, d_out) or sparse
    (d_out, d_in) — ELL-padded BSR or block-CSR.

    Sparse weights store the *output-major* layout (the paper's W is
    applied ``W @ Y``), so they compute ``(W @ x^T)^T``.

    ``use_kernel`` selects the SpMM kernel wrappers (``kernels.ops``)
    over the plain products of ``sparse.ops``; ``None`` means the
    kernels when ``x`` is on the card. A kernel that fails to launch
    raises: there is no fallback to the plain product.
    ``transpose_plan``: for a block-CSR ``w`` on the kernel path, the
    cached backward transpose (only a backward reads it).
    """
    if isinstance(w, SPARSE):
        lead = x.shape[:-1]
        xt = x.reshape(-1, x.shape[-1]).T  # (d_in, tokens)
        if use_kernel is None:
            use_kernel = xt.is_cuda
        if use_kernel:
            out = _kernel_product(w, xt, transpose_plan)
        else:
            matmul = (sparse_ops.bcsr_matmul if isinstance(w, BlockCSRMatrix)
                      else sparse_ops.bsr_matmul)
            out = matmul(w, xt)  # (d_out, tokens)
        y = out.T.reshape(*lead, w.shape[0])
    else:
        y = torch.einsum("...i,io->...o", x, w)
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms_norm(rng: Init, d: int) -> torch.Tensor:
    return rng.zeros((d,), torch.float32)  # (1 + scale) convention


# The activations as ``jax.nn`` defines them, evaluated op by op in the
# input's dtype: XLA rounds a bf16 sigmoid's exp, sum and quotient to bf16
# one by one, where torch's fused kernels round once, and the two differ
# in about a third of bf16 outputs by an ulp. These give the reference's
# bf16 bits (and its f32 values to an ulp).


def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a weak-typed literal
    to its operand's type (on the host: a device tensor made from a host
    value would wait for the card's queue)."""
    return float(torch.tensor(value, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    inner = (x + (x * x * x) * rounded(0.044715, x.dtype)) * rounded(math.sqrt(2 / math.pi),
                                                                      x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return silu(x)
    if kind == "gelu":
        return gelu(x)
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


# --- FFN -------------------------------------------------------------------


def init_ffn(rng: Init, d_model: int, d_ff: int, glu: bool, dtype=torch.float32) -> Params:
    p = {
        "w_in": dense_init(rng, d_model, d_ff, dtype),
        "w_out": dense_init(rng, d_ff, d_model, dtype),
    }
    if glu:
        p["w_gate"] = dense_init(rng, d_model, d_ff, dtype)
    return p


def apply_ffn(p: Params, x: torch.Tensor, act: str, glu: bool, *,
              use_kernel: bool | None = None) -> torch.Tensor:
    """The FFN; with its weights split over ``model`` (a group's
    ``tensor_parallel.Split``), ``w_in``/``w_gate`` column-parallel and
    ``w_out`` row-parallel: ``x`` fanned out, each position's partial
    product fanned in on ``x``'s device. A sparse FFN is whole and runs
    where ``x`` is."""
    return row_parallel(_ffn, p, x, act, glu, use_kernel=use_kernel)


def _ffn(p: Params, x: torch.Tensor, act: str, glu: bool, *,
         use_kernel: bool | None = None) -> torch.Tensor:
    h = linear(p["w_in"], x, use_kernel=use_kernel)
    if glu:
        h = activation(linear(p["w_gate"], x, use_kernel=use_kernel), act) * h
    else:
        h = activation(h, act)
    return linear(p["w_out"], h, use_kernel=use_kernel)


def row_parallel(body: Callable, p: Params, x, *args, **kw):
    """``body(p, x, ...)`` for params whose leaves are all split over
    ``model`` (column-parallel in, row-parallel out): ``x`` fanned out to
    the positions, each position's ``body`` on its chunks, the partials
    added in model order on ``x``'s device (``tensor_parallel.fan_in``);
    for ``x`` split along the sequence, gathered on every position and the
    partials reduce-scattered onto its chunks
    (``tensor_parallel.region_input``/``region_output``). Params held
    whole: ``body`` once, where ``x`` is (a split sequence gathered on the
    home and handed back, ``tensor_parallel.on_home``)."""
    split = [isinstance(w, tp.Split) for w in p.values()]
    if not any(split):
        return tp.on_home(lambda h: body(p, h, *args, **kw), x)
    if not all(split):
        raise ValueError(f"an FFN split over model in part ({sorted(p)}): its weights share "
                         "the hidden dim")
    devices = next(iter(p.values())).devices
    xs = tp.region_input(x, devices)
    return tp.region_output([body({k: w.chunks[m] for k, w in p.items()}, xs[m], *args, **kw)
                             for m in range(len(devices))], x)


def sparsify_ffn(
    p: Params, block_shape: tuple[int, int], blocks_per_row: int
) -> Params:
    """Convert an FFN's weights to BSR via block-magnitude pruning
    (host-side; the paper's deployment path for sparse weights)."""
    from repro_torch.core import pruning

    out = {}
    for name, w in p.items():
        if isinstance(w, SPARSE) or w.ndim != 2:
            out[name] = w
            continue
        # prune in output-major orientation (W @ x convention of the paper)
        out[name] = pruning.block_prune(w.T, block_shape, blocks_per_row=blocks_per_row)
    return out


# --- losses ----------------------------------------------------------------


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 0.0
) -> torch.Tensor:
    """Mean next-token CE in f32; labels < 0 are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def vocab_parallel_cross_entropy(chunks, labels: torch.Tensor, *,
                                 z_loss: float = 0.0) -> torch.Tensor:
    """:func:`cross_entropy_loss` of logits split over the vocab, chunk m
    (vocab ``[m·V/M, (m+1)·V/M)``) on model position m's device, the loss
    on ``labels``' device. Each position computes its chunk's max, its sum
    of exponentials and its gold logit where it owns the label; the global
    max is exact (the maximum of the maxima), the sums and golds are added
    in model order (``tensor_parallel.fan_in``), and ``z_loss`` uses the
    combined log-sum-exp."""
    home = labels.device
    size = chunks[0].shape[-1]
    logits = [c.float() for c in chunks]
    with torch.no_grad():
        top = torch.stack([peer.to(torch.amax(lg, dim=-1), home) for lg in logits]).amax(0)
    label = labels.clamp_min(0).long()
    sums, golds = [], []
    for m, lg in enumerate(logits):
        local = peer.to(label, lg.device) - m * size
        sums.append(torch.sum(torch.exp(lg - peer.to(top, lg.device)[..., None]), dim=-1))
        gold = torch.gather(lg, -1, local.clamp(0, size - 1)[..., None])[..., 0]
        golds.append(torch.where((local >= 0) & (local < size), gold, 0.0))
    lse = top + torch.log(tp.fan_in(sums, home))
    nll = lse - tp.fan_in(golds, home)
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
