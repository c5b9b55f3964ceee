"""The paper's sparse ReLU DNN in PyTorch — counterpart of ``repro/core/dnn.py``.

``Y[l+1] = max(W[l]·Y[l] + b[l], 0)`` per layer, in two forms:

* ``fused=True`` — one product with the bias+ReLU epilogue, in plain
  PyTorch on any device, like the reference's XLA path (the kernels are
  reached through plans, ``repro_torch.plan``);
* ``fused=False`` — paper-faithful: the three GraphBLAS calls of Fig. 4,

    Y[k+1] = GrB_mxm(FP32AddMul, W[k], Y[k])           # arithmetic semiring
    Y[k+1] = GrB_eWiseMult(FP32MaxPlus, Y[k+1], B[k])  # ⊗ = +  → bias add
    Y[k+1] = GrB_eWiseAdd(FP32MaxPlus, Y[k+1], Zero)   # ⊕ = max → ReLU

  where ``mxm`` on a sparse weight launches the CUDA kernels through an
  ``MxmPlan`` (``repro_torch.core.graphblas``).

Weights are dense tensors, ELL-padded :class:`BlockSparseMatrix` or
:class:`BlockCSRMatrix`. :func:`dnn_forward_resident` runs a whole stack
as one fused kernel launch through the shared plan cache; ``mesh=`` on
either forward runs it sharded (``repro_torch.plan.sharded``).

Training: :func:`dnn_forward_trainable` runs each sparse layer through the
differentiable SpMM wrappers (``repro_torch.kernels.autodiff``: the
kernels forward, dW at stored blocks and dX by the transpose product
backward) and :func:`dnn_value_and_grad` returns the loss and the
gradients, sparse ones in the weight's own layout.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

from repro_torch.core import graphblas as gb
from repro_torch.core.semiring import MAX_PLUS, PLUS_TIMES
from repro_torch.kernels import DEFAULT_BLOCK_N
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix

Weight = Union[torch.Tensor, BlockSparseMatrix, BlockCSRMatrix]


def dnn_grid_steps(
    weights: Sequence[Weight], n: int, *, block_n: int = DEFAULT_BLOCK_N
) -> int:
    """Total forward bill of the L-layer stack on an (m, n) panel (alias
    of :func:`repro_torch.plan.stack_grid_steps`; a plan carries it as
    ``grid_steps``)."""
    from repro_torch.plan import cost as _plan_cost

    return _plan_cost.stack_grid_steps(weights, n, block_n=block_n)


def _sharded_plan_forward(
    weights: Sequence[Weight], biases: Sequence[torch.Tensor], y0: torch.Tensor, mesh
) -> torch.Tensor:
    """The mesh dispatch both forwards share: the sharded plan for this
    panel width from the shared default cache, run."""
    from repro_torch.plan.cache import default_cache

    plan = default_cache().get(weights, biases, max(y0.shape[1], 1), mesh=mesh)
    return plan.forward(y0)


def dnn_layer(
    w: Weight, y: torch.Tensor, b: torch.Tensor, *, fused: bool = True
) -> torch.Tensor:
    """One forward layer: max(W·Y + b⊗1ᵀ, 0).  y: (m, n); b: (m,)."""
    if fused:
        if isinstance(w, BlockCSRMatrix):
            return sparse_ops.bcsr_matmul_fused_relu(w, y, b)
        if isinstance(w, BlockSparseMatrix):
            return sparse_ops.bsr_matmul_fused_relu(w, y, b)
        return sparse_ops.dense_matmul_fused_relu(w, y, b)
    bias = b[:, None].expand(y.shape)  # B[k]: b replicated over the columns
    zero = torch.zeros_like(y)  # the Zero matrix (Fig. 4 lines 24-26)
    z = gb.mxm(w, y, PLUS_TIMES)  # line 30
    z = gb.ewise_mult(z, bias, MAX_PLUS)  # line 31: ⊗ = +
    return gb.ewise_add(z, zero, MAX_PLUS)  # line 32: ⊕ = max


def dnn_forward(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    fused: bool = True,
    mesh=None,
) -> torch.Tensor:
    """Full L-layer forward pass (the paper's ``dnn()`` function).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`): run the stack
    sharded — every sparse layer's block-CSR segment partitioned across
    the mesh's ``row_blocks`` shards, one ``bcsr_spmm`` launch per shard,
    the partial panels summed before the bias and ReLU
    (:class:`repro_torch.plan.ShardedStackPlan`, from the shared
    :func:`repro_torch.plan.default_cache`)."""
    if mesh is not None:
        return _sharded_plan_forward(weights, biases, y0, mesh)
    y = y0
    for w, b in zip(weights, biases):
        y = dnn_layer(w, y, b, fused=fused)
    return y


def dnn_forward_all(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    fused: bool = True,
) -> list[torch.Tensor]:
    """Forward pass returning every Y[k] (the paper's Y[0..L] array)."""
    ys = [y0]
    for w, b in zip(weights, biases):
        ys.append(dnn_layer(w, ys[-1], b, fused=fused))
    return ys


def stack_bsr(mats: Sequence[BlockSparseMatrix]) -> BlockSparseMatrix:
    """Stack same-structure BSR matrices along a new leading layer axis
    (the weight stack of the fused kernels)."""
    first = mats[0]
    for m in mats[1:]:
        if (
            m.shape != first.shape
            or m.block_shape != first.block_shape
            or m.max_blocks_per_row != first.max_blocks_per_row
        ):
            raise ValueError("stack_bsr requires homogeneous BSR structure")
    return BlockSparseMatrix(
        torch.stack([m.blocks for m in mats]),
        torch.stack([m.col_idx for m in mats]),
        torch.stack([m.block_mask for m in mats]),
        first.shape,
        first.block_shape,
    )


def dnn_forward_resident(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    block_n: int = DEFAULT_BLOCK_N,
    panel_dtype=None,
    tuned=None,
    mesh=None,
) -> torch.Tensor:
    """L-layer forward as ONE launch of a fused whole-stack kernel: the
    panel resident in shared memory, or in global scratch for stacks past
    that budget (``fused-tiled``).

    The route, layouts and executable come from the shared plan cache
    (:func:`repro_torch.plan.default_cache`), so repeated calls on one
    topology and panel width reuse one plan (on the card, replay its CUDA
    graph); a stack no fused route takes runs that plan's layered
    kernels. A ``tuned`` config (:class:`repro_torch.tune.TunedConfig`)
    rides into the cache key; an explicit ``panel_dtype``, and a
    ``block_n`` other than ``DEFAULT_BLOCK_N``, override its own (the
    fused kernels take ``block_n`` 8 or 16: a fused route at another is
    refused with a ValueError). ``mesh`` overrides residency: the fused
    kernels run one unsharded stack, so a mesh runs the sharded plan, as
    in :func:`dnn_forward`.
    """
    if mesh is not None:
        return _sharded_plan_forward(weights, biases, y0, mesh)
    from repro_torch.plan.cache import default_cache
    from repro_torch.tune import TunedConfig

    override = {}
    if panel_dtype is not None:
        override["panel_dtype"] = panel_dtype
    if block_n != DEFAULT_BLOCK_N:
        override["block_n"] = block_n
    if override:
        tuned = dataclasses.replace(tuned or TunedConfig(), **override)
    plan = default_cache().get(weights, biases, max(y0.shape[1], 1), tuned=tuned)
    return plan.forward(y0)


def dnn_layer_trainable(
    w: Weight, y: torch.Tensor, b: torch.Tensor, *, transpose_plan=None
) -> torch.Tensor:
    """One differentiable layer max(W·Y + b⊗1ᵀ, 0) through the kernel
    wrappers (a dense weight takes the plain fused form, which autograd
    differentiates). ``transpose_plan`` (sparse weights) is the cached
    backward transpose of a differentiable ``repro_torch.plan`` StackPlan;
    without it every backward re-sorts the frozen topology."""
    from repro_torch.kernels import ops as kernel_ops

    if isinstance(w, BlockCSRMatrix):
        return kernel_ops.bcsr_spmm(w, y, b, transpose_plan, fuse_bias_relu=True)
    if isinstance(w, BlockSparseMatrix):
        return kernel_ops.bsr_spmm(w, y, b, transpose_plan, fuse_bias_relu=True)
    return sparse_ops.dense_matmul_fused_relu(w, y, b)


def _layer_transpose_plans(weights: Sequence[Weight], plan) -> tuple:
    """Per-layer cached transposes of a differentiable StackPlan, or
    ``None`` for each layer without a plan."""
    if plan is None:
        return (None,) * len(weights)
    if not plan.differentiable:
        raise ValueError(
            "the supplied plan is not differentiable; build it with "
            "differentiable=True (PlanCache.get(..., differentiable=True))"
        )
    if plan.n_layers != len(weights):
        raise ValueError(f"plan has {plan.n_layers} layers but the stack has {len(weights)}")
    return plan.transpose_plans


def dnn_forward_trainable(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    *,
    use_kernel: bool = True,
    plan=None,
) -> torch.Tensor:
    """L-layer forward that autograd can differentiate.

    ``use_kernel=True`` runs every sparse layer through the SpMM kernels
    (their autograd Functions: dW at stored blocks, dX by the transpose
    product); ``use_kernel=False`` the plain fused forms (the same math,
    autograd through plain PyTorch). ``plan``: a differentiable StackPlan
    for this topology, whose cached transposes make the backward
    sort-free; a :class:`repro_torch.plan.ShardedStackPlan` runs the
    whole forward and its backward sharded instead (fresh values
    re-shard through its frozen partition, gradients keep the caller's
    unsharded layout). The fused whole-stack kernels are not
    differentiable and never run here.
    """
    if getattr(plan, "is_sharded", False):
        return plan.forward_trainable(weights, biases, y0, use_kernel=use_kernel)
    tps = _layer_transpose_plans(weights, plan)
    y = y0
    for w, b, tp in zip(weights, biases, tps):
        if use_kernel:
            y = dnn_layer_trainable(w, y, b, transpose_plan=tp)
        else:
            y = dnn_layer(w, y, b, fused=True)
    return y


def _values_name(w: Weight) -> str | None:
    if isinstance(w, BlockCSRMatrix):
        return "values"
    if isinstance(w, BlockSparseMatrix):
        return "blocks"
    return None


def with_values(w: Weight, values: torch.Tensor) -> Weight:
    """``w`` with its stored values (the dense tensor itself for a dense
    weight) replaced by ``values``; topology tensors are shared."""
    name = _values_name(w)
    return values if name is None else dataclasses.replace(w, **{name: values})


def values_of(w: Weight) -> torch.Tensor:
    """The tensor that holds ``w``'s trainable values."""
    name = _values_name(w)
    return w if name is None else getattr(w, name)


def dnn_value_and_grad(
    weights: Sequence[Weight],
    biases: Sequence[torch.Tensor],
    y0: torch.Tensor,
    targets: torch.Tensor,
    *,
    use_kernel: bool = True,
    plan=None,
):
    """Mean-squared loss ``0.5·mean((forward - targets)²)`` and its
    gradients with respect to every layer's weight values and bias:
    ``(loss, (dweights, dbiases))``. A sparse weight's gradient is a
    matrix of the same class holding the value gradient and the primal's
    own topology tensors (stored blocks only; pad and tail slots 0).
    Layers that share one weight object get one gradient each, as the
    reference's list of leaves does. ``plan`` as in
    :func:`dnn_forward_trainable`."""
    leaves = [values_of(w).detach().requires_grad_() for w in weights]
    bleaves = [b.detach().requires_grad_() for b in biases]
    ws = [with_values(w, v) for w, v in zip(weights, leaves)]
    with torch.enable_grad():
        out = dnn_forward_trainable(ws, bleaves, y0, use_kernel=use_kernel, plan=plan)
        loss = 0.5 * torch.mean((out - targets) ** 2)
        grads = torch.autograd.grad(loss, leaves + bleaves)
    n = len(leaves)
    dweights = [with_values(w, g) for w, g in zip(weights, grads[:n])]
    return loss.detach(), (dweights, list(grads[n:]))
