"""Training loop of the paper's sparse MLP — counterpart of ``repro/train/sparse.py``.

An L-layer list of (W, b), W dense, ELL-BSR or block-CSR, trained
through ``repro_torch.core.dnn.dnn_value_and_grad``: the forward runs the
SpMM kernels, the backward their autograd Functions (dX = Wᵀ·dZ, the
block-CSR one a ``bcsr_spmm`` launch on the transpose; dW only at the
stored blocks). The topology is frozen by construction: no gradient
reaches a block the primal does not store, so masked retraining needs no
separate mask.

The optimizer (``repro_torch.train.optimizer``) sees the stack as one
flat list of tensors: each weight's tensors in the reference's leaf
order (values then topology), then the biases. Topology tensors are
skipped by dtype, and the new state's matrices share the old topology
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core import dnn
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.train.optimizer import Optimizer, OptState, global_norm


class SparseMLPState(NamedTuple):
    weights: tuple  # per-layer dense / BlockSparseMatrix / BlockCSRMatrix
    biases: tuple
    opt: OptState


LEAF_FIELDS = {  # a sparse matrix's tensors, in the reference's leaf order
    BlockSparseMatrix: ("blocks", "col_idx", "block_mask"),
    BlockCSRMatrix: ("values", "row_ptr", "row_id", "col_idx", "valid"),
}


def flatten(weights: Sequence[dnn.Weight], biases: Sequence[torch.Tensor]) -> list:
    """The stack as the optimizer's flat list of tensors (the order of the
    reference's ``jax.tree.leaves((weights, biases))``)."""
    flat = []
    for w in weights:
        fields = LEAF_FIELDS.get(type(w))
        flat.extend([w] if fields is None else [getattr(w, f) for f in fields])
    return flat + list(biases)


def unflatten(like: Sequence[dnn.Weight], flat: Sequence[torch.Tensor]) -> tuple[tuple, tuple]:
    """Inverse of :func:`flatten`, with ``like``'s classes and shapes."""
    weights, i = [], 0
    for w in like:
        fields = LEAF_FIELDS.get(type(w))
        if fields is None:
            weights.append(flat[i])
            i += 1
        else:
            weights.append(dataclasses.replace(w, **dict(zip(fields, flat[i:i + len(fields)]))))
            i += len(fields)
    return tuple(weights), tuple(flat[i:])


def state_tree(state: SparseMLPState) -> SparseMLPState:
    """``state`` as the reference's tree of the same state: the optimizer's
    moments (flat lists here) shaped like the ``(weights, biases)`` they
    follow, as the reference's ``OptState`` holds them; a scalar moment
    (SGD's unused ``nu``) stays as it is. What a checkpoint keys by."""

    def shaped(moments):
        return moments if isinstance(moments, torch.Tensor) else unflatten(state.weights, moments)

    opt = state.opt
    return SparseMLPState(state.weights, state.biases,
                          opt._replace(mu=shaped(opt.mu), nu=shaped(opt.nu)))


def state_from_tree(tree: SparseMLPState) -> SparseMLPState:
    """Inverse of :func:`state_tree`."""

    def flat(moments):
        return moments if isinstance(moments, torch.Tensor) else flatten(*moments)

    opt = tree.opt
    return SparseMLPState(tree.weights, tree.biases, opt._replace(mu=flat(opt.mu), nu=flat(opt.nu)))


def init_sparse_mlp_state(
    weights: Sequence[dnn.Weight], biases: Sequence[torch.Tensor], optimizer: Optimizer
) -> SparseMLPState:
    return SparseMLPState(tuple(weights), tuple(biases),
                          optimizer.init(flatten(weights, biases)))


def make_sparse_train_step(optimizer: Optimizer, *, use_kernel: bool = True, plan=None):
    """``step(state, batch) -> (state, metrics)`` for the sparse stack.

    ``batch``: ``{"y0": (m, n) panel, "targets": (m, n)}`` (features down,
    batch across). ``use_kernel=True`` runs the SpMM kernels and their
    backward; ``False`` the plain forms (same math, plain autograd).
    ``plan``: a differentiable StackPlan for the state's topology
    (``build_plan(weights, biases, n, differentiable=True)``); its cached
    block-CSR transposes keep every backward free of sorts. ``metrics``
    holds the loss and the gradients' global norm as device scalars.
    """

    def step(state: SparseMLPState, batch) -> tuple[SparseMLPState, dict]:
        loss, (dweights, dbiases) = dnn.dnn_value_and_grad(
            state.weights, state.biases, batch["y0"], batch["targets"],
            use_kernel=use_kernel, plan=plan,
        )
        grads = flatten(dweights, dbiases)
        params = flatten(state.weights, state.biases)
        new_flat, new_opt = optimizer.update(grads, state.opt, params)
        weights, biases = unflatten(state.weights, new_flat)
        return SparseMLPState(weights, biases, new_opt), {"loss": loss,
                                                          "grad_norm": global_norm(grads)}

    return step


def grad_sparsity_preserved(weights: Sequence[Any], grads: Sequence[Any]) -> bool:
    """True iff every sparse weight's gradient is exactly zero outside the
    primal's stored pattern (ELL pad slots, block-CSR tail slots)."""
    for w, g in zip(weights, grads):
        if isinstance(w, BlockSparseMatrix):
            off = g.blocks[~w.block_mask]
        elif isinstance(w, BlockCSRMatrix):
            off = g.values[~w.valid]
        else:
            continue
        if off.numel() and bool(off.abs().max() != 0):
            return False
    return True
