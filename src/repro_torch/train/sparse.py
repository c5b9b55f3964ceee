"""Training loop of the paper's sparse MLP — counterpart of ``repro/train/sparse.py``.

An L-layer list of (W, b), W dense, ELL-BSR or block-CSR, trained
through ``repro_torch.core.dnn.dnn_value_and_grad``: the forward runs the
SpMM kernels, the backward their autograd Functions (dX = Wᵀ·dZ, the
block-CSR one a ``bcsr_spmm`` launch on the transpose; dW only at the
stored blocks). The topology is frozen by construction: no gradient
reaches a block the primal does not store, so masked retraining needs no
separate mask.

The optimizer (``repro_torch.train.optimizer``) sees the stack as one
flat list of tensors, ``checkpoint.leaves((weights, biases))``: each
weight's tensors in the reference's leaf order (values then topology),
then the biases. Topology tensors are skipped by dtype, and the new
state's matrices share the old topology tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.core import dnn
from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix
from repro_torch.train.checkpoint import leaves, with_leaves
from repro_torch.train.optimizer import Optimizer, OptState, global_norm


class SparseMLPState(NamedTuple):
    weights: tuple  # per-layer dense / BlockSparseMatrix / BlockCSRMatrix
    biases: tuple
    opt: OptState

    @property
    def params(self) -> tuple:
        """The tree the optimizer's moments follow (``checkpoint.state_tree``)."""
        return (self.weights, self.biases)


def init_sparse_mlp_state(
    weights: Sequence[dnn.Weight], biases: Sequence[torch.Tensor], optimizer: Optimizer
) -> SparseMLPState:
    return SparseMLPState(tuple(weights), tuple(biases),
                          optimizer.init(leaves((tuple(weights), tuple(biases)))))


def make_sparse_train_step(optimizer: Optimizer, *, use_kernel: bool = True, plan=None):
    """``step(state, batch) -> (state, metrics)`` for the sparse stack.

    ``batch``: ``{"y0": (m, n) panel, "targets": (m, n)}`` (features down,
    batch across). ``use_kernel=True`` runs the SpMM kernels and their
    backward; ``False`` the plain forms (same math, plain autograd).
    ``plan``: a differentiable StackPlan for the state's topology
    (``build_plan(weights, biases, n, differentiable=True)``); its cached
    block-CSR transposes keep every backward free of sorts. A sharded
    plan (``build_sharded_plan(..., differentiable=True)``) runs both
    passes per shard instead: fresh values re-shard through its frozen
    partition each step and the gradients come back on the caller's
    unsharded block-CSR layout, so the update is unchanged. ``metrics``
    holds the loss and the gradients' global norm as device scalars.
    """

    def step(state: SparseMLPState, batch) -> tuple[SparseMLPState, dict]:
        loss, (dweights, dbiases) = dnn.dnn_value_and_grad(
            state.weights, state.biases, batch["y0"], batch["targets"],
            use_kernel=use_kernel, plan=plan,
        )
        grads = leaves((tuple(dweights), tuple(dbiases)))
        new_flat, new_opt = optimizer.update(grads, state.opt, leaves(state.params))
        weights, biases = with_leaves(state.params, new_flat)
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
