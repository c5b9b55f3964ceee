"""Carry weights from the JAX package's layouts into the port's.

The reference draws random weights from ``jax.random``, which PyTorch
cannot reproduce from a seed, so weights are always converted, never
regenerated. Every function takes the reference's arrays as numpy
arrays (``np.asarray`` of a JAX array works without importing JAX) and
returns the port's tensors on ``device``:

* :func:`bsr` — ``BlockSparseMatrix`` (blocks, col_idx, block_mask,
  shape, block_shape); a stacked matrix (leading L axis) converts the
  same way;
* :func:`bcsr` — ``BlockCSRMatrix``;
* :func:`bias` — bias vectors (or a stacked (L, m) bias);
* :func:`layout` — either matrix class, read off an object with the
  reference's attribute names;
* :func:`weight` — a layer weight of either class, or a dense array;
* :func:`cotangent` — a reference gradient of a weight in the port's
  class: its value leaf, with the topology of the port's primal (the
  reference's topology leaves are ``float0`` and carry nothing);
* :func:`model_params` — a ``repro.models`` params tree (dicts and lists
  of arrays, sparse FFN weights stacked or not) as the port's tree;
* :func:`train_state` — a ``repro.train`` ``TrainState`` (params and the
  optimizer's step and moment trees) as the port's, on one device or
  placed onto a data mesh by ``param_pspecs``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.bcsr import BlockCSRMatrix
from repro_torch.sparse.bsr import BlockSparseMatrix


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)  # a writable copy


def bsr(blocks, col_idx, block_mask, shape, block_shape, *, device="cpu") -> BlockSparseMatrix:
    """An ELL ``BlockSparseMatrix`` (stacked or not) from numpy arrays;
    the mask may be bool or int (the reference uses both)."""
    return BlockSparseMatrix(
        _t(blocks, np.float32, device),
        _t(col_idx, np.int32, device),
        _t(np.asarray(block_mask) != 0, bool, device),
        (int(shape[0]), int(shape[1])),
        (int(block_shape[0]), int(block_shape[1])),
    )


def bcsr(
    values, row_ptr, row_id, col_idx, valid, shape, block_shape, *, device="cpu"
) -> BlockCSRMatrix:
    """A ``BlockCSRMatrix`` from numpy arrays."""
    return BlockCSRMatrix(
        _t(values, np.float32, device),
        _t(row_ptr, np.int32, device),
        _t(row_id, np.int32, device),
        _t(col_idx, np.int32, device),
        _t(np.asarray(valid) != 0, bool, device),
        (int(shape[0]), int(shape[1])),
        (int(block_shape[0]), int(block_shape[1])),
    )


def bias(b, *, device="cpu") -> torch.Tensor:
    """A bias vector (m,) or stacked bias (L, m), float32."""
    return _t(b, np.float32, device)


def layout(obj, *, device="cpu"):
    """Convert an object with the reference's BSR or block-CSR attribute
    names (a ``repro.sparse`` matrix) to the port's class."""
    if hasattr(obj, "row_ptr"):
        return bcsr(obj.values, obj.row_ptr, obj.row_id, obj.col_idx, obj.valid,
                    obj.shape, obj.block_shape, device=device)
    return bsr(obj.blocks, obj.col_idx, obj.block_mask, obj.shape, obj.block_shape,
               device=device)


def weight(obj, *, device="cpu"):
    """A layer weight: a sparse matrix through :func:`layout`, anything
    else as a dense float32 tensor."""
    if hasattr(obj, "block_shape"):
        return layout(obj, device=device)
    return _t(obj, np.float32, device)


def cotangent(obj, like, *, device="cpu"):
    """The reference's gradient ``obj`` of a weight, as the port's class of
    ``like`` (the port's primal): the value leaf converted, ``like``'s
    topology tensors shared; a dense gradient as a tensor."""
    if hasattr(like, "row_ptr"):
        return dataclasses.replace(like, values=_t(obj.values, np.float32, device))
    if hasattr(like, "block_mask"):
        return dataclasses.replace(like, blocks=_t(obj.blocks, np.float32, device))
    return _t(obj, np.float32, device)


def model_params(tree, *, device="cpu"):
    """The reference's model params tree as the port's: the same dicts
    and lists, each leaf through :func:`weight` (a stacked sparse weight
    keeps its leading layer axis; arrays become float32 tensors)."""
    if isinstance(tree, dict):
        return {k: model_params(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [model_params(v, device=device) for v in tree]
    return weight(tree, device=device)


def train_state(state, *, device="cpu", mesh=None, rules=None):
    """The reference's ``TrainState(params, OptState(step, mu, nu))`` as the
    port's: params through :func:`model_params`, each moment tree as the
    flat list of its leaves (``train.checkpoint.leaves`` order; a scalar
    moment, SGD's unused ``nu``, as a host scalar) and the step as a host
    int32 scalar. With ``mesh``: placed as ``trainer.state_shardings``
    says (the weights carried across for the data mesh)."""
    from repro_torch.distribution.sharding import place
    from repro_torch.train.checkpoint import leaves
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.trainer import TrainState, state_shardings

    def moments(tree):
        if isinstance(tree, (dict, list, tuple)):
            return leaves(model_params(tree, device=device))
        return torch.from_numpy(np.array(tree, dtype=np.float32))

    opt = state.opt
    out = TrainState(model_params(state.params, device=device),
                     OptState(torch.tensor(int(np.asarray(opt.step)), dtype=torch.int32),
                              moments(opt.mu), moments(opt.nu)))
    if mesh is None:
        return out
    return place(out, state_shardings(None, out, mesh, rules))
