"""Training of the sparse MLP (counterpart of ``repro.train``): the
optimizers and the sparse train step."""

from repro_torch.train.optimizer import adamw, sgd  # noqa: F401
from repro_torch.train.sparse import (  # noqa: F401
    SparseMLPState,
    grad_sparsity_preserved,
    init_sparse_mlp_state,
    make_sparse_train_step,
)
