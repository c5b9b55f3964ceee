"""Training (counterpart of ``repro.train``): the optimizers, the model
API's train step, the sparse MLP's train step, checkpoints, the restart
supervisor and resilient training."""

from repro_torch.train import checkpoint  # noqa: F401
from repro_torch.train.fault_tolerance import StragglerPolicy, Supervisor  # noqa: F401
from repro_torch.train.optimizer import adamw, sgd  # noqa: F401
from repro_torch.train.resilience import (  # noqa: F401
    NonFiniteLossError,
    run_resilient_training,
    validate_sparse_state,
)
from repro_torch.train.sparse import (  # noqa: F401
    SparseMLPState,
    grad_sparsity_preserved,
    init_sparse_mlp_state,
    make_sparse_train_step,
)
from repro_torch.train.trainer import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
