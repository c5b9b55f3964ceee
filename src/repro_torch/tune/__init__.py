"""Deterministic kernel autotuner and cached tuning table (counterpart of
``repro.tune``).

Per ``(topology fingerprint, backend, dtype)`` the sweep tries the knobs
the plan builder takes — the column tile ``block_n``, the weight block
size, a forced layout (ELL or block-CSR), bf16 activation panels and the
resident kernel's shared-memory budget — scores each candidate with the
port's launch bill (``repro_torch.plan.cost``), and keeps the winner in
a versioned :class:`TuningTable`, in the reference's file format, that
``SparseDNNEngine`` and ``run_challenge`` consult before the defaults.
Selection is by the cost model; wall-clock is recorded, never used to
pick.
"""

from repro_torch.tune.sweep import (  # noqa: F401
    default_candidates,
    sweep_stack,
    tune_stack,
)
from repro_torch.tune.table import (  # noqa: F401
    SCHEMA_VERSION,
    TunedConfig,
    TuningTable,
    TuningTableError,
    entry_key,
)

__all__ = [
    "SCHEMA_VERSION",
    "TunedConfig",
    "TuningTable",
    "TuningTableError",
    "default_candidates",
    "entry_key",
    "sweep_stack",
    "tune_stack",
]
