"""Tuned kernel configurations — counterpart of ``TunedConfig`` in
``repro/tune/table.py``.

A :class:`TunedConfig` names the kernel knobs a plan is built under;
``None`` keeps a knob's default, and :meth:`TunedConfig.token` is the
string that lands in :class:`~repro_torch.plan.PlanKey` so tuned and
untuned plans never share a cache slot. The port's plans honour one knob
of the reference's five, ``panel_dtype`` (the fused kernels take bf16
panels); the others, the on-disk ``TuningTable`` and its sweep come
together with the code that honours them (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_PANEL_DTYPES = {
    "float32": "float32", "bfloat16": "bfloat16",
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    np.float32: "float32", np.dtype(np.float32): "float32",
}


def panel_dtype_name(panel_dtype) -> str:
    """``"float32"`` or ``"bfloat16"`` for a name, a torch dtype or numpy's
    float32 (numpy has no bfloat16 without ``ml_dtypes``, so the names are
    mapped here rather than through ``np.dtype``)."""
    try:
        return _PANEL_DTYPES[panel_dtype]
    except (KeyError, TypeError):
        raise ValueError(
            f"panel_dtype must be float32 or bfloat16, got {panel_dtype!r}") from None


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One tuned kernel configuration; ``TunedConfig()`` is the untuned plan."""

    panel_dtype: str | None = None  # "bfloat16" activation panels

    def __post_init__(self):
        if self.panel_dtype is not None:
            object.__setattr__(self, "panel_dtype", panel_dtype_name(self.panel_dtype))

    @property
    def is_default(self) -> bool:
        return self.panel_dtype is None

    def token(self) -> str:
        """Deterministic cache-key fragment for this config (the reference's
        token of the same config)."""
        return "default" if self.panel_dtype is None else f"panel_dtype={self.panel_dtype}"
