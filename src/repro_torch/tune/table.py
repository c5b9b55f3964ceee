"""The on-disk tuning table — counterpart of ``repro/tune/table.py``.

A :class:`TuningTable` maps ``(topology fingerprint, backend, dtype)``
to the :class:`TunedConfig` the sweep (``repro_torch.tune.sweep``)
selected for that stack, so tuning happens once per topology and every
later plan build is a dictionary lookup. The file format is the
reference's, so either package reads a table the other wrote::

    {
      "schema_version": 1,
      "entries": {
        "<fingerprint>:<backend>:<dtype>": {
          "config": {"block_n": 8, "panel_dtype": "bfloat16", ...},
          "grid_steps": 1234, "block_work": 315904, ...
        }
      }
    }

The port's backend key is the torch device type, ``"cuda"`` on the card
and ``"cpu"`` on the CPU (:func:`default_backend`): never the JAX
package's ``"gpu"`` or ``"tpu"``, so a table tuned for the Pallas
kernels, whose tiles mean something else, never steers the CUDA ones.

What the knobs mean on the port (``repro_torch.plan.build_plan``):
``block_size`` re-blocks layered execution weights, ``layout`` forces
ELL or block-CSR on them, ``panel_dtype`` gives the fused kernels bf16
panels, ``block_n`` is the column tile the wrappers pad panels to and
bill in (the fused kernels take 8 or 16), and ``vmem_limit_bytes`` keeps
the reference's name but is the shared-memory budget of the resident
kernel, at most ``SMEM_LIMIT_BYTES``.

``load`` refuses what the reference refuses: a wrong or missing
``schema_version``, non-object entries, unknown config knobs — all raise
:class:`TuningTableError`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping

import numpy as np
import torch

SCHEMA_VERSION = 1

# The only knobs a table entry may carry, in the reference's order (the
# token lists them in this order).
_KNOBS = ("block_size", "block_n", "layout", "panel_dtype", "vmem_limit_bytes")
_LAYOUTS = ("ell", "bcsr")

_PANEL_DTYPES = {
    "float32": "float32", "bfloat16": "bfloat16",
    torch.float32: "float32", torch.bfloat16: "bfloat16",
    np.float32: "float32", np.dtype(np.float32): "float32",
}


class TuningTableError(ValueError):
    """A tuning-table file failed schema validation on load."""


def panel_dtype_name(panel_dtype) -> str:
    """``"float32"`` or ``"bfloat16"`` for a name, a torch dtype or numpy's
    float32 (numpy has no bfloat16 without ``ml_dtypes``, so the names are
    mapped here rather than through ``np.dtype``)."""
    try:
        return _PANEL_DTYPES[panel_dtype]
    except (KeyError, TypeError):
        raise ValueError(
            f"panel_dtype must be float32 or bfloat16, got {panel_dtype!r}") from None


def default_backend(device=None) -> str:
    """The backend key of a table entry: the device type (``"cuda"`` or
    ``"cpu"``) of ``device``, or, with none given, of the device the
    port's entry points default to (the GPU when there is one)."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One tuned kernel configuration, every knob optional: ``None`` keeps
    the default, so ``TunedConfig()`` is the untuned plan. ``token()`` is
    the string that lands in :class:`~repro_torch.plan.PlanKey`, so tuned
    and untuned plans never share a cache slot."""

    block_size: int | None = None  # re-block layered sparse weights to (b, b)
    block_n: int | None = None  # column tile the wrappers pad to and bill in
    layout: str | None = None  # force "ell" or "bcsr" (layered route)
    panel_dtype: str | None = None  # "bfloat16" activation panels
    vmem_limit_bytes: int | None = None  # the resident kernel's shared-memory budget

    def __post_init__(self):
        if self.layout is not None and self.layout not in _LAYOUTS:
            raise ValueError(f"layout must be one of {_LAYOUTS}, got {self.layout!r}")
        if self.panel_dtype is not None:
            object.__setattr__(self, "panel_dtype", panel_dtype_name(self.panel_dtype))

    @property
    def is_default(self) -> bool:
        return all(getattr(self, k) is None for k in _KNOBS)

    def token(self) -> str:
        """Deterministic cache-key fragment (the reference's token of the
        same config)."""
        parts = [f"{k}={getattr(self, k)}" for k in _KNOBS if getattr(self, k) is not None]
        return ",".join(parts) if parts else "default"

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in _KNOBS if getattr(self, k) is not None}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TunedConfig":
        unknown = set(d) - set(_KNOBS)
        if unknown:
            raise TuningTableError(
                f"unknown tuning knobs {sorted(unknown)}; known: {list(_KNOBS)}")
        return cls(**dict(d))


def entry_key(fingerprint: str, backend: str, dtype: str) -> str:
    return f"{fingerprint}:{backend}:{dtype}"


class TuningTable:
    """In-memory view of one tuning-table file: :func:`entry_key` strings
    to records, each the selected ``config`` plus the sweep's evidence
    (bills of the tuned and the default plan, wall-clock, probe width,
    route, error), so a committed table can be audited."""

    def __init__(self, entries: dict[str, dict] | None = None):
        self.entries: dict[str, dict] = dict(entries or {})

    def __len__(self) -> int:
        return len(self.entries)

    def put(
        self,
        fingerprint: str,
        backend: str,
        dtype: str,
        config: TunedConfig,
        evidence: Mapping[str, Any] | None = None,
    ) -> None:
        record = {"config": config.to_dict()}
        if evidence:
            record.update(evidence)
        self.entries[entry_key(fingerprint, backend, dtype)] = record

    def record(
        self, fingerprint: str, *, backend: str | None = None, dtype: str = "float32"
    ) -> dict | None:
        """The full evidence record for this stack, or ``None``;
        ``backend=None`` is :func:`default_backend`."""
        if backend is None:
            backend = default_backend()
        return self.entries.get(entry_key(fingerprint, backend, dtype))

    def lookup(
        self, fingerprint: str, *, backend: str | None = None, dtype: str = "float32"
    ) -> TunedConfig | None:
        """The tuned config for this stack, or ``None`` on a miss; a table
        tuned on one backend never steers another."""
        record = self.record(fingerprint, backend=backend, dtype=dtype)
        return None if record is None else TunedConfig.from_dict(record["config"])

    def to_json(self) -> dict:
        return {"schema_version": SCHEMA_VERSION, "entries": self.entries}

    def save(self, path: str | os.PathLike) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "TuningTable":
        try:
            with open(path) as f:
                raw = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise TuningTableError(f"cannot read tuning table {path}: {e}") from e
        if not isinstance(raw, dict):
            raise TuningTableError("tuning table root must be an object")
        version = raw.get("schema_version")
        if version != SCHEMA_VERSION:
            raise TuningTableError(
                f"tuning table schema_version {version!r} != {SCHEMA_VERSION}; "
                "re-run the tuner")
        entries = raw.get("entries")
        if not isinstance(entries, dict):
            raise TuningTableError("tuning table 'entries' must be an object")
        for key, record in entries.items():
            if not isinstance(record, dict) or "config" not in record:
                raise TuningTableError(f"tuning table entry {key!r} missing 'config'")
            TunedConfig.from_dict(record["config"])  # validates the knobs
        return cls(entries)
