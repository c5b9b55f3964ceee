"""The row-block mesh of the sharded sparse stack — counterpart of
``make_row_blocks_mesh`` in ``repro/launch/mesh.py``.

The reference's mesh is a ``jax.sharding.Mesh`` over N devices, and its
sharded plans run one program on all of them (``shard_map``). The port
runs the same S shards from one process on ONE device: a :class:`Mesh`
names its axes and sizes like JAX's (``mesh.shape`` is a dict) and lists
the device of each position, every position the same device. That is
the port's counterpart of the reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``): the shard
count is the mesh's, the hardware one card.

A mesh over several distinct devices (peer copies or NCCL between cards)
is refused: it cannot be tested on one card and waits for a four-chip
slice (ROADMAP Queue 1 item 5). The reference's LLM meshes
(``make_local_mesh``, ``make_production_mesh``) go with the LLM
scaffolding (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


def normalized_device(device) -> torch.device:
    """``device`` with its index spelled out (``cuda`` → ``cuda:<current>``),
    so two spellings of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a flat tuple of device positions, all one device."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} axis sizes")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be >= 1, got {self.axis_sizes}")
        if len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{math.prod(self.axis_sizes)} positions")
        devices = tuple(normalized_device(d) for d in self.devices)
        if len(set(devices)) > 1:
            raise ValueError(
                f"a mesh over several devices ({sorted(set(map(str, devices)))}) is not "
                "supported yet: the port runs every shard on one device, and a mesh "
                "across cards waits for a four-chip slice (ROADMAP Queue 1 item 5)")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every position of the mesh runs on."""
        return self.devices[0]


def make_row_blocks_mesh(shards: int | None = None, *, device=None) -> Mesh:
    """1-D mesh over the ``row_blocks`` axis, the sparse stack's shard
    axis (``repro_torch.sparse.partition``, ``repro_torch.plan.sharded``).

    Every one of the ``shards`` positions is ``device`` (default: the
    GPU, raising if there is none; tests pass ``device="cpu"``).
    ``shards=None`` takes ``torch.cuda.device_count()``, the reference's
    "every visible device".
    """
    device = resolve_device(device)
    if shards is None:
        shards = torch.cuda.device_count()
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    return Mesh(("row_blocks",), (shards,), (device,) * shards)
