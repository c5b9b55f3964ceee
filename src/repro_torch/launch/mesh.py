"""Meshes — counterpart of ``repro/launch/mesh.py``: the row-block mesh of
the sharded sparse stack and the model's local mesh.

The reference's mesh is a ``jax.sharding.Mesh`` over N devices, and its
sharded plans run one program on all of them (``shard_map``). The port
runs the same S shards from one process on ONE device: a :class:`Mesh`
names its axes and sizes like JAX's (``mesh.shape`` is a dict) and lists
the device of each position, every position the same device. That is
the port's counterpart of the reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``): the shard
count is the mesh's, the hardware one card.

The model's mesh (``make_local_mesh``) is ``data`` × ``model`` over one
card: ``data=1, model=1``. A mesh over several distinct devices (peer
copies or NCCL between cards), a local mesh of more than one position
and the reference's production mesh of 256 or 512 devices are refused:
they need the multi-card mesh, which cannot be tested on one card. The
production mesh is made on the ``meta`` device only, shapes for the
dry run.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device


def several_devices(what: str) -> str:
    """The refusal of ``what``, a mesh that needs more than one card."""
    return (f"{what} is not supported yet: the port runs every position of a mesh on "
            "one device, and a mesh across cards waits for the multi-card mesh "
            "(peer copies or NCCL between cards)")


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
            raise ValueError(several_devices(
                f"a mesh over several devices ({sorted(set(map(str, devices)))})"))
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


def make_local_mesh(data: int | None = None, model: int = 1, *, device=None) -> Mesh:
    """The model's ``("data", "model")`` mesh over the devices there are:
    one, ``device`` (default: the GPU, raising if there is none).
    ``data=None`` takes what ``model`` leaves of them. Anything but
    ``data=1, model=1`` needs several cards and is refused."""
    device = resolve_device(device)
    if data is None:
        data = 1 // model  # the reference's devices // model, over one device
    if (data, model) != (1, 1):
        raise ValueError(several_devices(f"a local mesh of data={data} x model={model}"))
    return Mesh(("data", "model"), (1, 1), (device,))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) with an outer ``"pod"`` axis. Only ``device="meta"`` is
    taken: a shapes-only mesh, every position ``meta``, for the dry run
    (``repro_torch.launch.dryrun``), which reads its ``shape``. On any
    other device it is refused: its 256 or 512 devices need the
    multi-card mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None or torch.device(device).type != "meta":
        raise ValueError(several_devices(f"the production mesh {shape}"))
    return Mesh(axes, shape, (torch.device("meta"),) * math.prod(shape))
