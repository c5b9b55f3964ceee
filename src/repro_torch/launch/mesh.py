"""Meshes — counterpart of ``repro/launch/mesh.py``: the row-block mesh of
the sharded sparse stack and the model's local mesh.

The reference's mesh is a ``jax.sharding.Mesh`` over N devices, and its
sharded plans run one program on all of them (``shard_map``). The port
runs the same S shards from one process. A :class:`Mesh` names its axes
and sizes like JAX's (``mesh.shape`` is a dict) and lists the device of
each position, in one of two forms:

* every position the same device: the S shards run on one card (or the
  CPU, as the tests do), the port's counterpart of the reference's
  forced host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``);
* every position its own CUDA card (``make_row_blocks_mesh(devices=...)``
  or, on a host with several cards, ``make_row_blocks_mesh()``): shard s
  launches on card s, and the sharded plan moves partial panels between
  the cards by peer copies (``repro_torch.distribution.peer``).

A mix of the two is refused, and so is a mesh of more cards than the
host has. ``Mesh.device`` is the home card, position 0, where a sharded
engine's panels and answers live.

The model's mesh (``make_local_mesh``) is ``data`` × ``model``: D × M
positions in row-major order, as ``jax.make_mesh((D, M), ...)`` orders
devices (position ``c·M + m`` is data index c, model index m), one card
each or all on one device. The model API trains over it
(``repro_torch.train.trainer``): the train state stored as
``param_pspecs`` says, each data index's group of M positions computing
its rows with heads, hidden columns, experts and vocab split over the
group (``repro_torch.distribution.tensor_parallel``). The reference's
production mesh of 256 or 512 devices is built one card a position
when the host has them, and on the ``meta`` device (shapes for the dry
run) anywhere.
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
    """Named axes over a flat tuple of device positions: all one device,
    or each position its own CUDA card."""

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
        distinct = set(devices)
        if 1 < len(distinct) < len(devices):
            raise ValueError(
                f"a mesh mixing shared and distinct devices ({list(map(str, devices))}) is "
                "refused: a multi-card mesh gives every position its own card")
        if len(distinct) > 1 and any(d.type != "cuda" for d in devices):
            raise ValueError(
                f"a mesh over several devices ({sorted(map(str, distinct))}) is a "
                "multi-card mesh: its positions must be distinct CUDA cards")
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
        """The home device, position 0's: every position's on a one-device
        mesh, and where a multi-card mesh's panels and answers live."""
        return self.devices[0]

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The distinct devices in position order: one for a one-device
        mesh, one a position for a multi-card mesh."""
        return tuple(dict.fromkeys(self.devices))


def missing_cards(indices) -> str | None:
    """What a mesh over the CUDA cards ``indices`` lacks on this host
    (None: nothing)."""
    count = torch.cuda.device_count()
    missing = [i for i in indices if i >= count]
    if not missing:
        return None
    names = f"cuda:{missing[0]}" + (f" … cuda:{missing[-1]}" if len(missing) > 1 else "")
    return (f"the mesh names {names} ({len(missing)} card{'s' * (len(missing) != 1)} "
            f"missing), but this host has {count} CUDA card{'s' * (count != 1)}")


def require_cards(devices) -> None:
    """Raise unless every CUDA device of ``devices`` is a card this host
    has: a mesh never runs on fewer cards than it names."""
    missing = missing_cards([d.index for d in devices if d.type == "cuda"])
    if missing:
        raise RuntimeError(missing)


def make_row_blocks_mesh(shards: int | None = None, *, device=None, devices=None) -> Mesh:
    """1-D mesh over the ``row_blocks`` axis, the sparse stack's shard
    axis (``repro_torch.sparse.partition``, ``repro_torch.plan.sharded``).

    ``devices``: one CUDA card a position (``shards``, if given, must
    count them). Otherwise every one of the ``shards`` positions is
    ``device`` (default: the GPU, raising if there is none; tests pass
    ``device="cpu"``). ``shards=None`` with neither takes every visible
    card, one position each, the reference's "every visible device";
    with ``device`` alone it takes ``torch.cuda.device_count()``
    positions on it. A card the host does not have raises.
    """
    if devices is not None:
        if device is not None:
            raise ValueError("pass device (one device for every position) or devices "
                             "(one card a position), not both")
        devices = tuple(normalized_device(d) for d in devices)
        if shards is not None and shards != len(devices):
            raise ValueError(f"shards={shards} but {len(devices)} devices")
        shards = len(devices)
    elif shards is None and device is None:
        resolve_device(None)  # raises without a GPU
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        shards = len(devices)
    else:
        device = resolve_device(device)
        if shards is None:
            shards = torch.cuda.device_count()
        devices = (device,) * max(shards, 0)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    mesh = Mesh(("row_blocks",), (shards,), devices)
    require_cards(mesh.cards)
    return mesh


def make_local_mesh(data: int | None = None, model: int = 1, *, device=None,
                    devices=None) -> Mesh:
    """The model's ``("data", "model")`` mesh of ``data`` × ``model``
    positions, position ``c·model + m`` at data index c and model index m.

    ``devices``: one CUDA card a position, in that order (``data``, if
    given, must make their count with ``model``). ``device``: the
    positions (``data`` default 1) all on it, the port's counterpart of
    the reference's forced host devices; the tests pass ``device="cpu"``.
    Neither: ``data × model`` cards, one a position, or with
    ``data=None`` every visible card over ``model``, as the reference's
    mesh takes every device (raising without a GPU). A card the host does
    not have raises."""
    if model < 1:
        raise ValueError(f"model must be >= 1, got {model}")
    if devices is not None:
        if device is not None:
            raise ValueError("pass device (one device for every position) or devices "
                             "(one card a position), not both")
        devices = tuple(normalized_device(d) for d in devices)
        if data is not None and data * model != len(devices):
            raise ValueError(f"data={data} but {len(devices)} devices"
                             + (f" for model={model}" if model > 1 else ""))
    elif device is not None:
        devices = (resolve_device(device),) * ((1 if data is None else data) * model)
    else:
        resolve_device(None)  # raises without a GPU
        n = torch.cuda.device_count() // model if data is None else data
        devices = tuple(torch.device("cuda", i) for i in range(n * model))
    if len(devices) < 1 or len(devices) % model:
        raise ValueError(f"{len(devices)} devices do not make a mesh of model={model}")
    mesh = Mesh(("data", "model"), (len(devices) // model, model), devices)
    require_cards(mesh.cards)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) with an outer ``"pod"`` axis. ``device="meta"``: a
    shapes-only mesh, every position ``meta``, for the dry run
    (``repro_torch.launch.dryrun``), which places a plan's arguments on it
    and runs the mesh path over its positions. Otherwise
    one CUDA card a position, refused on a host without its 256 (or 512)
    cards, naming the missing ones."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        return Mesh(axes, shape, (torch.device("meta"),) * n)
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"the production mesh {shape} is one CUDA card a position "
                         f"(or meta), not {device}")
    missing = missing_cards(range(n))
    if missing:
        raise ValueError(f"the production mesh {shape}: {missing}")
    return Mesh(axes, shape, tuple(torch.device("cuda", i) for i in range(n)))
