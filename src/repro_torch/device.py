"""Device resolution and placement shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU.

    With no GPU present, ``None`` raises rather than falling back to
    the CPU: a caller who wants the CPU (the tests) says so.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch entry points run on "
            "the GPU by default — pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return torch.device("cuda")


def to_device(objs, device) -> tuple:
    """``objs`` (tensors or sparse matrices) moved to ``device``; objects
    that appear more than once (RadiX-net layers sharing one phase's
    matrix) are moved once and stay shared."""
    moved: dict[int, object] = {}
    for obj in objs:
        if id(obj) not in moved:
            moved[id(obj)] = obj.to(device)
    return tuple(moved[id(obj)] for obj in objs)


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op off the card)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
