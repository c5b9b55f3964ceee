"""Serving the sparse DNN (counterpart of ``repro.serve``)."""

from repro_torch.serve.challenge import ChallengeResult, run_challenge  # noqa: F401
from repro_torch.serve.engine import SparseDNNEngine  # noqa: F401

__all__ = ["ChallengeResult", "SparseDNNEngine", "run_challenge"]
