"""Tuned kernel configurations (counterpart of ``repro.tune``): the
:class:`TunedConfig` a plan is built under. The tuning table and its
sweep wait for ROADMAP Queue 1 item 4."""

from repro_torch.tune.table import TunedConfig  # noqa: F401

__all__ = ["TunedConfig"]
