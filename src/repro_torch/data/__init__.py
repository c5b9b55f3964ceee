"""Training data and the GraphChallenge RadiX-net workload (counterpart of
``repro.data``)."""

from repro_torch.data.pipeline import Prefetcher, SyntheticLM  # noqa: F401
