"""GraphChallenge RadiX-net workload (counterpart of ``repro.data.radixnet``)."""
