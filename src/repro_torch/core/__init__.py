"""The sparse DNN forward (counterpart of ``repro.core``)."""
