"""The semiring algebra, the GraphBLAS primitives and the sparse DNN
forward (counterpart of ``repro.core``)."""
