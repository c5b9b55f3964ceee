"""Sparse weight layouts over torch tensors (counterpart of ``repro.sparse``)."""

from repro_torch.sparse.bcsr import BlockCSRMatrix  # noqa: F401
from repro_torch.sparse.bsr import BlockSparseMatrix  # noqa: F401

__all__ = ["BlockCSRMatrix", "BlockSparseMatrix"]
