"""Sparse weight layouts over torch tensors (counterpart of ``repro.sparse``)."""

from repro_torch.sparse.bcsr import BcsrTransposePlan, BlockCSRMatrix  # noqa: F401
from repro_torch.sparse.bsr import BlockSparseMatrix  # noqa: F401
from repro_torch.sparse.partition import (  # noqa: F401
    ShardedBlockCSR,
    partition_block_csr,
    stack_transpose_plans,
)

__all__ = [
    "BcsrTransposePlan",
    "BlockCSRMatrix",
    "BlockSparseMatrix",
    "ShardedBlockCSR",
    "partition_block_csr",
    "stack_transpose_plans",
]
