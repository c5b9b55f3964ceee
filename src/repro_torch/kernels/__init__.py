"""Hand-written CUDA C++ kernels for Hopper, their plain PyTorch versions,
and the wrappers (``ops``) the plans call.

Kernel menu (counterparts of ``repro.kernels``):

  semiring_matmul — dense × dense, fused bias+ReLU epilogue.
  bsr_spmm  — ELL-padded BSR × dense, same epilogue.
  bcsr_spmm — occupancy-exact block-CSR × dense, same epilogue.
  fused_mlp — the whole homogeneous square stack in one launch, with the
      ping-pong activation panel in shared memory (resident) or in
      global scratch (tiled).

The first three take every semiring of the registry; their device
functors live in ``csrc/semiring.cuh``, their f32 lowering in
``semirings``.

Every kernel module holds the launch of its kernel and the plain version
of the same function. The wrappers in ``ops`` take the plain version only
for CPU tensors; for CUDA tensors they launch the kernel or raise.
"""

# The column-tile width every kernel defaults to. The reference's 128 is
# the TPU lane width (repro/kernels/__init__.py:27). Here 16 is the width
# the wrappers pad panels to (8 below 16 columns) and the unit of the
# launch bills (``plan/cost.py``). No kernel runs 16-wide CTAs: a dense
# CTA covers 64 × 64 outputs (16 × 8 on narrow panels), an ELL or
# block-CSR CTA a block-row (or a piece of one) × 128 columns (× 8), a
# fused warp 8 or 32 columns; all are billed in 16-wide tiles all the
# same.
DEFAULT_BLOCK_N = 16

__all__ = ["DEFAULT_BLOCK_N"]
