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
# the TPU lane width (repro/kernels/__init__.py:27). Here 16 gives the
# block-CSR kernel 16×16 = 256-thread CTAs at block size 16, and the
# wrappers pad panels to it (to 8 below 16 columns). It is also the unit
# of the launch bills (``plan/cost.py``): the dense, ELL and fused
# kernels cover other tiles a CTA or warp and are billed in 16-wide
# tiles all the same.
DEFAULT_BLOCK_N = 16

__all__ = ["DEFAULT_BLOCK_N"]
