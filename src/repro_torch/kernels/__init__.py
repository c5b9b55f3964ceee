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
# the TPU lane width (repro/kernels/__init__.py:27). Here one CTA owns a
# stripe of DEFAULT_BLOCK_N columns: 16 keeps the fused kernel's f32
# ping-pong panel of a 1024-neuron stack at 2·1024·16·4 B = 128 KB, inside
# the 227 KB of shared memory a Hopper block can hold, and gives the
# block-CSR kernel 16×16 = 256-thread CTAs at block size 16. It is also
# the unit of the launch bills (``plan/cost.py``): the dense and ELL
# kernels cover wider tiles a CTA and are billed in 16-wide tiles all
# the same.
DEFAULT_BLOCK_N = 16

__all__ = ["DEFAULT_BLOCK_N"]
