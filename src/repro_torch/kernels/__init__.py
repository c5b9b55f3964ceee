"""Hand-written CUDA C++ kernels for Hopper, their plain PyTorch versions,
and the wrappers (``ops``) the plans call.

Kernel menu (counterparts of ``repro.kernels``):

  bsr_spmm  — ELL-padded BSR × dense, fused bias+ReLU epilogue.
  bcsr_spmm — occupancy-exact block-CSR × dense, same epilogue.
  fused_mlp — the whole homogeneous square stack in one launch, with the
      ping-pong activation panel in shared memory (resident) or in
      global scratch (tiled).

Every kernel module holds the launch of its kernel and the plain version
of the same function. The wrappers in ``ops`` take the plain version only
for CPU tensors; for CUDA tensors they launch the kernel or raise.
"""

# The column-tile width every kernel defaults to. The reference's 128 is
# the TPU lane width (repro/kernels/__init__.py:27). Here one CTA owns a
# stripe of DEFAULT_BLOCK_N columns: 16 keeps the fused kernel's f32
# ping-pong panel of a 1024-neuron stack at 2·1024·16·4 B = 128 KB, inside
# the 227 KB of shared memory a Hopper block can hold, and gives the
# SpMM kernels 16×16 = 256-thread CTAs at block size 16.
DEFAULT_BLOCK_N = 16

__all__ = ["DEFAULT_BLOCK_N"]
