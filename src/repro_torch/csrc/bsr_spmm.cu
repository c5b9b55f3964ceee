// ELL-padded block-sparse (BSR) x dense product with the fused
// bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_spmm.py::_kernel
// (pallas_call at bsr_spmm.py:142), plus_times form:
//     C = A . B,  optionally C = max(C + bias, 0),
// with A stored as (nrb, mbpr, bs_r, bs_c) blocks, a block-column table
// col_idx (nrb, mbpr) and a validity mask; B dense (k, n) row-major.
//
// Design: one CTA per (block-row i, column tile j); thread (c, r) owns
// output element (i*bs_r + r, j*bn + c) and keeps its sum in a register.
// The CTA walks the block-row's mbpr slots, skips masked (padding)
// slots, and for each stored block reads its weight row and the
// gathered B rows straight from global memory (L1/L2 serve the reuse
// across the tile). The TPU's sequential t grid axis becomes this loop.
//
// Bound: at the serving shapes (bs = 16, n = 512) the product does
// 2*bs*bs*n flops per stored block against bs*bs*4 weight bytes; reads
// of B repeat per block-row, so with no tiling in shared memory the
// kernel is held by load instructions, not by HBM bytes or FMA rate.
// Shared-memory staging and tensor cores are later work (see PERF.md).
#include <cuda_runtime.h>

namespace {

__global__ void bsr_spmm_kernel(const float* __restrict__ blocks,
                                const int* __restrict__ col_idx,
                                const unsigned char* __restrict__ mask,
                                const float* __restrict__ b,
                                const float* __restrict__ bias,
                                float* __restrict__ out, int mbpr, int bs_r,
                                int bs_c, int n, int fuse_bias_relu) {
  const int i = blockIdx.x;
  const int r = threadIdx.y;
  const long c = (long)blockIdx.y * blockDim.x + threadIdx.x;
  float acc = 0.f;  // plus_times zero
  for (int t = 0; t < mbpr; ++t) {
    const long slot = (long)i * mbpr + t;
    if (!mask[slot]) continue;  // ELL padding contributes the zero
    const float* w = blocks + (slot * bs_r + r) * bs_c;
    const float* y = b + (long)col_idx[slot] * bs_c * n + c;
#pragma unroll 4
    for (int k = 0; k < bs_c; ++k) acc = fmaf(w[k], y[(long)k * n], acc);
  }
  const long row = (long)i * bs_r + r;
  if (fuse_bias_relu) {
    const float v = acc + bias[row];
    acc = v < 0.f ? 0.f : v;  // keeps NaN, like jnp.maximum
  }
  out[row * n + c] = acc;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (nrb*bs_r, n) = A . b (+ epilogue); n must be a multiple of block_n
// and block_n * bs_r <= 1024 (the wrapper checks both).
extern "C" int bsr_spmm_f32(const float* blocks, const int* col_idx,
                            const unsigned char* mask, const float* b,
                            const float* bias, float* out, int nrb, int mbpr,
                            int bs_r, int bs_c, int n, int block_n,
                            int fuse_bias_relu, void* stream) {
  const dim3 grid(nrb, n / block_n);
  const dim3 block(block_n, bs_r);
  bsr_spmm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, col_idx, mask, b, bias, out, mbpr, bs_r, bs_c, n,
      fuse_bias_relu);
  return static_cast<int>(cudaGetLastError());
}
