// Dense semiring product C = A (+).(x) B over any registry semiring, with
// the fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/semiring_matmul.py::
// _kernel (pallas_call at semiring_matmul.py:112). The TPU kernel walks a
// (m/bm, n/bn, k/bk) grid whose k axis runs in order, keeping the output
// tile in a VMEM accumulator; here each CTA owns one (bm x bn) output
// tile and the k axis is a loop inside it.
//
// Design: one CTA per output tile, thread (c, r) owning output
// (i*bm + r, j*bn + c) in a register that starts at the semiring's init
// (semiring.cuh). At each k-step the CTA stages the A (bm x bk) and
// B (bk x bn) tiles in shared memory (coalesced along k and n), syncs,
// and folds the bk products into its register. The wrapper pads k with
// the semiring's zero on both operands, so padded steps change nothing,
// and pads m and n to whole tiles. Tiles are at most 16 x 16 x 16, the
// wrapper's clamp. The plus_times instantiation is a plain FMA loop: no
// tensor cores, no library call.
//
// Bound: at the dense DNN's shapes (1024 x 1024 weights, 512-column
// panels) the product is operations-bound (2*m*k*n flops against
// (m*k + k*n + m*n) * 4 bytes); this kernel issues two shared-memory
// loads per FMA and reaches a fraction of the f32 rate. Register tiling
// (several outputs per thread) and wgmma/TMA are later work (PERF.md).
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

constexpr int kMaxTile = 16;

template <class S>
__global__ void semiring_matmul_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       const float* __restrict__ bias,
                                       float* __restrict__ out, int k, int n,
                                       int bk, int fuse_bias_relu) {
  __shared__ float a_tile[kMaxTile][kMaxTile];  // [r][kk]
  __shared__ float b_tile[kMaxTile][kMaxTile];  // [kk][c]
  const int bm = blockDim.y, bn = blockDim.x;
  const int r = threadIdx.y, c = threadIdx.x;
  const int tid = r * bn + c, threads = bm * bn;
  const long row0 = (long)blockIdx.x * bm;
  const long col0 = (long)blockIdx.y * bn;
  float acc = S::init();
  for (int k0 = 0; k0 < k; k0 += bk) {
    for (int e = tid; e < bm * bk; e += threads)
      a_tile[e / bk][e % bk] = a[(row0 + e / bk) * k + k0 + e % bk];
    for (int e = tid; e < bk * bn; e += threads)
      b_tile[e / bn][e % bn] = b[(long)(k0 + e / bn) * n + col0 + e % bn];
    __syncthreads();
    for (int kk = 0; kk < bk; ++kk)
      acc = S::step(acc, a_tile[r][kk], b_tile[kk][c]);
    __syncthreads();
  }
  const long row = row0 + r;
  if (fuse_bias_relu) acc = semiring::bias_relu(acc, bias[row]);
  out[row * n + col0 + c] = acc;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (m, n) = a (m, k) (+).(x) b (k, n) (+ epilogue) under semiring id
// `semiring_id`; m, n, k must be multiples of block_m, block_n, block_k, each
// at most 16 (the wrapper checks all of them).
extern "C" int semiring_matmul_f32(const float* a, const float* b,
                                   const float* bias, float* out, int m,
                                   int n, int k, int block_m, int block_n,
                                   int block_k, int fuse_bias_relu,
                                   int semiring_id, void* stream) {
  const dim3 grid(m / block_m, n / block_n);
  const dim3 block(block_n, block_m);
  const bool known = semiring::dispatch(semiring_id, [&](auto s) {
    semiring_matmul_kernel<decltype(s)>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            a, b, bias, out, k, n, block_k, fuse_bias_relu);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
