// ELL-padded block-sparse (BSR) x dense product over any registry
// semiring, with the fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsr_spmm.py::_kernel
// (pallas_call at bsr_spmm.py:142):
//     C = A (+).(x) B,  optionally C = max(C + bias, 0),
// with A stored as (nrb, mbpr, bs_r, bs_c) blocks, a block-column table
// col_idx (nrb, mbpr) and a validity mask; B dense (k, n) row-major.
//
// Bound: at the serving shapes (bs = 16, n = 512, RadiX-net's stride-32
// layer: 2048 stored blocks) the product folds 2*bs*bs*n operations per
// stored block against bs*bs*4 weight bytes and a panel that stays in
// L2, so the least time is set by the operations. A kernel with one
// output per thread is held instead by its instruction stream (two loads
// per product) and re-reads every weight block once per narrow column
// tile; the design below removes both.
//
// Design: register-tiled semiring folds over staged slots, the body this
// kernel shares with bcsr_spmm.cu (semiring.cuh: SpmmTile, spmm_fold).
//  - One CTA per (block-row i, CN columns); the TPU's sequential t grid
//    axis becomes spmm_fold's loop over the block-row's slots, kept by
//    the mask. Masked (pad) slots are skipped before any copy is issued:
//    a pad slot holds col_idx 0 and a zero block, and 0 is not the
//    annihilator of seven of the eight semirings. A block-row with no
//    stored slot writes the epilogue of init.
//  - Two column widths: `Wide` (CN = 128) and `Narrow` (CN = 8) for
//    panels of at most 16 columns. The block size stays a runtime
//    parameter (bs_c a multiple of 4 for the 16-byte copies).
//  - __launch_bounds__(kMaxThreads, 1): with the minimum block count
//    ptxas keeps every accumulator in registers instead of trading them
//    for occupancy (without it, some instantiations spill).
// f32 on CUDA cores only (no tensor cores, no TF32). Python mirrors the
// tile constants in repro_torch/kernels/bsr_spmm.py (TILES), which must
// agree.
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

constexpr int kMaxThreads = 512;

template <int CN, int TM, int TN, int STAGES>
using Tile = semiring::SpmmTile<CN, TM, TN, STAGES>;
using Wide = Tile<128, 4, 4, 3>;  // tile id 0
using Narrow = Tile<8, 1, 1, 4>;  // tile id 1: n <= 16

template <class S, class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bsr_spmm_kernel(const float* __restrict__ blocks, const int* __restrict__ col_idx,
                    const unsigned char* __restrict__ mask, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ out, int mbpr, int bs_r,
                    int bs_c, int n, int fuse_bias_relu) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.x, col0 = blockIdx.y * T::CN;
  const long slot0 = (long)i * mbpr;  // the block-row's first slot
  semiring::Fold<S> acc[T::TM][T::TN];
  semiring::spmm_fold<S, T>(acc, smem, blocks, col_idx, mask, slot0, 0, mbpr, b, n, col0, bs_r,
                            bs_c);
  semiring::spmm_store<S, T>(acc, out, i, bs_r, n, col0, fuse_bias_relu != 0, bias);
}

template <class T, class S>
cudaError_t launch(const float* blocks, const int* col_idx, const unsigned char* mask,
                   const float* b, const float* bias, float* out, int nrb, int mbpr, int bs_r,
                   int bs_c, int n, int fuse_bias_relu, cudaStream_t stream) {
  auto kernel = bsr_spmm_kernel<S, T>;
  const int threads = T::rows(bs_r) * T::THREADS_N;
  const int smem = T::smem_bytes(bs_r, bs_c);
  if (threads > kMaxThreads || bs_c % 4 != 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nrb, (n + T::CN - 1) / T::CN);
  kernel<<<grid, threads, smem, stream>>>(blocks, col_idx, mask, b, bias, out, mbpr, bs_r,
                                          bs_c, n, fuse_bias_relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (nrb*bs_r, n) = A (+).(x) b (+ epilogue) under semiring id
// `semiring_id`, on tile `tile` (0 Wide, 1 Narrow); n and bs_c multiples
// of 4, every pointer 16-byte aligned, at most 512 threads and 227 KB of
// shared memory (the wrapper checks all of them).
extern "C" int bsr_spmm_f32(const float* blocks, const int* col_idx, const unsigned char* mask,
                            const float* b, const float* bias, float* out, int nrb, int mbpr,
                            int bs_r, int bs_c, int n, int tile, int fuse_bias_relu,
                            int semiring_id, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool known = (tile == 0 || tile == 1) && semiring::dispatch(semiring_id, [&](auto sr) {
    using S = decltype(sr);
    err = tile == 0 ? launch<Wide, S>(blocks, col_idx, mask, b, bias, out, nrb, mbpr, bs_r,
                                      bs_c, n, fuse_bias_relu, s)
                    : launch<Narrow, S>(blocks, col_idx, mask, b, bias, out, nrb, mbpr, bs_r,
                                        bs_c, n, fuse_bias_relu, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
