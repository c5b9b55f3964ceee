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
// Design: register-tiled semiring folds over staged slots.
//  - One CTA per (block-row i, CN columns); the TPU's sequential t grid
//    axis becomes a loop over the block-row's stored slots. Masked (pad)
//    slots are skipped before any copy is issued: a pad slot holds
//    col_idx 0 and a zero block, and 0 is not the annihilator of seven of
//    the eight semirings. A block-row with no stored slot writes the
//    epilogue of init.
//  - For each stored slot, cp.async brings the bs_r x bs_c block and the
//    bs_c gathered B rows x CN columns into one of STAGES shared-memory
//    stages; the copies of the next stored slots are in flight while the
//    current one is folded. Each weight block is read once per CTA.
//  - Each thread keeps a TM x TN micro-tile of accumulators in registers
//    (block rows ty + i*RT, columns tx*TN + j, RT = ceil(bs_r / TM)),
//    starting at the semiring's init (semiring.cuh's Fold; log_plus as a
//    running log-sum-exp). In the wide tile a warp shares one ty, so its
//    block reads are broadcasts and its panel reads contiguous float4s.
//    Block rows are staged row-major, padded by 4 floats against bank
//    conflicts; rows from bs_r up to RT*TM hold no data and are not
//    stored.
//  - Every stored entry is folded, zeros included, as the TPU kernel
//    folds them: under plus_times 0 * inf = NaN, which the engine's NaN
//    quarantine relies on.
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

template <int CN_, int TM_, int TN_, int STAGES_>
struct Tile {
  static constexpr int CN = CN_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int THREADS_N = CN / TN;
  static_assert(CN % TN == 0 && CN % 4 == 0, "tile");
  __host__ __device__ static int rows(int bs_r) { return (bs_r + TM - 1) / TM; }  // RT
  __host__ __device__ static int w_stage(int bs_r, int bs_c) {
    return rows(bs_r) * TM * (bs_c + 4);
  }
  __host__ __device__ static int b_stage(int bs_c) { return bs_c * CN; }
  static int smem_bytes(int bs_r, int bs_c) {
    return STAGES * (w_stage(bs_r, bs_c) + b_stage(bs_c)) * 4;
  }
};

using Wide = Tile<128, 4, 4, 3>;  // tile id 0
using Narrow = Tile<8, 1, 1, 4>;  // tile id 1: n <= 16

template <class S, class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bsr_spmm_kernel(const float* __restrict__ blocks, const int* __restrict__ col_idx,
                    const unsigned char* __restrict__ mask, const float* __restrict__ b,
                    const float* __restrict__ bias, float* __restrict__ out, int mbpr, int bs_r,
                    int bs_c, int n, int fuse_bias_relu) {
  extern __shared__ __align__(16) float smem[];
  const int rt = T::rows(bs_r), w_ld = bs_c + 4;
  const int w_stage = T::w_stage(bs_r, bs_c), b_stage = T::b_stage(bs_c);
  float* const w_s = smem;                      // [STAGES][RT*TM][bs_c + 4]
  float* const b_s = smem + T::STAGES * w_stage;  // [STAGES][bs_c][CN]
  const int tid = threadIdx.x, threads = blockDim.x;
  const int ty = tid / T::THREADS_N, tx = tid % T::THREADS_N;
  const int i = blockIdx.x;
  const int col0 = blockIdx.y * T::CN;
  const long slot0 = (long)i * mbpr;
  const float zero = S::init();

  // The first stored slot at or after t (mbpr when none is left).
  auto next_stored = [&](int t) {
    while (t < mbpr && !mask[slot0 + t]) ++t;
    return t;
  };
  auto stage_in = [&](int stage, int t) {
    const long slot = slot0 + t;
    const float* w = blocks + slot * bs_r * bs_c;
    float* ws = w_s + stage * w_stage;
    const int w_chunks = bs_c / 4;
    for (int e = tid; e < bs_r * w_chunks; e += threads) {
      const int r = e / w_chunks, c = (e - r * w_chunks) * 4;
      semiring::cp_async16(ws + r * w_ld + c, w + r * bs_c + c);
    }
    const float* y = b + (long)col_idx[slot] * bs_c * n + col0;
    float* bs = b_s + stage * b_stage;
    for (int e = tid; e < bs_c * (T::CN / 4); e += threads) {
      const int r = e / (T::CN / 4), c = e % (T::CN / 4) * 4;
      if (col0 + c < n)
        semiring::cp_async16(bs + r * T::CN + c, y + (long)r * n + c);
      else
        semiring::fill4(bs + r * T::CN + c, zero);
    }
  };

  semiring::Fold<S> acc[T::TM][T::TN];
#pragma unroll
  for (int r = 0; r < T::TM; ++r)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[r][j].init();

  int t_in = next_stored(0);  // the next stored slot to stage
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (t_in < mbpr) {
      stage_in(s, t_in);
      t_in = next_stored(t_in + 1);
    }
    semiring::cp_async_commit();
  }
  int stage = 0;
  for (int t = next_stored(0); t < mbpr; t = next_stored(t + 1)) {
    semiring::cp_async_wait<T::STAGES - 2>();  // slot t has landed
    __syncthreads();  // ... for every thread; and the previous stage is folded
    if (t_in < mbpr) {
      stage_in((stage + T::STAGES - 1) % T::STAGES, t_in);
      t_in = next_stored(t_in + 1);
    }
    semiring::cp_async_commit();
    const float* ws = w_s + stage * w_stage + ty * w_ld;
    const float* bs = b_s + stage * b_stage + tx * T::TN;
    semiring::fold<S, T::TM, T::TN>(acc, ws, rt * w_ld, bs, T::CN, bs_c);
    stage = (stage + 1) % T::STAGES;
  }
  semiring::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < T::TM; ++r) {
    const int br = ty + r * rt;
    if (br < bs_r) {
      const long row = (long)i * bs_r + br;
      semiring::store_row<S, T::TN>(out + row * n, col0 + tx * T::TN, n, acc[r],
                                 fuse_bias_relu != 0, fuse_bias_relu ? bias[row] : 0.f);
    }
  }
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
