// Dense semiring product C = A (+).(x) B over any registry semiring, with
// the fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/semiring_matmul.py::
// _kernel (pallas_call at semiring_matmul.py:112). The TPU kernel walks a
// (m/bm, n/bn, k/bk) grid whose k axis runs in order, keeping the output
// tile in a VMEM accumulator; here each CTA owns one BM x BN output tile
// and the k axis is a loop inside it.
//
// Bound: at the dense DNN's shapes (1024 x 1024 weights, 512-column
// panels) the product is operations-bound (2*m*k*n operations against
// (m*k + k*n + m*n) * 4 bytes): 1.07 GFLOP is 0.016 ms at the f32
// CUDA-core peak. A kernel with one output per thread is held far from
// that by its instruction stream, not by HBM: two shared-memory loads
// per product. The design below loads each operand once per TM or TN
// products.
//
// Design: register-tiled semiring folds over staged tiles.
//  - Each thread keeps a TM x TN micro-tile of accumulators in registers
//    (rows tm + i*THREADS_M, columns tn*TN + j), each starting at the
//    semiring's init (semiring.cuh's Fold; log_plus as a running
//    log-sum-exp). A k-step costs one float4 load of A per four k and
//    row, and TN/4 float4 loads of B, for TM*TN folds.
//  - A and B reach shared memory through 16-byte cp.async copies into
//    STAGES stages: the copies of the next STAGES-1 k-tiles are in flight
//    while the current one is folded. A keeps its row-major layout (four
//    consecutive k per float4; cp.async cannot transpose), its rows
//    padded by 4 floats so the rows a warp reads fall in distinct banks.
//  - The CTA masks its own ragged edge: a chunk past m, n or k is filled
//    with the semiring zero (the ⊕-identity and ⊗-annihilator, so a
//    padded k-step changes nothing) and outputs past m or n are not
//    stored. The wrapper pads k and n to multiples of 8 (16-byte rows).
//  - Two tile shapes: `Wide` (64 x 64: the 1024 x 512 output is 128 CTAs
//    on the 132 SMs) and `Narrow` for panels of at most 16 columns, so
//    an 8-wide panel does not run a tile that is 7/8 empty.
//  - __launch_bounds__(THREADS, 1): with the minimum block count ptxas
//    keeps every accumulator in registers instead of trading them for
//    occupancy (without it, some instantiations spill).
// f32 on CUDA cores only (no tensor cores, no TF32): several contracts
// are bit-exact on integer operands. Python mirrors the tile constants
// in repro_torch/kernels/semiring_matmul.py (TILES), which must agree.
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, STAGES = STAGES_;
  static constexpr int THREADS_M = BM / TM, THREADS_N = BN / TN;
  static constexpr int THREADS = THREADS_M * THREADS_N;
  static constexpr int A_LD = BK + 4;  // padded row stride of a staged A tile
  static constexpr int A_STAGE = BM * A_LD, B_STAGE = BK * BN;  // floats
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 4;
  static_assert(BM % TM == 0 && BN % TN == 0 && BK % 4 == 0 && BN % 4 == 0, "tile");
};

using Wide = Tile<64, 64, 32, 4, 4, 2>;    // tile id 0
using Narrow = Tile<16, 8, 32, 1, 1, 3>;   // tile id 1: n <= 16

template <class S, class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    semiring_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ bias, float* __restrict__ out, int m,
                           int n, int k, int fuse_bias_relu) {
  extern __shared__ __align__(16) float smem[];
  float* const a_s = smem;                          // [STAGES][BM][A_LD]
  float* const b_s = smem + T::STAGES * T::A_STAGE;  // [STAGES][BK][BN]
  const int tid = threadIdx.x;
  const int tm = tid / T::THREADS_N, tn = tid % T::THREADS_N;
  const long row0 = (long)blockIdx.x * T::BM;
  const int col0 = blockIdx.y * T::BN;
  const float zero = S::init();
  const int k_tiles = (k + T::BK - 1) / T::BK;

  auto stage_in = [&](int stage, int kt) {
    const int k0 = kt * T::BK;
    float* as = a_s + stage * T::A_STAGE;
#pragma unroll
    for (int e = tid; e < T::BM * T::BK / 4; e += T::THREADS) {
      const int r = e / (T::BK / 4), c = e % (T::BK / 4) * 4;
      if (row0 + r < m && k0 + c < k)
        semiring::cp_async16(as + r * T::A_LD + c, a + (row0 + r) * k + k0 + c);
      else
        semiring::fill4(as + r * T::A_LD + c, zero);
    }
    float* bs = b_s + stage * T::B_STAGE;
#pragma unroll
    for (int e = tid; e < T::BK * T::BN / 4; e += T::THREADS) {
      const int r = e / (T::BN / 4), c = e % (T::BN / 4) * 4;
      if (k0 + r < k && col0 + c < n)
        semiring::cp_async16(bs + r * T::BN + c, b + (long)(k0 + r) * n + col0 + c);
      else
        semiring::fill4(bs + r * T::BN + c, zero);
    }
  };

  semiring::Fold<S> acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j].init();

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < k_tiles) stage_in(s, s);
    semiring::cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    semiring::cp_async_wait<T::STAGES - 2>();  // k-tile kt has landed
    __syncthreads();  // ... for every thread; and stage kt-1 is folded
    const int next = kt + T::STAGES - 1;
    if (next < k_tiles) stage_in(next % T::STAGES, next);
    semiring::cp_async_commit();
    const int stage = kt % T::STAGES;
    const float* as = a_s + stage * T::A_STAGE + tm * T::A_LD;
    const float* bs = b_s + stage * T::B_STAGE + tn * T::TN;
    semiring::fold<S, T::TM, T::TN>(acc, as, T::THREADS_M * T::A_LD, bs, T::BN, T::BK);
  }
  semiring::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const long row = row0 + tm + i * T::THREADS_M;
    if (row < m)
      semiring::store_row<S, T::TN>(out + row * n, col0 + tn * T::TN, n, acc[i],
                                 fuse_bias_relu != 0, fuse_bias_relu ? bias[row] : 0.f);
  }
}

template <class T, class S>
cudaError_t launch(const float* a, const float* b, const float* bias, float* out, int m, int n,
                   int k, int fuse_bias_relu, cudaStream_t stream) {
  auto kernel = semiring_matmul_kernel<S, T>;
  if (T::SMEM_BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
  kernel<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(a, b, bias, out, m, n, k,
                                                       fuse_bias_relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (m, n) = a (m, k) (+).(x) b (k, n) (+ epilogue) under semiring id
// `semiring_id`, on tile `tile` (0 Wide, 1 Narrow); n and k multiples of
// 4, every pointer 16-byte aligned (the wrapper checks all of them).
extern "C" int semiring_matmul_f32(const float* a, const float* b, const float* bias,
                                   float* out, int m, int n, int k, int tile,
                                   int fuse_bias_relu, int semiring_id, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool known = (tile == 0 || tile == 1) && semiring::dispatch(semiring_id, [&](auto sr) {
    using S = decltype(sr);
    err = tile == 0 ? launch<Wide, S>(a, b, bias, out, m, n, k, fuse_bias_relu, s)
                    : launch<Narrow, S>(a, b, bias, out, m, n, k, fuse_bias_relu, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
