// Occupancy-exact block-CSR x dense product over any registry semiring,
// with the fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcsr_spmm.py::_kernel
// (pallas_call at bcsr_spmm.py:165). The TPU kernel runs one sequential
// grid over the stored blocks and flushes its accumulator whenever row_id
// changes, so its work follows the stored blocks, not the rows. Blocks of
// a GPU grid run in parallel and carry nothing over; one CTA per
// block-row would leave the card waiting on the longest row of a skewed
// graph. This kernel walks a piece table instead.
//
// Bound: as for bsr_spmm.cu, the operations at the serving shapes (2 *
// bs_r * bs_c * n a stored block against its bs_r * bs_c * 4 bytes); the
// work follows the stored blocks.
//
// Design:
//  - The launcher cuts every block-row into pieces (repro_torch/kernels/
//    bcsr_spmm.py, piece_table): a row of at most kPieceSlots stored slots
//    is one piece, an empty row a piece of no slots, a longer row
//    ceil(len / kPieceSlots) pieces of near-equal length. The cut rows'
//    pieces come first in the table, then the whole rows longest first,
//    so the longest pieces start first.
//  - One CTA per (piece, CN columns) folds the piece's slots with the
//    staged, register-tiled body it shares with bsr_spmm.cu (semiring.cuh:
//    SpmmTile, spmm_fold). It walks the row_ptr range of its piece, kept
//    by `valid`; row_id is never read, so the tail slots that carry the
//    last real row (sparse/bcsr.py:331-333 in the reference) cannot be
//    mistaken for work.
//  - A whole row's CTA writes its tile with the epilogue. An empty row
//    writes the epilogue of init (+inf for min_plus, max(init + bias, 0)
//    when fused), the fill the reference wrapper splices in
//    (kernels/ops.py:233-242).
//  - A cut row's CTA writes its partial tile to the workspace, fences,
//    and counts itself in the (cut row, column tile)'s counter; the CTA
//    that counts last folds the row's partials in piece order with the
//    semiring's binary add, applies the epilogue and stores. Piece order,
//    not finishing order, keeps the result the same from run to run.
//  - Two column widths, `Wide` (CN = 128) and `Narrow` (CN = 8) for
//    panels of at most 16 columns, under __launch_bounds__(kMaxThreads,
//    1), as in bsr_spmm.cu.
// f32 on CUDA cores only (no tensor cores, no TF32). Python mirrors
// kPieceSlots, kMaxThreads and the tiles in repro_torch/kernels/
// bcsr_spmm.py (PIECE_SLOTS, MAX_THREADS, TILES), which must agree.
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

constexpr int kMaxThreads = 512;
// S, the most stored slots a piece folds: at least 32, so that no
// RadiX-net row (2 or 32 stored blocks) is ever cut. The longest piece
// sets the launch's time on a skewed graph (tools/torch_tile_sweep.py on
// an H100: 32 beats 64 by 1.4x and 128 by 2.2x at 256 columns), so S is
// the least value allowed.
constexpr int kPieceSlots = 32;
static_assert(kPieceSlots >= 32, "RadiX-net rows stay whole");

template <int CN, int TM, int TN, int STAGES>
using Tile = semiring::SpmmTile<CN, TM, TN, STAGES>;
using Wide = Tile<128, 4, 4, 3>;  // tile id 0
using Narrow = Tile<8, 1, 1, 4>;  // tile id 1: n <= 16

// TN consecutive floats of a partial tile in global memory, read from L2
// (another CTA wrote them).
template <int TN>
__device__ __forceinline__ void load_partial(const float* p, float (&v)[TN]) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = __ldcg(p + j);
  }
}

template <int TN>
__device__ __forceinline__ void store_partial(float* p, const float (&v)[TN]) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) p[j] = v[j];
  }
}

// pieces: (n_pieces, 4) int32 {block-row, first slot, end slot, cut row
// or -1}; cuts: (n_cut_rows, 2) int32 {first piece, pieces}. partials:
// [cut piece][column tile][bs_r][CN] floats, counters: [cut row][column
// tile], zero at launch; both unused (and may be null) without a cut row.
template <class S, class T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    bcsr_spmm_kernel(const float* __restrict__ values, const int* __restrict__ col_idx,
                     const unsigned char* __restrict__ valid, const int4* __restrict__ pieces,
                     const int2* __restrict__ cuts, const float* __restrict__ b,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ partials, unsigned* __restrict__ counters, int bs_r,
                     int bs_c, int n, int fuse_bias_relu) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int4 piece = pieces[blockIdx.x];  // row, lo, hi, cut
  const int col0 = blockIdx.y * T::CN;
  const bool fuse = fuse_bias_relu != 0;
  semiring::Fold<S> acc[T::TM][T::TN];
  semiring::spmm_fold<S, T>(acc, smem, values, col_idx, valid, 0, piece.y, piece.z, b, n, col0,
                            bs_r, bs_c);
  if (piece.w < 0) {  // a whole row
    semiring::spmm_store<S, T>(acc, out, piece.x, bs_r, n, col0, fuse, bias);
    return;
  }

  const int rt = T::rows(bs_r), tiles = gridDim.y;
  const int ty = threadIdx.x / T::THREADS_N, tx = threadIdx.x % T::THREADS_N;
  const long tile_floats = (long)bs_r * T::CN;
  auto partial = [&](int p, int br) {
    return partials + ((long)p * tiles + blockIdx.y) * tile_floats + br * T::CN + tx * T::TN;
  };
#pragma unroll
  for (int r = 0; r < T::TM; ++r) {
    const int br = ty + r * rt;
    if (br < bs_r) {
      float v[T::TN];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) v[j] = acc[r][j].value();
      store_partial<T::TN>(partial(blockIdx.x, br), v);
    }
  }
  __threadfence();  // this CTA's partial is visible before it is counted
  __syncthreads();
  const int2 cut = cuts[piece.w];  // first piece, pieces
  if (threadIdx.x == 0)
    last = atomicAdd(counters + (long)piece.w * tiles + blockIdx.y, 1u) == unsigned(cut.y - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int r = 0; r < T::TM; ++r) {
    const int br = ty + r * rt;
    if (br < bs_r) {
      float v[T::TN], w[T::TN];
      load_partial<T::TN>(partial(cut.x, br), v);
      for (int k = 1; k < cut.y; ++k) {
        load_partial<T::TN>(partial(cut.x + k, br), w);
#pragma unroll
        for (int j = 0; j < T::TN; ++j) v[j] = S::add(v[j], w[j]);
      }
      const long row = (long)piece.x * bs_r + br;
      semiring::store_values<T::TN>(out + row * n, col0 + tx * T::TN, n, v, fuse,
                                    fuse ? bias[row] : 0.f);
    }
  }
}

template <class T, class S>
cudaError_t launch(const float* values, const int* col_idx, const unsigned char* valid,
                   const int* pieces, const int* cuts, int n_pieces, const float* b,
                   const float* bias, float* out, float* partials, unsigned* counters, int bs_r,
                   int bs_c, int n, int fuse_bias_relu, cudaStream_t stream) {
  auto kernel = bcsr_spmm_kernel<S, T>;
  const int threads = T::rows(bs_r) * T::THREADS_N;
  const int smem = T::smem_bytes(bs_r, bs_c);
  if (threads > kMaxThreads || bs_c % 4 != 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_pieces, (n + T::CN - 1) / T::CN);
  kernel<<<grid, threads, smem, stream>>>(
      values, col_idx, valid, reinterpret_cast<const int4*>(pieces),
      reinterpret_cast<const int2*>(cuts), b, bias, out, partials, counters, bs_r, bs_c, n,
      fuse_bias_relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (nrb*bs_r, n) = A (+).(x) b (+ epilogue) under semiring id
// `semiring_id`, on tile `tile` (0 Wide, 1 Narrow), over the piece table
// (pieces, cuts) of A's row_ptr; n and bs_c multiples of 4, every pointer
// 16-byte aligned, at most 512 threads and 227 KB of shared memory (the
// wrapper checks all of them).
extern "C" int bcsr_spmm_f32(const float* values, const int* col_idx, const unsigned char* valid,
                             const int* pieces, const int* cuts, int n_pieces, const float* b,
                             const float* bias, float* out, float* partials, unsigned* counters,
                             int bs_r, int bs_c, int n, int tile, int fuse_bias_relu,
                             int semiring_id, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  const bool known = (tile == 0 || tile == 1) && semiring::dispatch(semiring_id, [&](auto sr) {
    using S = decltype(sr);
    err = tile == 0 ? launch<Wide, S>(values, col_idx, valid, pieces, cuts, n_pieces, b, bias,
                                      out, partials, counters, bs_r, bs_c, n, fuse_bias_relu, s)
                    : launch<Narrow, S>(values, col_idx, valid, pieces, cuts, n_pieces, b,
                                        bias, out, partials, counters, bs_r, bs_c, n,
                                        fuse_bias_relu, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
