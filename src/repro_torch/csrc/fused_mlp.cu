// Whole-stack fused sparse ReLU MLP forward, for Hopper (sm_90a):
//     Y[l+1] = max(W[l] . Y[l] + b[l], 0),  l = 0 .. L-1,  in ONE launch.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/fused_mlp.py:
//   * _kernel       (pallas_call at fused_mlp.py:214): the ping-pong
//     activation panel stays in on-chip memory (VMEM there, shared
//     memory here)                            -> fused_mlp_resident
//   * _tiled_kernel (pallas_call at fused_mlp.py:409): the panel lives in
//     off-chip scratch                        -> fused_mlp_tiled
//
// Weights are a homogeneous square ELL stack (L, nrb, mbpr, bs, bs) with
// col_idx/mask (L, nrb, mbpr); bias (L, m); y0 and out are (m, n) f32
// row-major. The panel is f32 or bf16 (rounded to it on entry and after
// every layer, as fused_mlp_plain does); accumulation is always f32 on
// CUDA cores. Only y0 is read and only Y[L] is written to `out`.
//
// Bound. The 1024 x 120 RadiX-net stack stores 130 560 blocks, 134 MB of
// weights (252 MB of ELL slots with the pads, which are never read); on a
// 512-column panel that is 34.2 GFLOP of stored work and ~0.06 ms at the
// card's f32 rate for the nonzero weights: the operations bound it, and
// what holds a kernel back is filling 132 SMs with enough independent
// folds and feeding each FMA without two loads. The 16384 x 120 stack
// stores 2.1 GB (4.0 GB of slots): 537 GFLOP of stored work, and a layer
// (at most 33.5 MB) fits the 50 MB L2 only if every CTA folds that layer
// at the same time.
//
// Design (one layer body for both kernels, `fold_tile`):
//  - A tile is the bs rows of a block-row x CN columns of one layer. Its
//    lanes walk the block-row's stored slots (masked slots are skipped
//    before any copy; the stride-1 RadiX-net layers store 2 of 32) and
//    bring each weight block by cp.async into a ring of kStages stages of
//    the tile's own, so warps never wait for one another; __syncwarp
//    orders the copies. Every stored entry is folded, zeros included
//    (0 * inf = NaN, as in the reference).
//  - Each lane keeps a TM x TN micro-tile in registers (rows ty + i*4,
//    columns tx*TN + j; 4 thread rows) and folds it with semiring.cuh's
//    fold4 (one float4 of weights per row and 4 k, one TN-wide panel load
//    per k). The epilogue is bias_relu (keeps NaN), rounded to the panel
//    type.
//  - fused_mlp_resident: a thread-block cluster of C CTAs per column
//    stripe of CN = 8 columns (columns never mix, so a stripe can be as
//    narrow as a tile; 8 rather than 16 doubles the stripes, which the
//    card needs: at n = 512 the 32 sixteen-column stripes would need
//    clusters of 4, and the H100 holds only 30 of those at this shared
//    memory). A warp folds two tiles, one a half-warp. Every CTA holds
//    a full replica of the stripe's (2, m, 8) ping-pong panel in shared
//    memory, so the gathered panel rows are read in place. CTA r of the
//    cluster folds block-rows r, r + C, ... of every layer and writes
//    each output row into every replica through distributed shared
//    memory; one cluster.sync() a layer orders the writes (the ping-pong
//    slots keep a layer's readers and the next layer's writers apart),
//    and the last one keeps every CTA alive until its peers are done.
//    The launcher chooses C so that stripes x C fills the SMs in one
//    wave of clusters, and this file refuses the launch
//    (cudaOccupancyMaxActiveClusters == 0) rather than shrink C.
//  - fused_mlp_tiled: a persistent cooperative grid (SMs x the blocks an
//    SM holds) over one (2, m, n) scratch in the panel type. A layer's
//    work items are (block-row, CN = 32 columns), one a warp; every warp
//    of the grid strides over them, so all CTAs fold the same layer and
//    its weights come from HBM about once; one grid.sync() between
//    layers. The gathered panel rows are staged by cp.async beside the
//    weight block. A first pass rounds y0 into slot 0.
//  - __launch_bounds__(threads, 1): ptxas keeps every accumulator in
//    registers (chip_smoke.py phase 1 fails on a spill).
// Tile constants are mirrored in repro_torch/kernels/fused_mlp.py
// (TILES, WARPS, STAGES), which tests/test_torch_fused_geometry.py holds
// to this file.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "semiring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStages = 3;  // cp.async stages of a warp's ring
constexpr int kWarps = 16;  // warps a CTA, block sizes up to 16
constexpr int kWideBlockWarps = 4;  // warps a CTA at block size 32
constexpr int kRows = 4;  // thread rows of a warp (x 8 thread columns)

template <int BS>
__host__ __device__ constexpr int warps_for() {
  return BS <= 16 ? kWarps : kWideBlockWarps;
}

template <int CN_, int TN_, bool STAGED_>
struct Tile {
  static constexpr int CN = CN_, TN = TN_;
  static constexpr bool STAGED = STAGED_;  // panel rows staged by cp.async
  static constexpr int THREADS_N = CN / TN;  // thread columns of a tile
  static constexpr int LANES = kRows * THREADS_N;  // lanes that fold one tile
  static constexpr int TPW = 32 / LANES;  // tiles a warp folds at once
  static_assert(CN % TN == 0 && 32 % LANES == 0, "a warp holds whole tiles");
};

using Resident = Tile<8, 2, false>;  // two 8-column tiles a warp, panel in shared memory
using Tiled = Tile<32, 4, true>;     // one 32-column tile a warp, panel rows staged

__device__ __forceinline__ float from_panel(float v) { return v; }
__device__ __forceinline__ float from_panel(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename P>
__device__ __forceinline__ P to_panel(float v);
template <>
__device__ __forceinline__ float to_panel<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_panel<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// One tile's share of dynamic shared memory: kStages weight blocks (rows
// padded by 4 floats against bank conflicts), then, for staged tiles,
// kStages x (BS rows x CN columns) of panel.
template <int BS, class T, class P>
struct Ring {
  static constexpr int W_LD = BS + 4;
  static constexpr int W_STAGE = BS * W_LD;  // floats
  static constexpr int B_STAGE = T::STAGED ? BS * T::CN : 0;  // panel elements
  static constexpr int BYTES = kStages * (W_STAGE * 4 + B_STAGE * (int)sizeof(P));
  static_assert(BYTES % 16 == 0, "16-byte stages");
};

template <int BS, class T>
struct Acc {
  static constexpr int TM = BS / kRows;
  semiring::Fold<semiring::PlusTimes> v[TM][T::TN];
};

// Folds one output tile of one layer into `acc`: the stored slots of the
// block-row at slot0 .. slot0 + mbpr against the panel `src` (row stride
// `ld`; `col0` is the tile's first column in it, `ncols` the columns it
// holds). The T::LANES lanes of a tile call it with their own `ring` and
// lane `tl`; the whole warp calls it together (its tiles' slot loops run
// in step, a tile that is not `active` or has run out of slots idles).
template <int BS, class T, class P>
__device__ __forceinline__ void fold_tile(Acc<BS, T>& acc, const float* __restrict__ blocks,
                                          const int* __restrict__ col_idx,
                                          const unsigned char* __restrict__ mask, long slot0,
                                          bool active, int mbpr, const P* src, int ld, int col0,
                                          int ncols, unsigned char* ring, int tl) {
  using R = Ring<BS, T, P>;
  constexpr int TM = Acc<BS, T>::TM;
  float* const w_s = reinterpret_cast<float*>(ring);
  P* const b_s = reinterpret_cast<P*>(ring + kStages * R::W_STAGE * 4);
  const int ty = tl / T::THREADS_N, tx = tl % T::THREADS_N;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc.v[i][j].init();

  auto next_stored = [&](int t) {
    while (t < mbpr && !mask[slot0 + t]) ++t;
    return t;
  };
  auto stage_in = [&](int stage, int t) {
    const long slot = slot0 + t;
    const float* w = blocks + slot * BS * BS;
    float* ws = w_s + stage * R::W_STAGE;
#pragma unroll
    for (int e = tl; e < BS * BS / 4; e += T::LANES) {
      const int r = e / (BS / 4), c = e % (BS / 4) * 4;
      semiring::cp_async16(ws + r * R::W_LD + c, w + r * BS + c);
    }
    if constexpr (T::STAGED) {
      constexpr int PER = 16 / sizeof(P);  // panel elements a copy
      constexpr int CHUNKS = T::CN / PER;  // copies a row
      const P* y = src + (long)col_idx[slot] * BS * ld + col0;
      P* bs = b_s + stage * R::B_STAGE;
#pragma unroll
      for (int e = tl; e < BS * CHUNKS; e += T::LANES) {
        const int r = e / CHUNKS, c = e % CHUNKS * PER;
        if (col0 + c < ncols)
          semiring::cp_async16(bs + r * T::CN + c, y + (long)r * ld + c);
        else  // past the panel's last column: never stored
          *reinterpret_cast<int4*>(bs + r * T::CN + c) = make_int4(0, 0, 0, 0);
      }
    }
  };

  int t = active ? next_stored(0) : mbpr;  // the next slot to fold
  int t_in = t;                            // the next slot to stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (t_in < mbpr) {
      stage_in(s, t_in);
      t_in = next_stored(t_in + 1);
    }
    semiring::cp_async_commit();
  }
  for (int stage = 0; __any_sync(0xffffffffu, t < mbpr); stage = (stage + 1) % kStages) {
    semiring::cp_async_wait<kStages - 2>();  // slot t has landed (this lane's copies)
    __syncwarp();  // ... and every lane's; the stage folded last is free
    if (t_in < mbpr) {
      stage_in((stage + kStages - 1) % kStages, t_in);
      t_in = next_stored(t_in + 1);
    }
    semiring::cp_async_commit();
    if (t < mbpr) {
      const float* ws = w_s + stage * R::W_STAGE + ty * R::W_LD;
      if constexpr (T::STAGED) {
        const P* bs = b_s + stage * R::B_STAGE + tx * T::TN;
        semiring::fold<semiring::PlusTimes, TM, T::TN>(acc.v, ws, kRows * R::W_LD, bs, T::CN,
                                                       BS);
      } else {
        const P* y = src + (long)col_idx[slot0 + t] * BS * ld + col0 + tx * T::TN;
        semiring::fold<semiring::PlusTimes, TM, T::TN>(acc.v, ws, kRows * R::W_LD, y, ld, BS);
      }
      t = next_stored(t + 1);
    }
  }
  semiring::cp_async_wait<0>();
  __syncwarp();  // every lane is done with the rings before the next tiles' copies
}

// TN consecutive values, in the widest stores they allow (the column is a
// multiple of TN and rows start on 16-byte boundaries).
template <int TN>
__device__ __forceinline__ void store(float* p, const float (&v)[TN]) {
  if constexpr (TN == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (TN == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
#pragma unroll
    for (int j = 0; j < TN; ++j) p[j] = v[j];
}
template <int TN>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[TN]) {
  if constexpr (TN % 2 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(p + j) = __floats2bfloat162_rn(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) p[j] = __float2bfloat16(v[j]);
  }
}

// Row `ri` of a lane's micro-tile after the epilogue, rounded to the
// panel type (and back to f32, as the panel holds it).
template <int BS, class T, class P>
__device__ __forceinline__ void epilogue_row(const Acc<BS, T>& acc, int ri, float bias,
                                             float (&v)[T::TN]) {
#pragma unroll
  for (int j = 0; j < T::TN; ++j)
    v[j] = from_panel(to_panel<P>(semiring::bias_relu(acc.v[ri][j].value(), bias)));
}

template <int BS, class P>
__global__ void __launch_bounds__(32 * warps_for<BS>(), 1)
    fused_resident_kernel(const float* __restrict__ blocks, const int* __restrict__ col_idx,
                          const unsigned char* __restrict__ mask, const float* __restrict__ y0,
                          const float* __restrict__ bias, float* __restrict__ out, int n_layers,
                          int nrb, int mbpr, int n) {
  using T = Resident;
  constexpr int W = warps_for<BS>(), CN = T::CN, TPW = T::TPW;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c_size = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int m = nrb * BS, size = m * CN;
  const int col0 = blockIdx.x / c_size * CN;  // this cluster's stripe
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / T::LANES, tl = lane % T::LANES;
  const int ty = tl / T::THREADS_N, tx = tl % T::THREADS_N;
  // No __restrict__: written by the peers and read again across the barrier.
  P* const panel = reinterpret_cast<P*>(smem);
  unsigned char* const ring =
      smem + 2 * size * sizeof(P) + (warp * TPW + half) * Ring<BS, T, P>::BYTES;

  for (int e = threadIdx.x; e < size; e += blockDim.x)
    panel[e] = to_panel<P>(y0[(long)(e / CN) * n + col0 + e % CN]);
  cluster.sync();  // every replica holds y0, and every CTA of the cluster runs

  Acc<BS, T> acc;
  for (int l = 0; l < n_layers; ++l) {
    const P* src = panel + (l & 1) * size;
    const int dst = ((l + 1) & 1) * size;
    const bool last = l == n_layers - 1;
    // tile g = warp * TPW + half of this CTA folds block-rows rank + C * (g + W * TPW * j)
    for (int i0 = rank + c_size * warp * TPW; i0 < nrb; i0 += c_size * W * TPW) {
      const int i = i0 + c_size * half;
      const bool active = i < nrb;
      fold_tile<BS, T, P>(acc, blocks, col_idx, mask, ((long)l * nrb + i) * mbpr, active, mbpr,
                          src, CN, 0, CN, ring, tl);
      if (!active) continue;
#pragma unroll
      for (int ri = 0; ri < Acc<BS, T>::TM; ++ri) {
        const int row = i * BS + ty + ri * kRows;
        float v[T::TN];
        epilogue_row<BS, T, P>(acc, ri, bias[(long)l * m + row], v);
        if (last) {
          store<T::TN>(out + (long)row * n + col0 + tx * T::TN, v);
        } else {
          for (int r = 0; r < c_size; ++r)
            store<T::TN>(cluster.map_shared_rank(panel, r) + dst + row * CN + tx * T::TN, v);
        }
      }
    }
    cluster.sync();  // this layer's rows are in every replica; the last keeps peers alive
  }
}

template <int BS, class P>
__global__ void __launch_bounds__(32 * warps_for<BS>(), 1)
    fused_tiled_kernel(const float* __restrict__ blocks, const int* __restrict__ col_idx,
                       const unsigned char* __restrict__ mask, const float* __restrict__ y0,
                       const float* __restrict__ bias, float* __restrict__ out, void* scratch,
                       int n_layers, int nrb, int mbpr, int n) {
  using T = Tiled;
  constexpr int W = warps_for<BS>(), CN = T::CN, TPW = T::TPW;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int m = nrb * BS;
  const long size = (long)m * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / T::LANES, tl = lane % T::LANES;
  const int ty = tl / T::THREADS_N, tx = tl % T::THREADS_N;
  P* const panel = reinterpret_cast<P*>(scratch);  // (2, m, n)
  unsigned char* const ring = smem + (warp * TPW + half) * Ring<BS, T, P>::BYTES;

  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < size;
       e += (long)gridDim.x * blockDim.x)
    panel[e] = to_panel<P>(y0[e]);
  grid.sync();

  const int n_ct = (n + CN - 1) / CN, items = nrb * n_ct;
  Acc<BS, T> acc;
  for (int l = 0; l < n_layers; ++l) {
    const P* src = panel + (l & 1) * size;
    P* dst = panel + ((l + 1) & 1) * size;
    const bool last = l == n_layers - 1;
    for (int it0 = (blockIdx.x * W + warp) * TPW; it0 < items; it0 += gridDim.x * W * TPW) {
      const int item = it0 + half;
      const bool active = item < items;
      const int i = active ? item / n_ct : 0, c0 = active ? item % n_ct * CN : 0;
      fold_tile<BS, T, P>(acc, blocks, col_idx, mask, ((long)l * nrb + i) * mbpr, active, mbpr,
                          src, n, c0, n, ring, tl);
      const int col = c0 + tx * T::TN;
      if (!active || col >= n) continue;  // n % 8 == 0: TN columns lie wholly in or out
#pragma unroll
      for (int ri = 0; ri < Acc<BS, T>::TM; ++ri) {
        const int row = i * BS + ty + ri * kRows;
        float v[T::TN];
        epilogue_row<BS, T, P>(acc, ri, bias[(long)l * m + row], v);
        if (last)
          store<T::TN>(out + (long)row * n + col, v);
        else
          store<T::TN>(dst + (long)row * n + col, v);
      }
    }
    if (!last) grid.sync();
  }
}

template <int BS, class T, class P>
constexpr int ring_bytes() {
  return warps_for<BS>() * T::TPW * Ring<BS, T, P>::BYTES;
}

struct Args {
  const float* blocks;
  const int* col_idx;
  const unsigned char* mask;
  const float* y0;
  const float* bias;
  float* out;
  void* scratch;
  int n_layers, nrb, mbpr, n;
};

// The resident launch of stripes x `cluster` CTAs, or (launch == false)
// the number of such clusters the card can hold at once into *result.
template <int BS, class P>
cudaError_t resident(const Args& a, int cluster, bool launch, int* result, cudaStream_t stream) {
  using T = Resident;
  auto kernel = fused_resident_kernel<BS, P>;
  const size_t smem = 2ull * a.nrb * BS * T::CN * sizeof(P) + ring_bytes<BS, T, P>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n / T::CN * cluster);
  cfg.blockDim = dim3(32 * warps_for<BS>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (!launch) {
    *result = clusters;
    return cudaSuccess;
  }
  if (clusters == 0) return cudaErrorInvalidConfiguration;  // never a smaller cluster
  return cudaLaunchKernelEx(&cfg, kernel, a.blocks, a.col_idx, a.mask, a.y0, a.bias, a.out,
                            a.n_layers, a.nrb, a.mbpr, a.n);
}

// The cooperative tiled launch of `grid` CTAs, or (launch == false) the
// CTAs one SM can hold into *result.
template <int BS, class P>
cudaError_t tiled(const Args& a, int grid, bool launch, int* result, cudaStream_t stream) {
  auto kernel = fused_tiled_kernel<BS, P>;
  const int threads = 32 * warps_for<BS>();
  const size_t smem = ring_bytes<BS, Tiled, P>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (!launch) {
    *result = per_sm;
    return cudaSuccess;
  }
  Args args = a;
  void* params[] = {&args.blocks, &args.col_idx, &args.mask, &args.y0, &args.bias, &args.out,
                    &args.scratch, &args.n_layers, &args.nrb, &args.mbpr, &args.n};
  // refused with cudaErrorCooperativeLaunchTooLarge past SMs x per_sm
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(threads), params, smem, stream);
}

// Calls fn(std::integral_constant<int, BS>) for a supported block size.
template <class Fn>
cudaError_t by_block_size(int bs, Fn&& fn) {
  switch (bs) {
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const Args& a, int tiled_kernel, int bs, int panel_bf16, int geometry,
                bool launch, int* result, cudaStream_t stream) {
  return by_block_size(bs, [&](auto bs_c) -> cudaError_t {
    constexpr int BS = decltype(bs_c)::value;
    if (tiled_kernel)
      return panel_bf16 ? tiled<BS, __nv_bfloat16>(a, geometry, launch, result, stream)
                        : tiled<BS, float>(a, geometry, launch, result, stream);
    return panel_bf16 ? resident<BS, __nv_bfloat16>(a, geometry, launch, result, stream)
                      : resident<BS, float>(a, geometry, launch, result, stream);
  });
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Into *result: the clusters of `cluster` resident CTAs the card holds at
// once (tiled == 0), or the tiled CTAs one SM holds (tiled == 1), for an
// (nrb * bs)-neuron stack at this block size and panel type.
extern "C" int fused_mlp_occupancy(int tiled_kernel, int nrb, int bs, int panel_bf16,
                                   int cluster, int* result) {
  Args a = {};
  a.nrb = nrb;
  a.n = Resident::CN;  // one stripe
  *result = 0;
  return static_cast<int>(
      run(a, tiled_kernel, bs, panel_bf16, cluster, false, result, nullptr));
}

// Panel in shared memory: (n / 8) clusters of `cluster` CTAs, each CTA
// 2 * m * 8 panel elements plus its warps' rings; n % 8 == 0.
extern "C" int fused_mlp_resident(const float* blocks, const int* col_idx,
                                  const unsigned char* mask, const float* y0, const float* bias,
                                  float* out, int n_layers, int nrb, int mbpr, int bs, int n,
                                  int panel_bf16, int cluster, void* stream) {
  const Args a = {blocks, col_idx, mask, y0, bias, out, nullptr, n_layers, nrb, mbpr, n};
  int unused = 0;
  const cudaError_t err =
      run(a, 0, bs, panel_bf16, cluster, true, &unused, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // read, and so cleared, either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Panel in `scratch`: (2, m, n) elements of the panel type, allocated by
// the caller; a cooperative grid of `grid` CTAs; n % 8 == 0.
extern "C" int fused_mlp_tiled(const float* blocks, const int* col_idx, const unsigned char* mask,
                               const float* y0, const float* bias, float* out, void* scratch,
                               int n_layers, int nrb, int mbpr, int bs, int n, int panel_bf16,
                               int grid, void* stream) {
  const Args a = {blocks, col_idx, mask, y0, bias, out, scratch, n_layers, nrb, mbpr, n};
  int unused = 0;
  const cudaError_t err =
      run(a, 1, bs, panel_bf16, grid, true, &unused, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // read, and so cleared, either way
  return static_cast<int>(err != cudaSuccess ? err : last);
}
