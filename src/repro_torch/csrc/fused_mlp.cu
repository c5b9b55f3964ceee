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
// row-major. The panel is f32 or bf16; accumulation is always f32.
//
// Design: one CTA per column stripe j of width bn. Columns never mix,
// so stripes are independent and need no grid-wide synchronisation.
// The CTA stages its y0 stripe into panel slot 0, then for each layer
// every thread computes output elements (r, c) of the stripe — walking
// the stored blocks of row r's block-row and reading the gathered input
// rows from the source panel slot — applies the epilogue in a register
// and writes the destination slot; __syncthreads() separates layers and
// makes the writes (shared or global) visible to the whole CTA. Only
// y0 is read and only Y[L] is written to the output.
//   * resident: the (2, m, bn) panel is dynamic shared memory, so the
//     stack is eligible while 2*m*bn*sizeof(panel) <= 227 KB.
//   * tiled: the panel is a (2, m, bn) slice of a global scratch buffer
//     per stripe (the TPU version shares one scratch and therefore runs
//     its stripes in sequence; here they run in parallel).
//
// Bound: every stripe re-reads the whole weight stack (n/bn times in
// all; 251 MB per stripe for the 1024 x 120 challenge stack at f32),
// mostly from L2. With one CTA per stripe, a 512-column panel at bn = 16
// fills 32 of the 132 SMs. Both are recorded in PERF.md as the gap to
// the bound; tensor cores (wgmma) and stripe splitting are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float from_panel(float v) { return v; }
__device__ __forceinline__ float from_panel(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// All L layers of one column stripe; `panel` is this stripe's (2, m, bn)
// ping-pong buffer, in shared or global memory. No __restrict__ on it:
// it is written and read again across the layer barrier.
template <typename P>
__device__ void stripe_forward(const float* __restrict__ blocks,
                               const int* __restrict__ col_idx,
                               const unsigned char* __restrict__ mask,
                               const float* __restrict__ y0,
                               const float* __restrict__ bias,
                               float* __restrict__ out, P* panel,
                               int n_layers, int nrb, int mbpr, int bs, int n,
                               int bn) {
  // The stripe (m * bn elements) indexes in int; global offsets in long.
  const int m = nrb * bs;
  const int size = m * bn;
  const long col0 = (long)blockIdx.x * bn;
  for (int e = threadIdx.x; e < size; e += blockDim.x) {
    const int r = e / bn, c = e % bn;
    panel[e] = to_panel<P>(y0[(long)r * n + col0 + c]);
  }
  __syncthreads();
  for (int l = 0; l < n_layers; ++l) {
    const P* src = panel + (l & 1) * size;
    P* dst = panel + ((l + 1) & 1) * size;
    const long layer_slot = (long)l * nrb * mbpr;
    for (int e = threadIdx.x; e < size; e += blockDim.x) {
      const int r = e / bn, c = e % bn;
      const int i = r / bs, rl = r % bs;
      const long slot0 = layer_slot + (long)i * mbpr;
      float acc = 0.f;
      for (int t = 0; t < mbpr; ++t) {
        const long slot = slot0 + t;
        if (!mask[slot]) continue;  // ELL padding
        const float* w = blocks + (slot * bs + rl) * bs;
        const P* y = src + (long)col_idx[slot] * bs * bn + c;
#pragma unroll 4
        for (int k = 0; k < bs; ++k) acc = fmaf(w[k], from_panel(y[k * bn]), acc);
      }
      float v = acc + bias[(long)l * m + r];
      v = v < 0.f ? 0.f : v;  // keeps NaN, like jnp.maximum
      const P pv = to_panel<P>(v);
      dst[e] = pv;
      if (l == n_layers - 1) out[(long)r * n + col0 + c] = from_panel(pv);
    }
    __syncthreads();
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    fused_resident_kernel(const float* __restrict__ blocks,
                          const int* __restrict__ col_idx,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ y0,
                          const float* __restrict__ bias,
                          float* __restrict__ out, void* /*scratch*/,
                          int n_layers, int nrb, int mbpr, int bs, int n,
                          int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  stripe_forward<P>(blocks, col_idx, mask, y0, bias, out,
                    reinterpret_cast<P*>(smem), n_layers, nrb, mbpr, bs, n,
                    bn);
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
    fused_tiled_kernel(const float* __restrict__ blocks,
                       const int* __restrict__ col_idx,
                       const unsigned char* __restrict__ mask,
                       const float* __restrict__ y0,
                       const float* __restrict__ bias,
                       float* __restrict__ out, void* scratch, int n_layers,
                       int nrb, int mbpr, int bs, int n, int bn) {
  const long stripe = 2L * nrb * bs * bn;
  P* panel = reinterpret_cast<P*>(scratch) + blockIdx.x * stripe;
  stripe_forward<P>(blocks, col_idx, mask, y0, bias, out, panel, n_layers,
                    nrb, mbpr, bs, n, bn);
}

using Kernel = void (*)(const float*, const int*, const unsigned char*,
                        const float*, const float*, float*, void*, int, int,
                        int, int, int, int);

int launch(Kernel kernel, size_t smem, const float* blocks,
           const int* col_idx, const unsigned char* mask, const float* y0,
           const float* bias, float* out, void* scratch, int n_layers,
           int nrb, int mbpr, int bs, int n, int block_n, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n / block_n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      blocks, col_idx, mask, y0, bias, out, scratch, n_layers, nrb, mbpr, bs,
      n, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Panel in shared memory: 2 * m * block_n * (panel_bf16 ? 2 : 4) bytes.
extern "C" int fused_mlp_resident(const float* blocks, const int* col_idx,
                                  const unsigned char* mask, const float* y0,
                                  const float* bias, float* out, int n_layers,
                                  int nrb, int mbpr, int bs, int n,
                                  int block_n, int panel_bf16, void* stream) {
  const size_t elems = 2ull * nrb * bs * block_n;
  if (panel_bf16)
    return launch(fused_resident_kernel<__nv_bfloat16>,
                  elems * sizeof(__nv_bfloat16), blocks, col_idx, mask, y0,
                  bias, out, nullptr, n_layers, nrb, mbpr, bs, n, block_n,
                  stream);
  return launch(fused_resident_kernel<float>, elems * sizeof(float), blocks,
                col_idx, mask, y0, bias, out, nullptr, n_layers, nrb, mbpr,
                bs, n, block_n, stream);
}

// Panel in `scratch`: (n / block_n) stripes of (2, m, block_n) elements
// of the panel type, allocated by the caller.
extern "C" int fused_mlp_tiled(const float* blocks, const int* col_idx,
                               const unsigned char* mask, const float* y0,
                               const float* bias, float* out, void* scratch,
                               int n_layers, int nrb, int mbpr, int bs, int n,
                               int block_n, int panel_bf16, void* stream) {
  if (panel_bf16)
    return launch(fused_tiled_kernel<__nv_bfloat16>, 0, blocks, col_idx, mask,
                  y0, bias, out, scratch, n_layers, nrb, mbpr, bs, n, block_n,
                  stream);
  return launch(fused_tiled_kernel<float>, 0, blocks, col_idx, mask, y0, bias,
                out, scratch, n_layers, nrb, mbpr, bs, n, block_n, stream);
}
