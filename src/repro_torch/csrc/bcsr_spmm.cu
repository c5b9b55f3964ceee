// Occupancy-exact block-CSR x dense product over any registry semiring,
// with the fused bias + ReLU epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bcsr_spmm.py::_kernel
// (pallas_call at bcsr_spmm.py:165). The TPU kernel runs one sequential
// grid over the stored blocks and flushes its accumulator whenever row_id
// changes; nothing carries over between CTAs on a GPU, so this kernel
// splits by rows instead.
//
// Design: one CTA per (block-row i, column tile j), walking the stored
// blocks row_ptr[i] .. row_ptr[i+1]; thread (c, r) owns one output
// element in a register, starting at the semiring's init (semiring.cuh).
// row_id is never read, so the tail slots that carry the last real row
// (sparse/bcsr.py:331-333 in the reference) cannot be mistaken for work;
// invalid slots are skipped all the same. A block-row with no stored
// block writes the epilogue of the init — +inf for min_plus, and
// max(init + bias, 0) when fused — the fill the reference wrapper splices
// in (kernels/ops.py:233-242), so no second pass is needed. The
// plus_times instantiation is the FMA loop of the plus_times-only version.
//
// Bound: as for bsr_spmm.cu, load instructions rather than HBM bytes or
// FMA rate at the serving shapes; work scales with the stored blocks.
#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

template <class S>
__global__ void bcsr_spmm_kernel(const float* __restrict__ values,
                                 const int* __restrict__ row_ptr,
                                 const int* __restrict__ col_idx,
                                 const unsigned char* __restrict__ valid,
                                 const float* __restrict__ b,
                                 const float* __restrict__ bias,
                                 float* __restrict__ out, int bs_r, int bs_c,
                                 int n, int fuse_bias_relu) {
  const int i = blockIdx.x;
  const int r = threadIdx.y;
  const long c = (long)blockIdx.y * blockDim.x + threadIdx.x;
  float acc = S::init();  // also the value of an empty row
  const int lo = row_ptr[i], hi = row_ptr[i + 1];
  for (int t = lo; t < hi; ++t) {
    if (!valid[t]) continue;
    const float* w = values + ((long)t * bs_r + r) * bs_c;
    const float* y = b + (long)col_idx[t] * bs_c * n + c;
#pragma unroll 4
    for (int k = 0; k < bs_c; ++k) acc = S::step(acc, w[k], y[(long)k * n]);
  }
  const long row = (long)i * bs_r + r;
  if (fuse_bias_relu) acc = semiring::bias_relu(acc, bias[row]);
  out[row * n + c] = acc;
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out (nrb*bs_r, n) = A (+).(x) b (+ epilogue) under semiring id
// `semiring_id`; n must be a multiple of block_n and block_n * bs_r <= 1024
// (the wrapper checks both).
extern "C" int bcsr_spmm_f32(const float* values, const int* row_ptr,
                             const int* col_idx, const unsigned char* valid,
                             const float* b, const float* bias, float* out,
                             int nrb, int bs_r, int bs_c, int n, int block_n,
                             int fuse_bias_relu, int semiring_id, void* stream) {
  const dim3 grid(nrb, n / block_n);
  const dim3 block(block_n, bs_r);
  const bool known = semiring::dispatch(semiring_id, [&](auto s) {
    bcsr_spmm_kernel<decltype(s)>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
            values, row_ptr, col_idx, valid, b, bias, out, bs_r, bs_c, n,
            fuse_bias_relu);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
