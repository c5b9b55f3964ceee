// The eight registry semirings as device functors, shared by the dense,
// ELL and block-CSR kernels — the CUDA counterpart of the shared inner
// step src/repro/kernels/semirings.py::vpu_tile_product/accumulate_tile.
//
// Each functor gives init() (the ⊕-identity, also the ⊗-annihilator: the
// accumulator's start and the value of a row with nothing stored) and
// step(acc, a, b) = acc ⊕ (a ⊗ b). The kernels fold one product at a time
// into a register, so the TPU's K_CHUNK slab has no counterpart here.
//
// Semantics follow jnp, which the reference kernels use:
//  - max/min propagate NaN (jnp.maximum/minimum); CUDA's fmaxf/fminf drop
//    it, so they are not used for ⊕ or ⊗;
//  - booleans live in {0, 1} ⊂ f32: ⊗ canonicalises both operands with
//    != 0 (NaN counts as true), ∨ is max on {0, 1}, and ⊻ flips the
//    accumulator exactly (no float sum);
//  - logaddexp(-inf, -inf) = -inf: a NaN difference (equal infinities or
//    a NaN operand) returns a + b, as jnp.logaddexp does. expf/log1pf are
//    the precise ones (the build uses no --use_fast_math).
//
// The ids match repro_torch/kernels/semirings.py SEMIRING_IDS; every C
// entry point switches on them through dispatch().
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace semiring {

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float land(float a, float b) {
  return (a != 0.f && b != 0.f) ? 1.f : 0.f;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float d = a - b;
  if (d != d) return a + b;
  return (a > b ? a : b) + log1pf(expf(-fabsf(d)));
}

struct PlusTimes {  // the FMA loop of the plus_times-only kernels
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return fmaf(a, b, acc);
  }
};
struct MaxPlus {
  static __device__ __forceinline__ float init() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return nan_max(acc, a + b);
  }
};
struct MinPlus {
  static __device__ __forceinline__ float init() { return CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return nan_min(acc, a + b);
  }
};
struct MaxMin {
  static __device__ __forceinline__ float init() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return nan_max(acc, nan_min(a, b));
  }
};
struct MinMax {
  static __device__ __forceinline__ float init() { return CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return nan_min(acc, nan_max(a, b));
  }
};
struct LorLand {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    const float p = land(a, b);
    return acc > p ? acc : p;
  }
};
struct XorAnd {
  static __device__ __forceinline__ float init() { return 0.f; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return acc != land(a, b) ? 1.f : 0.f;
  }
};
struct LogPlus {
  static __device__ __forceinline__ float init() { return -CUDART_INF_F; }
  static __device__ __forceinline__ float step(float acc, float a, float b) {
    return logaddexp(acc, a + b);
  }
};

// The fused epilogue max(v + bias, 0), keeping NaN as jnp.maximum does.
__device__ __forceinline__ float bias_relu(float acc, float bias) {
  const float v = acc + bias;
  return v < 0.f ? 0.f : v;
}

// Calls launch(S{}) with the functor of semiring `id`; false (and no
// launch) for an unknown id.
template <class Launch>
bool dispatch(int id, Launch&& launch) {
  switch (id) {
    case 0: launch(PlusTimes{}); break;
    case 1: launch(MaxPlus{}); break;
    case 2: launch(MinPlus{}); break;
    case 3: launch(MaxMin{}); break;
    case 4: launch(MinMax{}); break;
    case 5: launch(LorLand{}); break;
    case 6: launch(XorAnd{}); break;
    case 7: launch(LogPlus{}); break;
    default: return false;
  }
  return true;
}

}  // namespace semiring
