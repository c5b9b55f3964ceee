// The eight registry semirings as device functors, shared by the dense,
// ELL and block-CSR kernels — the CUDA counterpart of the shared inner
// step src/repro/kernels/semirings.py::vpu_tile_product/accumulate_tile.
//
// Each functor gives init() (the ⊕-identity, also the ⊗-annihilator: the
// accumulator's start and the value of a row with nothing stored) and
// step(acc, a, b) = acc ⊕ (a ⊗ b). The kernels fold one product at a time
// into each register accumulator (fold4 below folds a thread's micro-tile
// of them), so the TPU's K_CHUNK slab has no counterpart here.
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
#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------
// Staged, register-tiled folds: the pieces the dense and ELL kernels
// share. Operands reach shared memory through 16-byte cp.async copies;
// each thread then folds a TM x TN micro-tile of outputs held in
// registers.

// One 16-byte asynchronous copy global -> shared (4 floats or 8 bf16).
// `.cg` caches in L2 only: the CTA reuses the data from shared memory,
// not from L1.
template <class T>
__device__ __forceinline__ void cp_async16(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fill4(float* smem, float v) {
  *reinterpret_cast<float4*>(smem) = make_float4(v, v, v, v);
}

// TN consecutive floats of shared memory in the widest loads they allow.
template <int TN>
__device__ __forceinline__ void load_row(const float* p, float (&v)[TN]) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    }
  } else if constexpr (TN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = p[j];
  }
}

// TN consecutive bf16 values of a panel row, widened to f32 (exactly).
template <int TN>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[TN]) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p + j);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
      v[j] = lo.x, v[j + 1] = lo.y, v[j + 2] = hi.x, v[j + 3] = hi.y;
    }
  } else if constexpr (TN == 2) {
    const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// One output's accumulator in the register-tiled kernels: the semiring's
// own step, starting at init().
template <class S>
struct Fold {
  static constexpr bool kCompact = false;  // unroll the k-steps in full
  float v;
  __device__ __forceinline__ void init() { v = S::init(); }
  __device__ __forceinline__ void step(float a, float b) { v = S::step(v, a, b); }
  __device__ __forceinline__ float value() const { return v; }
};

// log_plus folded as a running log-sum-exp: the largest product x seen
// so far (m) and s = sum of exp(x - m), so a product costs one expf and
// the fold one logf at the end, instead of expf + log1pf per product.
// The same function as the chain of logaddexp steps up to rounding (the
// plain version's tolerance), with the same special values: an empty
// fold and logaddexp(-inf, -inf) give -inf; +inf absorbs every finite
// product; equal infinities (x == m) add exp(0) instead of exp(NaN);
// a NaN product makes s, and so the result, NaN.
template <>
struct Fold<LogPlus> {
  static constexpr bool kCompact = true;  // ~16 instructions a product: keep the loop small
  float m, s;
  __device__ __forceinline__ void init() { m = -CUDART_INF_F, s = 0.f; }
  __device__ __forceinline__ void step(float a, float b) {
    const float x = a + b;
    const bool up = x > m;
    const float e = expf(-fabsf(x - m));  // exp(min(x, m) - max(x, m)), no branch
    const float t = x == m ? 1.f : e;
    s = up ? fmaf(s, t, 1.f) : s + t;
    m = up ? x : m;
  }
  __device__ __forceinline__ float value() const { return m + logf(s); }
};

// Folds four k-steps into a thread's TM x TN accumulators:
//     acc[i][j] = acc[i][j] (+) a[i][kk] (x) b[kk][j],   kk = 0..3 in order.
// `a` points at the thread's first A row in shared memory, row-major
// with the four k values contiguous (one float4 per row: cp.async copies
// rows as they lie in global memory and cannot transpose them); its
// rows lie `a_stride` floats apart. `b` points at the thread's first
// column in the first of four B rows, which lie `ldb` elements apart; B
// is f32, or bf16 (a fused kernel's panel) widened on load.
template <class S, int TM, int TN, class B = float>
__device__ __forceinline__ void fold4(Fold<S> (&acc)[TM][TN], const float* a, int a_stride,
                                      const B* b, int ldb) {
  float4 av[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * a_stride);
  auto k_step = [&](int kk) {
    float bv[TN];
    load_row<TN>(b + kk * ldb, bv);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float ai = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j].step(ai, bv[j]);
    }
  };
  if constexpr (Fold<S>::kCompact) {
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) k_step(kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) k_step(kk);
  }
}

// Folds k (a multiple of 4) k-steps: fold4 over staged rows, unrolled in
// full where k is known at compile time, except for compact folds.
template <class S, int TM, int TN, class B = float>
__device__ __forceinline__ void fold(Fold<S> (&acc)[TM][TN], const float* a, int a_stride,
                                     const B* b, int ldb, int k) {
  if constexpr (Fold<S>::kCompact) {
#pragma unroll 1
    for (int kk = 0; kk < k; kk += 4) fold4<S, TM, TN>(acc, a + kk, a_stride, b + kk * ldb, ldb);
  } else {
#pragma unroll
    for (int kk = 0; kk < k; kk += 4) fold4<S, TM, TN>(acc, a + kk, a_stride, b + kk * ldb, ldb);
  }
}

// Writes a thread's row of TN outputs (the epilogue applied), skipping
// the columns at or past n; n and the first column are multiples of 4
// when TN is, so a float4 lies wholly inside or outside.
template <class S, int TN>
__device__ __forceinline__ void store_row(float* out_row, int col, int n,
                                          const Fold<S> (&acc)[TN], bool fuse, float bias) {
  float v[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) v[j] = fuse ? bias_relu(acc[j].value(), bias) : acc[j].value();
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TN; j += 4)
      if (col + j < n)
        *reinterpret_cast<float4*>(out_row + col + j) =
            make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (col + j < n) out_row[col + j] = v[j];
  }
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
