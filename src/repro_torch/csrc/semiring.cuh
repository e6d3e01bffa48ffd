// Semiring functors shared by the three sliced-ELL kernels.
//
// The ids match `repro_torch.kernels.common.SEMIRING_IDS`.  Every ⊕ and ⊗
// goes through an explicitly rounded intrinsic (__fadd_rn / __fmul_rn),
// which nvcc never contracts into an FMA, so `partial ⊕ (a ⊗ b)` rounds
// twice exactly like the reference's separate jnp ops and like the plain
// PyTorch versions.  min/max follow jnp.minimum/maximum (IEEE 754-2019
// minimum/maximum), as the plain versions' `kernels.common.minimum` /
// `maximum` do: NaN propagates, and -0.0 orders below +0.0, so a tie of
// signed zeros gives -0.0 under min and +0.0 under max whichever operand
// comes first.  Both are then associative and commutative up to the NaN
// payload.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace graphhp {

enum SemiringId : int {
  kAddMul = 0,
  kMinAdd = 1,
  kMaxAdd = 2,
  kMinMul = 3,
  kMaxMin = 4,
};

// Equal non-NaN operands differ at most in the sign of a zero: OR-ing the
// bits keeps -0.0 (min), AND-ing them keeps +0.0 (max).
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a != b) return (b < a) ? b : a;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a != b) return (a < b) ? b : a;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

// combine = ⊕, times = ⊗, ident = ⊕-identity, improves(new, old) = strict
// improvement under ⊕ (monotone semirings only).
template <int S> struct Semiring;

template <> struct Semiring<kAddMul> {
  static __device__ __forceinline__ float combine(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float times(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float ident() { return 0.0f; }
};

template <> struct Semiring<kMinAdd> {
  static __device__ __forceinline__ float combine(float a, float b) { return nan_min(a, b); }
  static __device__ __forceinline__ float times(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float ident() { return INFINITY; }
  static __device__ __forceinline__ bool improves(float n, float o) { return n < o; }
};

template <> struct Semiring<kMaxAdd> {
  static __device__ __forceinline__ float combine(float a, float b) { return nan_max(a, b); }
  static __device__ __forceinline__ float times(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float ident() { return -INFINITY; }
  static __device__ __forceinline__ bool improves(float n, float o) { return n > o; }
};

template <> struct Semiring<kMinMul> {
  static __device__ __forceinline__ float combine(float a, float b) { return nan_min(a, b); }
  static __device__ __forceinline__ float times(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float ident() { return INFINITY; }
  static __device__ __forceinline__ bool improves(float n, float o) { return n < o; }
};

template <> struct Semiring<kMaxMin> {
  static __device__ __forceinline__ float combine(float a, float b) { return nan_max(a, b); }
  static __device__ __forceinline__ float times(float a, float b) { return nan_min(a, b); }
  static __device__ __forceinline__ float ident() { return -INFINITY; }
  static __device__ __forceinline__ bool improves(float n, float o) { return n > o; }
};

// Threads a block of the one-thread-per-(row, lane) kernels.
constexpr int kThreads = 256;

inline unsigned int grid_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace graphhp
