// Shared device helpers for the vistaf_torch Hopper kernels.
//
// Reductions over a plane use the fixed-order block reductions below (and,
// in the multi-CTA kernels, per-CTA partials combined in a fixed order): a
// warp butterfly (every lane ends with the same bits, since float addition
// is commutative), then one warp over the per-warp partials in warp order.
// No float atomics (the bisection ladder, ladder.cuh, adds integer leaf
// counts with atomicAdd: integer sums do not depend on the order), so a
// reduction gives the same bits on every run; the ECC convergence test
// compares rho at the level of one f32 ulp, where a run-to-run order change
// would change trip counts.
//
// The sources are compiled with --fmad=false so that a*b + c rounds twice,
// as the plain PyTorch versions and the JAX reference do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFullMask = 0xffffffffu;

// jnp.maximum / jnp.minimum semantics: NaN propagates (fmaxf drops it).
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

struct SumOp {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <class T, class Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Reduces v[0..N) over the block; every thread returns with the totals.
// `red` is a shared array of at least N * 33 elements.  blockDim.x must be
// a multiple of 32.  Ends with a barrier, so `red` may be reused at once.
template <class T, int N, int M, class Op>
__device__ void block_reduce(T (&v)[N], T (&red)[M], Op op, T identity) {
  static_assert(M >= N * 33, "block_reduce: shared scratch needs N * 33 elements");
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const T s = warp_reduce(v[i], op);
    if (lane == 0) red[i * 32 + wid] = s;
  }
  __syncthreads();
  for (int i = wid; i < N; i += nw) {
    T s = lane < nw ? red[i * 32 + lane] : identity;
    s = warp_reduce(s, op);
    if (lane == 0) red[N * 32 + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = red[N * 32 + i];
  __syncthreads();
}

template <int M>
__device__ __forceinline__ int block_sum(int v, int (&red)[M]) {
  int a[1] = {v};
  block_reduce(a, red, SumOp(), 0);
  return a[0];
}

}  // namespace vt
