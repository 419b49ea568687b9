// Shared device helpers for the vistaf_torch Hopper kernels.
//
// Reductions over a plane use the fixed-order block reductions below (and,
// in the multi-CTA kernels, per-CTA partials combined in a fixed order): a
// warp butterfly (every lane ends with the same bits, since float addition
// is commutative), then one warp over the per-warp partials in warp order.  No atomics, so a reduction
// gives the same bits on every run; the ECC convergence test compares rho
// at the level of one f32 ulp, where a run-to-run order change would change
// trip counts.
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
template <int M>
__device__ __forceinline__ float block_min(float v, float (&red)[M]) {
  float a[1] = {v};
  block_reduce(a, red, MinOp(), kBig);
  return a[0];
}
template <int M>
__device__ __forceinline__ float block_max(float v, float (&red)[M]) {
  float a[1] = {v};
  block_reduce(a, red, MaxOp(), -kBig);
  return a[0];
}

// Bisection of the masked quantile bracket [lo, hi] (the body of the TPU
// kernel's level loop): `levels` passes, each one masked count over the
// elements [begin, end) this CTA covers, totalled by `count` (the block's
// sum, or the sum over the CTAs that share the plane).  `value(i, &v)`
// returns false for pixels outside the mask.  Counts are exact integers,
// so every thread of every CTA returns the same bracket midpoint.
template <class ValueFn, class CountFn>
__device__ float bisect_quantile(ValueFn value, int begin, int end, float target, float lo,
                                 float hi, int levels, CountFn count) {
  for (int lv = 0; lv < levels; ++lv) {
    const float mid = 0.5f * (lo + hi);
    int c = 0;
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      float v;
      if (value(i, &v) && v <= mid) ++c;
    }
    c = count(c);
    if ((float)c <= target) lo = mid; else hi = mid;
  }
  return 0.5f * (lo + hi);
}

// `count` for a plane one CTA covers alone: the block's sum.
template <int M>
struct BlockCount {
  int (&red)[M];
  __device__ int operator()(int c) const { return block_sum(c, red); }
};
template <int M>
__device__ __forceinline__ BlockCount<M> block_count(int (&red)[M]) {
  return BlockCount<M>{red};
}

// |v - center| of the values `inner` yields: the MAD pass reads the data
// as deviations from the median on the fly.
template <class ValueFn>
struct AbsDev {
  ValueFn inner;
  float center;
  __device__ bool operator()(int i, float* v) const {
    float x;
    if (!inner(i, &x)) return false;
    *v = fabsf(x - center);
    return true;
  }
};

// Masked median and MAD by bisection (the TPU kernels' fused pair, K2 and
// the robust scale inside K7): the median over the value range [lo, hi],
// then the median of |v - med| over [0, max(hi - med, med - lo)].
// `nvalid` is the masked count.  Every thread returns the same pair.
template <class ValueFn, class CountFn>
__device__ void median_mad(ValueFn value, int begin, int end, float nvalid, float lo,
                           float hi, int levels, CountFn count, float* med, float* mad) {
  const float target = 0.5f * jmax(nvalid - 1.0f, 0.0f);
  const float m = bisect_quantile(value, begin, end, target, lo, hi, levels, count);
  *med = m;
  *mad = bisect_quantile(AbsDev<ValueFn>{value, m}, begin, end, target, 0.0f,
                         jmax(hi - m, m - lo), levels, count);
}

}  // namespace vt
