// The bisection ladder shared by K1 and K2 (quantile.cu) and K7 (polyfit.cu).
//
// A masked bisection takes `levels` halvings of a bracket [lo, hi], each
// deciding on count(x <= mid) <= target with mid = 0.5f * (lo + hi).  The
// ladder takes kLadderBits of them per pass over the data: it builds the
// 2^b - 1 midpoints of the next b levels of the bisection tree (heap order,
// root 1, each 0.5f * (lo + hi) of its own sub-bracket), sends every valid
// element down that tree (left where x <= mid) to one of 2^b leaves, counts
// the leaves, and walks the counts: count(x <= node) is the sum of the leaves
// left of the node's split.  The in-order sequence of the tree's midpoints
// never decreases (every midpoint lies in its bracket; where lo + hi
// overflows, the whole subtree is that infinity, which lies beyond every
// other node on its side), so an element lands in leaf L exactly when it is
// > the node left of L and <= the node right of it.  The leaf sums are exact
// integers, so the walk takes the bisection's decisions one level at a time
// and the result is bit-equal to bisecting level by level.
// tests/test_torch_quantile_ladder.py holds a numpy model of it to the plain
// versions.
#pragma once

#include "common.cuh"

namespace vt {

constexpr int kLadderBits = 8;  // bisection levels per pass
constexpr int kLeaves = 1 << kLadderBits;

// Levels the ladder takes in pass `pass` of `levels`.
__device__ __forceinline__ int pass_bits(int levels, int pass) {
  return min(kLadderBits, levels - pass * kLadderBits);
}

// Midpoint of heap node `node` (root 1) of the bisection tree over [a, b]:
// the path from the root halves the bracket as the bisection does.
__device__ __forceinline__ float node_midpoint(float a, float b, int node) {
  for (int k = 30 - __clz(node); k >= 0; --k) {
    const float m = 0.5f * (a + b);
    if ((node >> k) & 1) a = m; else b = m;
  }
  return 0.5f * (a + b);
}

// Leaf of v in the tree tree[1 .. 2^bits): left where v <= node.
__device__ __forceinline__ int leaf_of(float v, const float* tree, int bits) {
  int node = 1;
  for (int l = 0; l < bits; ++l) node = 2 * node + (v > tree[node] ? 1 : 0);
  return node - (1 << bits);
}

// Counts one element's leaf into the shared histogram `hist`: leaf 0 (where
// everything below the bracket lands) in the thread's `below`, added later
// by flush_below; the last leaf is never read by the walk.
__device__ __forceinline__ void count_leaf(int leaf, int leaves, int* hist, int& below) {
  if (leaf == 0) ++below;
  else if (leaf != leaves - 1) atomicAdd(&hist[leaf], 1);
}

__device__ __forceinline__ void flush_below(int below, int* hist) {
  const int c = warp_reduce(below, SumOp());
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&hist[0], c);
}

// One pass of the walk: the decisions of `bits` bisection levels from the
// leaf counts h[0 .. 2^bits) of the tree over [a, b], `target` as in the
// bisection.  Called by a whole warp; every lane returns the same bracket.
__device__ __forceinline__ void walk_leaves(const int* h, int bits, float target, float& a,
                                            float& b) {
  const int lane = threadIdx.x & 31;
  int below = 0, first = 0;  // count of the leaves left of `first`
  for (int d = 0; d < bits; ++d) {
    const int half = 1 << (bits - d - 1);
    int part = 0;
    for (int i = lane; i < half; i += 32) part += h[first + i];
    const int c = below + warp_reduce(part, SumOp());
    const float mid = 0.5f * (a + b);
    if ((float)c <= target) {
      a = mid;
      below = c;
      first += half;
    } else {
      b = mid;
    }
  }
}

// Calls f(i, v, ok) for each element i of [begin, end) of one plane, the
// block's threads striding over it; ok: mask set and v finite.  kVec: 16-byte
// value and 4-byte mask loads; begin and end are then multiples of 4.
template <bool kVec, class F>
__device__ __forceinline__ void for_each_masked(const float* __restrict__ x,
                                                const uint8_t* __restrict__ mask, int begin,
                                                int end, F f) {
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask);
    for (int i = begin / 4 + threadIdx.x; i < end / 4; i += blockDim.x) {
      const float4 v = x4[i];
      const uchar4 m = m4[i];
      f(4 * i, v.x, m.x && isfinite(v.x));
      f(4 * i + 1, v.y, m.y && isfinite(v.y));
      f(4 * i + 2, v.z, m.z && isfinite(v.z));
      f(4 * i + 3, v.w, m.w && isfinite(v.w));
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const float v = x[i];
      f(i, v, mask[i] && isfinite(v));
    }
  }
}

// Whether 16-byte loads may read a plane of n elements at x and its mask.
inline bool vector_loads(const float* x, const uint8_t* mask, int n) {
  return n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)mask % 4 == 0;
}

}  // namespace vt
