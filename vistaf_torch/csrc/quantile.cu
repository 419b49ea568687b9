// K1: masked quantiles by a bisection ladder spread over many CTAs, and K2:
// the fused masked median and MAD, one thread-block cluster of 8 CTAs per
// plane.
//
// K1 replaces the JAX package's pallas/quantile_kernel.py::masked_quantiles_pallas,
// K2 its masked_median_mad_pallas.  Both compute the TPU kernels' bisection:
// n = count(mask & finite), [lo, hi] = the masked min/max, then `levels`
// halvings of the bracket, each deciding on count(x <= mid) <= target with
// target = f32(q/100) * max(n - 1, 0) and mid = 0.5f * (lo + hi); the result
// is the bracket midpoint, 0 for an empty mask.  K2 bisects the median and
// then the MAD over |x - med| in [0, max(hi - med, med - lo)]
// (vt::median_mad, the device code K7 uses for its robust scale).
//
// K1, bound and design.  The function must read each value and mask byte
// once (5 bytes an element): 8.3 M elements of the 4K temperature gray are
// 12 us of HBM time.  A bisection that counts the plane once per level reads
// it 23 times, and one CTA per plane uses one SM.  So each plane is split
// over `split` CTAs (up to three per SM of the card, at least kMinSpan
// elements each) and the levels are taken kLadderBits = 8 at a time:
//   1. a range pass: per-CTA masked count, min and max (exact in any order),
//      written as partials; it also zeroes the ladder histograms;
//   2. ceil(levels / 8) ladder passes.  Every CTA combines the range
//      partials and replays the walks of the earlier passes (below), so all
//      CTAs hold the same bracket.  It builds the 2^b - 1 midpoints of the
//      next b levels of the bisection tree, each 0.5f * (lo + hi) of its own
//      sub-bracket, for every quantile of the call; each valid element
//      descends that tree (left where x <= mid) to one of 2^b leaves, and the
//      CTA counts leaves in shared memory (leaf 0, where all elements below
//      the bracket land, in registers) and adds them to the plane's integer
//      histogram with atomicAdd;
//   3. a finish launch walks the last histogram and writes the midpoints.
// The walk: the in-order sequence of the tree's midpoints never decreases
// (every midpoint lies in its bracket; where lo + hi overflows, the whole
// subtree is that infinity, which lies beyond every other node on its side),
// so an element lands in leaf L exactly when it is > the node left of L and
// <= the node right of it, and count(x <= node) is the sum of the leaves left
// of the node's split.  Those sums are exact integers, so the walk takes the
// bisection's decisions, (float)c <= target, one level at a time, and the
// result is bit-equal to the plain version.  One call reads the plane
// 1 + ceil(levels / 8) times (4 at 23 levels: 20 bytes an element) whatever
// the number of quantiles, and makes 2 + ceil(levels / 8) launches; no host
// sync, no grid-wide barrier.  The values are read in place (float4 and
// uchar4 loads where the plane's length is a multiple of 4 and the pointers
// are aligned): folding the mask into a scratch plane first would move
// 5 + 4 bytes and then 4 a pass (21 bytes an element at 23 levels), no fewer.
// At the port's shapes on an H100 the kernels take less device time than
// the host takes to enqueue them (chip_smoke.py's device_ms beside ms).
// 512 threads a CTA; ptxas (sm_90a): the pass kernel 32 registers (38 on
// the scalar path) and 16.7 KB of shared memory (the tree and the leaf
// counts of 8 quantiles), so three CTAs fit on an SM; the range kernel 23
// registers, the finish kernel 29.
//
// K2: bound by the same passes over the plane (16 + 16 levels at 1182^2), it
// splits each plane over the 8 CTAs of a cluster, each counting its eighth,
// and totals the per-CTA counts through distributed shared memory in rank
// order at every level, so the whole cluster agrees on the bracket without a
// host round trip or a second launch.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kClusterCtas = 8;  // the portable cluster size
constexpr int kMaxQuantiles = 8;

// K1's ladder
constexpr int kLadderThreads = 512;
constexpr int kLadderBits = 8;               // bisection levels per pass
constexpr int kLeaves = 1 << kLadderBits;
constexpr int kMaxSplit = 396;               // CTAs of one pass: three per SM of an H100
constexpr int kMinSpan = 2048;               // elements a CTA covers at least
static_assert(kMaxSplit <= kLadderThreads, "one range partial per thread");

struct Fractions {
  float v[kMaxQuantiles];
};

// How K1 splits a call: `split` CTAs per plane over `chunk` elements each
// (a multiple of 4), `passes` ladder passes, and `stride` int32 words of
// scratch per plane: [count | lo | hi] partials of the range pass (split
// each), then the histograms (passes x nq x kLeaves).
struct LadderPlan {
  int split, chunk, passes, nq, levels, stride;
};

LadderPlan ladder_plan(int batch, int n, int nq, int levels) {
  LadderPlan p;
  int split = (n + kMinSpan - 1) / kMinSpan;
  const int cap = kMaxSplit / batch;
  if (split > cap) split = cap;
  if (split < 1) split = 1;
  p.chunk = ((n + split - 1) / split + 3) & ~3;
  p.split = (n + p.chunk - 1) / p.chunk;
  p.passes = (levels + kLadderBits - 1) / kLadderBits;
  p.nq = nq;
  p.levels = levels;
  p.stride = 3 * p.split + p.passes * nq * kLeaves;
  return p;
}

// Calls f(v) for each valid element (mask set, value finite) of [begin, end)
// of one plane, the block's threads striding over it.  kVec: 16-byte value
// and 4-byte mask loads; begin and end are then multiples of 4.
template <bool kVec, class F>
__device__ __forceinline__ void for_valid(const float* __restrict__ x,
                                          const uint8_t* __restrict__ mask, int begin,
                                          int end, F f) {
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const uchar4* m4 = reinterpret_cast<const uchar4*>(mask);
    for (int i = begin / 4 + threadIdx.x; i < end / 4; i += blockDim.x) {
      const float4 v = x4[i];
      const uchar4 m = m4[i];
      if (m.x && isfinite(v.x)) f(v.x);
      if (m.y && isfinite(v.y)) f(v.y);
      if (m.z && isfinite(v.z)) f(v.z);
      if (m.w && isfinite(v.w)) f(v.w);
    }
  } else {
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const float v = x[i];
      if (mask[i] && isfinite(v)) f(v);
    }
  }
}

// Pass 1: per-CTA masked count, min and max of the CTA's chunk; zeroes the
// plane's histograms.  grid (split, batch).
template <bool kVec>
__global__ void __launch_bounds__(kLadderThreads)
quantile_range_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                      int* __restrict__ scratch, int n, LadderPlan p) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int s = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * n;
  int* ws = scratch + (size_t)blockIdx.y * p.stride;
  const int begin = min(n, s * p.chunk);
  const int end = min(n, begin + p.chunk);
  int cnt = 0;
  float lo[1] = {INFINITY}, hi[1] = {-INFINITY};
  for_valid<kVec>(x + base, mask + base, begin, end, [&](float v) {
    ++cnt;
    lo[0] = fminf(lo[0], v);
    hi[0] = fmaxf(hi[0], v);
  });
  cnt = vt::block_sum(cnt, redi);
  vt::block_reduce(lo, redf, vt::MinOp(), INFINITY);
  vt::block_reduce(hi, redf, vt::MaxOp(), -INFINITY);
  if (threadIdx.x == 0) {
    ws[s] = cnt;
    ws[p.split + s] = __float_as_int(lo[0]);
    ws[2 * p.split + s] = __float_as_int(hi[0]);
  }
  int* hist = ws + 3 * p.split;
  const int words = p.passes * p.nq * kLeaves;
  for (int i = s * blockDim.x + threadIdx.x; i < words; i += p.split * blockDim.x) hist[i] = 0;
}

__device__ __forceinline__ int pass_bits(const LadderPlan& p, int pass) {
  return min(kLadderBits, p.levels - pass * kLadderBits);
}

// The plane's masked count and, in bracket[q], every quantile's bisection
// bracket after the ladder passes [0, upto): the range partials combined,
// then each pass's histograms staged in `hs` and walked by one warp per
// quantile.  Every thread of every CTA of the plane gets the same bits.
// Ends with a barrier.
__device__ int plane_brackets(const int* __restrict__ ws, int n, const LadderPlan& p,
                              const Fractions& fr, int upto, int (&hs)[kMaxQuantiles][kLeaves],
                              float (&bracket)[kMaxQuantiles][2]) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int t = threadIdx.x;
  const int nvalid = vt::block_sum(t < p.split ? ws[t] : 0, redi);
  float lo[1] = {t < p.split ? __int_as_float(ws[p.split + t]) : INFINITY};
  float hi[1] = {t < p.split ? __int_as_float(ws[2 * p.split + t]) : -INFINITY};
  vt::block_reduce(lo, redf, vt::MinOp(), INFINITY);
  vt::block_reduce(hi, redf, vt::MaxOp(), -INFINITY);
  if (nvalid < n) {  // the plain version's where(valid, x, +-3e38) extremes
    lo[0] = fminf(lo[0], vt::kBig);
    hi[0] = fmaxf(hi[0], -vt::kBig);
  }
  const int q = t >> 5, lane = t & 31;
  const float target = q < p.nq ? fr.v[q] * vt::jmax((float)nvalid - 1.0f, 0.0f) : 0.0f;
  float a = lo[0], b = hi[0];
  for (int j = 0; j < upto; ++j) {
    const int bits = pass_bits(p, j);
    const int leaves = 1 << bits;
    const int* h = ws + 3 * p.split + j * p.nq * kLeaves;
    for (int i = t; i < p.nq * leaves; i += blockDim.x)
      hs[i >> bits][i & (leaves - 1)] = h[(i >> bits) * kLeaves + (i & (leaves - 1))];
    __syncthreads();
    if (q < p.nq) {
      int below = 0, first = 0;  // count of the leaves left of `first`
      for (int d = 0; d < bits; ++d) {
        const int half = 1 << (bits - d - 1);
        int part = 0;
        for (int i = lane; i < half; i += 32) part += hs[q][first + i];
        const int c = below + vt::warp_reduce(part, vt::SumOp());
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
    __syncthreads();
  }
  if (q < p.nq && lane == 0) {
    bracket[q][0] = a;
    bracket[q][1] = b;
  }
  __syncthreads();
  return nvalid;
}

// Midpoint of heap node `node` (root 1) of the bisection tree over [a, b]:
// the path from the root halves the bracket as bisect_quantile does.
__device__ __forceinline__ float node_midpoint(float a, float b, int node) {
  for (int k = 30 - __clz(node); k >= 0; --k) {
    const float m = 0.5f * (a + b);
    if ((node >> k) & 1) a = m; else b = m;
  }
  return 0.5f * (a + b);
}

// Ladder pass `pass`: the leaf histogram of the next pass_bits levels of
// every quantile.  grid (split, batch).
template <bool kVec>
__global__ void __launch_bounds__(kLadderThreads)
quantile_pass_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                     int* __restrict__ scratch, int n, LadderPlan p, Fractions fr, int pass) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ float tree[kMaxQuantiles][kLeaves];
  __shared__ int hist[kMaxQuantiles][kLeaves];
  const int s = blockIdx.x;
  const size_t base = (size_t)blockIdx.y * n;
  int* ws = scratch + (size_t)blockIdx.y * p.stride;
  plane_brackets(ws, n, p, fr, pass, hist, bracket);
  const int bits = pass_bits(p, pass);
  const int leaves = 1 << bits;
  const int nq = p.nq;
  for (int i = threadIdx.x; i < nq * leaves; i += blockDim.x) {
    const int q = i >> bits, node = i & (leaves - 1);
    hist[q][node] = 0;
    if (node) tree[q][node] = node_midpoint(bracket[q][0], bracket[q][1], node);
  }
  __syncthreads();

  const int begin = min(n, s * p.chunk);
  const int end = min(n, begin + p.chunk);
  int below[kMaxQuantiles] = {};
  for_valid<kVec>(x + base, mask + base, begin, end, [&](float v) {
#pragma unroll
    for (int q = 0; q < kMaxQuantiles; ++q) {
      if (q >= nq) break;
      int node = 1;
      for (int l = 0; l < bits; ++l) node = 2 * node + (v > tree[q][node] ? 1 : 0);
      const int leaf = node - leaves;
      // leaf 0 in registers (everything below the bracket lands there); the
      // last leaf is never read by the walk
      if (leaf == 0) ++below[q];
      else if (leaf != leaves - 1) atomicAdd(&hist[q][leaf], 1);
    }
  });
#pragma unroll
  for (int q = 0; q < kMaxQuantiles; ++q) {
    if (q >= nq) break;
    const int c = vt::warp_reduce(below[q], vt::SumOp());
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(&hist[q][0], c);
  }
  __syncthreads();
  int* out = ws + 3 * p.split + pass * nq * kLeaves;
  for (int i = threadIdx.x; i < nq * leaves; i += blockDim.x) {
    const int c = hist[i >> bits][i & (leaves - 1)];
    if (c) atomicAdd(&out[(i >> bits) * kLeaves + (i & (leaves - 1))], c);
  }
}

// The last walk and the results.  grid (batch).
__global__ void __launch_bounds__(kLadderThreads)
quantile_finish_kernel(const int* __restrict__ scratch, float* __restrict__ out, int n,
                       LadderPlan p, Fractions fr) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ int hs[kMaxQuantiles][kLeaves];
  const int* ws = scratch + (size_t)blockIdx.x * p.stride;
  const int nvalid = plane_brackets(ws, n, p, fr, p.passes, hs, bracket);
  const int q = threadIdx.x;
  if (q < p.nq)
    out[(size_t)blockIdx.x * p.nq + q] =
        nvalid > 0 ? 0.5f * (bracket[q][0] + bracket[q][1]) : 0.0f;
}

struct FoldedValue {
  const float* p;
  __device__ bool operator()(int i, float* v) const {
    *v = p[i];
    return true;
  }
};

// One value per CTA combined over the cluster through distributed shared
// memory, in rank order; every thread of every CTA returns the same bits.
template <class T, class Op>
__device__ T cluster_combine(T v, T* slot, Op op) {
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cl.sync();
  T s = *cl.map_shared_rank(slot, 0);
  for (int r = 1; r < kClusterCtas; ++r) s = op(s, *cl.map_shared_rank(slot, r));
  cl.sync();  // every CTA has read the slots before they are written again
  return s;
}

// Totals of a plane split over the CTAs of a cluster.
struct OverCluster {
  int* islot;
  float* fslot;
  __device__ int sum(int v) const { return cluster_combine(v, islot, vt::SumOp()); }
  __device__ float min(float v) const { return cluster_combine(v, fslot, vt::MinOp()); }
  __device__ float max(float v) const { return cluster_combine(v, fslot, vt::MaxOp()); }
};

// Folds the mask into the values of [begin, end) (NaN outside mask &
// finite) and returns the plane's masked count, min and max.  The
// reductions' barriers also publish `folded` to the whole block.
template <class Totals, int M>
__device__ int fold_range(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                          float* __restrict__ folded, int begin, int end, float (&redf)[M],
                          int (&redi)[M], Totals totals, float* lo_out, float* hi_out) {
  int cnt = 0;
  float lo = vt::kBig, hi = -vt::kBig;
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    const float v = x[i];
    const bool ok = mask[i] && isfinite(v);
    folded[i] = ok ? v : __int_as_float(0x7fc00000);
    if (ok) {
      ++cnt;
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  const int nvalid = totals.sum(vt::block_sum(cnt, redi));
  *lo_out = totals.min(vt::block_min(lo, redf));
  *hi_out = totals.max(vt::block_max(hi, redf));
  return nvalid;
}

__global__ void __cluster_dims__(kClusterCtas, 1, 1) __launch_bounds__(kThreads)
masked_median_mad_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                         float* __restrict__ folded, float* __restrict__ out, int n,
                         int levels) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  __shared__ int islot;
  __shared__ float fslot;
  const int rank = (int)cg::this_cluster().block_rank();
  const size_t plane = blockIdx.x / kClusterCtas;
  const size_t base = plane * n;
  const int chunk = (n + kClusterCtas - 1) / kClusterCtas;
  const int begin = min(n, rank * chunk);
  const int end = min(n, begin + chunk);
  const OverCluster totals{&islot, &fslot};
  float* fb = folded + base;
  float lo, hi;
  const int nvalid = fold_range(x + base, mask + base, fb, begin, end, redf, redi, totals,
                                &lo, &hi);
  float med, mad;
  vt::median_mad(FoldedValue{fb}, begin, end, (float)nvalid, lo, hi, levels,
                 [&](int c) { return totals.sum(vt::block_sum(c, redi)); }, &med, &mad);
  if (rank == 0 && threadIdx.x == 0) {
    out[2 * plane] = nvalid > 0 ? med : 0.0f;
    out[2 * plane + 1] = nvalid > 0 ? mad : 0.0f;
  }
}

}  // namespace

// x, mask, folded: (batch, n); out: (batch, 2) = (median, MAD).
extern "C" int vt_masked_median_mad(const float* x, const uint8_t* mask, float* folded,
                                    float* out, int batch, int n, int levels,
                                    void* stream) {
  if (batch < 1 || n < 1 || levels < 0) return (int)cudaErrorInvalidValue;
  masked_median_mad_kernel<<<batch * kClusterCtas, kThreads, 0, (cudaStream_t)stream>>>(
      x, mask, folded, out, n, levels);
  return (int)cudaGetLastError();
}

// int32 words of scratch vt_masked_quantiles needs for these arguments.
extern "C" int vt_masked_quantiles_scratch(int batch, int n, int nq, int levels) {
  if (batch < 1 || n < 1 || nq < 1 || nq > kMaxQuantiles || levels < 0) return -1;
  return batch * ladder_plan(batch, n, nq, levels).stride;
}

// x, mask: (batch, n); scratch: vt_masked_quantiles_scratch int32 words;
// out: (batch, nq); fractions: host array of nq values f32(q / 100).
// Enqueues 2 + ceil(levels / 8) launches on `stream`.
extern "C" int vt_masked_quantiles(const float* x, const uint8_t* mask, int* scratch,
                                   float* out, int batch, int n, const float* fractions,
                                   int nq, int levels, void* stream) {
  if (batch < 1 || n < 1 || nq < 1 || nq > kMaxQuantiles || levels < 0)
    return (int)cudaErrorInvalidValue;
  Fractions fr{};
  for (int i = 0; i < nq; ++i) fr.v[i] = fractions[i];
  const LadderPlan p = ladder_plan(batch, n, nq, levels);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(p.split, batch);
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)mask % 4 == 0;
  if (vec) quantile_range_kernel<true><<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p);
  else quantile_range_kernel<false><<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p);
  cudaError_t err = cudaGetLastError();
  for (int pass = 0; pass < p.passes && err == cudaSuccess; ++pass) {
    if (vec)
      quantile_pass_kernel<true><<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p, fr,
                                                                  pass);
    else
      quantile_pass_kernel<false><<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p, fr,
                                                                   pass);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  quantile_finish_kernel<<<batch, kLadderThreads, 0, st>>>(scratch, out, n, p, fr);
  return (int)cudaGetLastError();
}
