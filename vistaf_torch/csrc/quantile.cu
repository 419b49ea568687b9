// K1: masked quantiles, and K2: the fused masked median and MAD, both by the
// bisection ladder (ladder.cuh) spread over many CTAs.
//
// K1 replaces the JAX package's pallas/quantile_kernel.py::masked_quantiles_pallas,
// K2 its masked_median_mad_pallas.  Both compute the TPU kernels' bisection:
// n = count(mask & finite), [lo, hi] = the masked min/max, then `levels`
// halvings of the bracket, each deciding on count(x <= mid) <= target with
// target = f32(q/100) * max(n - 1, 0) and mid = 0.5f * (lo + hi); the result
// is the bracket midpoint, 0 for an empty mask.  K2 bisects the median and
// then the MAD over |x - med| in [0, max(hi - med, med - lo)].
//
// Bound and design.  The function must read each value and mask byte once
// (5 bytes an element): 8.3 M elements of the 4K temperature gray are 12 us
// of HBM time.  A bisection that counts the plane once per level reads it
// 23 times (K1) or 32 times (K2), and one CTA per plane uses one SM.  So
// each plane is split over `split` CTAs (up to three per SM of the card, at
// least kMinSpan elements each) and the levels are taken vt::kLadderBits = 8
// at a time:
//   1. a range pass: per-CTA masked count, min and max (exact in any order),
//      written as partials; it also zeroes the ladder histograms;
//   2. ceil(levels / 8) ladder passes.  Every CTA combines the range
//      partials and replays the walks of the earlier passes from their
//      histograms, so all CTAs hold the same bracket; it builds the next
//      levels' tree for every quantile of the call, bins its valid elements
//      into leaves in shared memory and adds the leaf counts to the plane's
//      integer histogram with atomicAdd;
//   3. K2 only: ceil(levels / 8) MAD passes.  Every CTA replays the median's
//      walk to the same med (the histograms are exact integers, so it gets
//      the same bits as every other CTA), then the earlier MAD passes' walk
//      over [0, span], and bins |x - med| the same way;
//   4. a finish launch walks the last histograms and writes the results.
// One K1 call reads the plane 1 + ceil(levels / 8) times (4 at 23 levels:
// 20 bytes an element) whatever the number of quantiles, in 2 + ceil(levels /
// 8) launches; one K2 call 1 + 2 ceil(levels / 8) times (5 at 16 levels) in
// 2 + 2 ceil(levels / 8) launches (6).  No host sync, no grid-wide barrier,
// no float atomics.  The values are read in place (float4 and uchar4 loads
// where the plane's length is a multiple of 4 and the pointers are aligned):
// folding the mask into a scratch plane first would move 5 + 4 bytes and then
// 4 a pass, no fewer.  At the port's shapes on an H100 the kernels take less
// device time than the host takes to enqueue them (chip_smoke.py's device_ms
// beside ms).  512 threads a CTA; the pass kernel holds the trees and leaf
// counts of 8 quantiles in 16.7 KB of shared memory, so three CTAs fit on
// an SM.
#include <cmath>

#include "ladder.cuh"

namespace {

using vt::kLeaves;

constexpr int kMaxQuantiles = 8;
constexpr int kLadderThreads = 512;
constexpr int kMaxSplit = 396;               // CTAs of one pass: three per SM of an H100
constexpr int kMinSpan = 2048;               // elements a CTA covers at least
static_assert(kMaxSplit <= kLadderThreads, "one range partial per thread");

struct Fractions {
  float v[kMaxQuantiles];
};

// How a call splits: `split` CTAs per plane over `chunk` elements each (a
// multiple of 4), `passes` ladder passes per bisection, and `stride` int32
// words of scratch per plane: [count | lo | hi] partials of the range pass
// (split each), then the histograms of the nq quantiles (passes x nq x
// kLeaves) and, for K2, of the MAD (passes x kLeaves).
struct LadderPlan {
  int split, chunk, passes, nq, levels, stride;
};

LadderPlan ladder_plan(int batch, int n, int nq, int levels, bool mad) {
  LadderPlan p;
  int split = (n + kMinSpan - 1) / kMinSpan;
  const int cap = kMaxSplit / batch;
  if (split > cap) split = cap;
  if (split < 1) split = 1;
  p.chunk = ((n + split - 1) / split + 3) & ~3;
  p.split = (n + p.chunk - 1) / p.chunk;
  p.passes = (levels + vt::kLadderBits - 1) / vt::kLadderBits;
  p.nq = nq;
  p.levels = levels;
  p.stride = 3 * p.split + p.passes * (nq + (mad ? 1 : 0)) * kLeaves;
  return p;
}

// Calls f(v) for each valid element (mask set, value finite) of [begin, end)
// of one plane.
template <bool kVec, class F>
__device__ __forceinline__ void for_valid(const float* __restrict__ x,
                                          const uint8_t* __restrict__ mask, int begin,
                                          int end, F f) {
  vt::for_each_masked<kVec>(x, mask, begin, end, [&](int, float v, bool ok) {
    if (ok) f(v);
  });
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
  const int words = p.stride - 3 * p.split;
  for (int i = s * blockDim.x + threadIdx.x; i < words; i += p.split * blockDim.x) hist[i] = 0;
}

// The plane's masked count, and in lo, hi its bracket, from the range
// partials: the plain versions' where(valid, x, +-3e38) extremes.  Every
// thread of every CTA of the plane gets the same bits.
__device__ int plane_range(const int* __restrict__ ws, int n, const LadderPlan& p, float& lo,
                           float& hi) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int t = threadIdx.x;
  const int nvalid = vt::block_sum(t < p.split ? ws[t] : 0, redi);
  float l[1] = {t < p.split ? __int_as_float(ws[p.split + t]) : INFINITY};
  float h[1] = {t < p.split ? __int_as_float(ws[2 * p.split + t]) : -INFINITY};
  vt::block_reduce(l, redf, vt::MinOp(), INFINITY);
  vt::block_reduce(h, redf, vt::MaxOp(), -INFINITY);
  lo = l[0];
  hi = h[0];
  if (nvalid < n) {
    lo = fminf(lo, vt::kBig);
    hi = fmaxf(hi, -vt::kBig);
  }
  return nvalid;
}

// In bracket[q], the bracket of bisection q < nq (target fr.v[q] * max(n - 1,
// 0), starting from [a0, b0]) after the ladder passes [0, upto), whose
// histograms start at h (pass j, bisection q at h[(j * nq + q) * kLeaves]):
// each pass staged in `hs` and walked by one warp per bisection.  Every
// thread of every CTA of the plane gets the same bits.  Ends with a barrier.
__device__ void walk_hists(const int* __restrict__ h, int levels, int nq, int upto,
                           const Fractions& fr, int nvalid, float a0, float b0,
                           int (&hs)[kMaxQuantiles][kLeaves],
                           float (&bracket)[kMaxQuantiles][2]) {
  const int t = threadIdx.x;
  const int q = t >> 5;
  const float target = q < nq ? fr.v[q] * vt::jmax((float)nvalid - 1.0f, 0.0f) : 0.0f;
  float a = a0, b = b0;
  for (int j = 0; j < upto; ++j) {
    const int bits = vt::pass_bits(levels, j);
    const int leaves = 1 << bits;
    const int* hj = h + j * nq * kLeaves;
    for (int i = t; i < nq * leaves; i += blockDim.x)
      hs[i >> bits][i & (leaves - 1)] = hj[(i >> bits) * kLeaves + (i & (leaves - 1))];
    __syncthreads();
    if (q < nq) vt::walk_leaves(hs[q], bits, target, a, b);
    __syncthreads();
  }
  if (q < nq && (t & 31) == 0) {
    bracket[q][0] = a;
    bracket[q][1] = b;
  }
  __syncthreads();
}

// One ladder pass over [begin, end) of a plane: the leaf histograms of the
// next `bits` levels of nq bisections with brackets `bracket`, over
// value(x) of the valid elements x, added to out[q * kLeaves + leaf].
template <bool kVec, class Value>
__device__ void ladder_pass(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                            int begin, int end, int nq, int bits,
                            const float (&bracket)[kMaxQuantiles][2],
                            float (&tree)[kMaxQuantiles][kLeaves],
                            int (&hist)[kMaxQuantiles][kLeaves], int* __restrict__ out,
                            Value value) {
  const int leaves = 1 << bits;
  for (int i = threadIdx.x; i < nq * leaves; i += blockDim.x) {
    const int q = i >> bits, node = i & (leaves - 1);
    hist[q][node] = 0;
    if (node) tree[q][node] = vt::node_midpoint(bracket[q][0], bracket[q][1], node);
  }
  __syncthreads();
  int below[kMaxQuantiles] = {};
  for_valid<kVec>(x, mask, begin, end, [&](float v) {
    const float y = value(v);
#pragma unroll
    for (int q = 0; q < kMaxQuantiles; ++q) {
      if (q >= nq) break;
      vt::count_leaf(vt::leaf_of(y, tree[q], bits), leaves, hist[q], below[q]);
    }
  });
#pragma unroll
  for (int q = 0; q < kMaxQuantiles; ++q) {
    if (q >= nq) break;
    vt::flush_below(below[q], hist[q]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * leaves; i += blockDim.x) {
    const int c = hist[i >> bits][i & (leaves - 1)];
    if (c) atomicAdd(&out[(i >> bits) * kLeaves + (i & (leaves - 1))], c);
  }
}

struct Identity {
  __device__ float operator()(float v) const { return v; }
};
struct AbsDev {
  float center;
  __device__ float operator()(float v) const { return fabsf(v - center); }
};

// Ladder pass `pass` of every quantile (K1, and K2's median with the single
// fraction 0.5).  grid (split, batch).
template <bool kVec>
__global__ void __launch_bounds__(kLadderThreads)
quantile_pass_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                     int* __restrict__ scratch, int n, LadderPlan p, Fractions fr, int pass) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ float tree[kMaxQuantiles][kLeaves];
  __shared__ int hist[kMaxQuantiles][kLeaves];
  const size_t base = (size_t)blockIdx.y * n;
  int* ws = scratch + (size_t)blockIdx.y * p.stride;
  float lo, hi;
  const int nvalid = plane_range(ws, n, p, lo, hi);
  walk_hists(ws + 3 * p.split, p.levels, p.nq, pass, fr, nvalid, lo, hi, hist, bracket);
  const int begin = min(n, (int)blockIdx.x * p.chunk);
  const int end = min(n, begin + p.chunk);
  ladder_pass<kVec>(x + base, mask + base, begin, end, p.nq, vt::pass_bits(p.levels, pass),
                    bracket, tree, hist, ws + 3 * p.split + pass * p.nq * kLeaves, Identity());
}

// The last walk of K1 and the results.  grid (batch).
__global__ void __launch_bounds__(kLadderThreads)
quantile_finish_kernel(const int* __restrict__ scratch, float* __restrict__ out, int n,
                       LadderPlan p, Fractions fr) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ int hs[kMaxQuantiles][kLeaves];
  const int* ws = scratch + (size_t)blockIdx.x * p.stride;
  float lo, hi;
  const int nvalid = plane_range(ws, n, p, lo, hi);
  walk_hists(ws + 3 * p.split, p.levels, p.nq, p.passes, fr, nvalid, lo, hi, hs, bracket);
  const int q = threadIdx.x;
  if (q < p.nq)
    out[(size_t)blockIdx.x * p.nq + q] =
        nvalid > 0 ? 0.5f * (bracket[q][0] + bracket[q][1]) : 0.0f;
}

// K2: the plane's count, in med its median (all median passes walked), and
// in bracket[0] the MAD's bracket after the MAD passes [0, upto).  Every
// thread of every CTA of the plane gets the same bits.  Ends with a barrier.
__device__ int median_mad_brackets(const int* __restrict__ ws, int n, const LadderPlan& p,
                                   const Fractions& half, int upto,
                                   int (&hs)[kMaxQuantiles][kLeaves],
                                   float (&bracket)[kMaxQuantiles][2], float& med) {
  float lo, hi;
  const int nvalid = plane_range(ws, n, p, lo, hi);
  const int* h = ws + 3 * p.split;
  walk_hists(h, p.levels, 1, p.passes, half, nvalid, lo, hi, hs, bracket);
  med = 0.5f * (bracket[0][0] + bracket[0][1]);
  const float span = vt::jmax(hi - med, med - lo);
  __syncthreads();  // every thread has read the median's bracket
  walk_hists(h + p.passes * kLeaves, p.levels, 1, upto, half, nvalid, 0.0f, span, hs, bracket);
  return nvalid;
}

// K2's MAD ladder pass `pass` over |x - med|.  grid (split, batch).
template <bool kVec>
__global__ void __launch_bounds__(kLadderThreads)
mad_pass_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                int* __restrict__ scratch, int n, LadderPlan p, Fractions half, int pass) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ float tree[kMaxQuantiles][kLeaves];
  __shared__ int hist[kMaxQuantiles][kLeaves];
  const size_t base = (size_t)blockIdx.y * n;
  int* ws = scratch + (size_t)blockIdx.y * p.stride;
  float med;
  median_mad_brackets(ws, n, p, half, pass, hist, bracket, med);
  const int begin = min(n, (int)blockIdx.x * p.chunk);
  const int end = min(n, begin + p.chunk);
  ladder_pass<kVec>(x + base, mask + base, begin, end, 1, vt::pass_bits(p.levels, pass),
                    bracket, tree, hist, ws + 3 * p.split + (p.passes + pass) * kLeaves,
                    AbsDev{med});
}

// The last MAD walk and K2's results (median, MAD).  grid (batch).
__global__ void __launch_bounds__(kLadderThreads)
median_mad_finish_kernel(const int* __restrict__ scratch, float* __restrict__ out, int n,
                         LadderPlan p, Fractions half) {
  __shared__ float bracket[kMaxQuantiles][2];
  __shared__ int hs[kMaxQuantiles][kLeaves];
  const int* ws = scratch + (size_t)blockIdx.x * p.stride;
  float med;
  const int nvalid = median_mad_brackets(ws, n, p, half, p.passes, hs, bracket, med);
  if (threadIdx.x == 0) {
    const float mad = 0.5f * (bracket[0][0] + bracket[0][1]);
    out[2 * (size_t)blockIdx.x] = nvalid > 0 ? med : 0.0f;
    out[2 * (size_t)blockIdx.x + 1] = nvalid > 0 ? mad : 0.0f;
  }
}

// The range pass and the median's (or quantiles') ladder passes, enqueued on st.
cudaError_t range_and_passes(const float* x, const uint8_t* mask, int* scratch, int batch,
                             int n, const LadderPlan& p, const Fractions& fr, bool vec,
                             cudaStream_t st) {
  const dim3 grid(p.split, batch);
  const auto range = vec ? quantile_range_kernel<true> : quantile_range_kernel<false>;
  const auto pass_k = vec ? quantile_pass_kernel<true> : quantile_pass_kernel<false>;
  range<<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p);
  cudaError_t err = cudaGetLastError();
  for (int pass = 0; pass < p.passes && err == cudaSuccess; ++pass) {
    pass_k<<<grid, kLadderThreads, 0, st>>>(x, mask, scratch, n, p, fr, pass);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// int32 words of scratch vt_masked_median_mad needs for these arguments.
extern "C" int vt_masked_median_mad_scratch(int batch, int n, int levels) {
  if (batch < 1 || n < 1 || levels < 0) return -1;
  return batch * ladder_plan(batch, n, 1, levels, true).stride;
}

// x, mask: (batch, n); scratch: vt_masked_median_mad_scratch int32 words;
// out: (batch, 2) = (median, MAD).  Enqueues 2 + 2 ceil(levels / 8)
// launches on `stream`.
extern "C" int vt_masked_median_mad(const float* x, const uint8_t* mask, int* scratch,
                                    float* out, int batch, int n, int levels, void* stream) {
  if (batch < 1 || n < 1 || levels < 0) return (int)cudaErrorInvalidValue;
  const LadderPlan p = ladder_plan(batch, n, 1, levels, true);
  const Fractions half{{0.5f}};
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vt::vector_loads(x, mask, n);
  cudaError_t err = range_and_passes(x, mask, scratch, batch, n, p, half, vec, st);
  const auto mad_k = vec ? mad_pass_kernel<true> : mad_pass_kernel<false>;
  for (int pass = 0; pass < p.passes && err == cudaSuccess; ++pass) {
    mad_k<<<dim3(p.split, batch), kLadderThreads, 0, st>>>(x, mask, scratch, n, p, half, pass);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  median_mad_finish_kernel<<<batch, kLadderThreads, 0, st>>>(scratch, out, n, p, half);
  return (int)cudaGetLastError();
}

// int32 words of scratch vt_masked_quantiles needs for these arguments.
extern "C" int vt_masked_quantiles_scratch(int batch, int n, int nq, int levels) {
  if (batch < 1 || n < 1 || nq < 1 || nq > kMaxQuantiles || levels < 0) return -1;
  return batch * ladder_plan(batch, n, nq, levels, false).stride;
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
  const LadderPlan p = ladder_plan(batch, n, nq, levels, false);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      range_and_passes(x, mask, scratch, batch, n, p, fr, vt::vector_loads(x, mask, n), st);
  if (err != cudaSuccess) return (int)err;
  quantile_finish_kernel<<<batch, kLadderThreads, 0, st>>>(scratch, out, n, p, fr);
  return (int)cudaGetLastError();
}
