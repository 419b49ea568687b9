// K1: masked quantiles by bisection, one CTA per plane, and K2: the fused
// masked median and MAD, one thread-block cluster of 8 CTAs per plane.
//
// K1 replaces the JAX package's pallas/quantile_kernel.py::masked_quantiles_pallas,
// K2 its masked_median_mad_pallas.  One range pass folds the mask into the
// values (NaN outside it, since NaN <= mid is false) and takes n, min and
// max; then `levels` bisection passes of one masked count each, per
// quantile (K1), or for the median and then for the MAD over |x - med|
// (K2, vt::median_mad, the device code K7 uses for its robust scale).  The
// f32 scalar arithmetic is the TPU kernels': target = f32(q/100) *
// max(n - 1, 0), midpoint 0.5f * (lo + hi), the MAD bracket
// [0, max(hi - med, med - lo)], 0 for an empty mask.  Counts are exact
// integers and min/max are exact, so the results are bit-equal to the
// plain versions however the plane is split.
//
// Bound: each level is one pass over the plane plus a reduction.  One CTA
// (K1) is bound by one SM's L2 bandwidth: at a native-4K crop (1182^2 = 1.4 M
// values, 5.6 MB) a level is ~1.4 M loads on one SM.  K2 splits the plane
// over the 8 CTAs of a cluster, each counting its eighth, and totals the
// per-CTA counts through distributed shared memory in rank order at every
// level, so the whole cluster agrees on the bracket without a host round
// trip or a second launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kClusterCtas = 8;  // the portable cluster size
constexpr int kMaxQuantiles = 8;

struct Fractions {
  float v[kMaxQuantiles];
};

struct FoldedValue {
  const float* p;
  __device__ bool operator()(int i, float* v) const {
    *v = p[i];
    return true;
  }
};

// Totals of a plane one CTA covers alone.
struct OneCta {
  __device__ int sum(int v) const { return v; }
  __device__ float min(float v) const { return v; }
  __device__ float max(float v) const { return v; }
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

__global__ void __launch_bounds__(kThreads)
masked_quantiles_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                        float* __restrict__ folded, float* __restrict__ out, int n,
                        Fractions fr, int nq, int levels) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const size_t base = (size_t)blockIdx.x * n;
  float* fb = folded + base;
  float lo, hi;
  const int nvalid = fold_range(x + base, mask + base, fb, 0, n, redf, redi, OneCta{}, &lo,
                                &hi);

  const float nf = (float)nvalid;
  for (int q = 0; q < nq; ++q) {
    const float target = fr.v[q] * vt::jmax(nf - 1.0f, 0.0f);
    const float v = vt::bisect_quantile(FoldedValue{fb}, 0, n, target, lo, hi, levels,
                                        vt::block_count(redi));
    if (threadIdx.x == 0) out[(size_t)blockIdx.x * nq + q] = nvalid > 0 ? v : 0.0f;
  }
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

// x, mask, folded: (batch, n); out: (batch, nq); fractions: host array of
// nq values f32(q / 100).
extern "C" int vt_masked_quantiles(const float* x, const uint8_t* mask, float* folded,
                                   float* out, int batch, int n, const float* fractions,
                                   int nq, int levels, void* stream) {
  if (batch < 1 || n < 1 || nq < 1 || nq > kMaxQuantiles || levels < 0)
    return (int)cudaErrorInvalidValue;
  Fractions fr{};
  for (int i = 0; i < nq; ++i) fr.v[i] = fractions[i];
  masked_quantiles_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      x, mask, folded, out, n, fr, nq, levels);
  return (int)cudaGetLastError();
}
