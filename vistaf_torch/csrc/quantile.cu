// K1: masked quantiles by bisection, one CTA per plane.
//
// Replaces the JAX package's pallas/quantile_kernel.py::masked_quantiles_pallas.
// One range pass folds the mask into the values (NaN outside it, since
// NaN <= mid is false) and takes n, min and max; then, per quantile,
// `levels` bisection passes of one masked count each.  The f32 scalar
// arithmetic is the TPU kernel's: target = f32(q/100) * max(n - 1, 0),
// midpoint 0.5f * (lo + hi), 0 for an empty mask.  Counts are exact
// integers, so the result is bit-equal to the plain version.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
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

__global__ void __launch_bounds__(kThreads)
masked_quantiles_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                        float* __restrict__ folded, float* __restrict__ out, int n,
                        Fractions fr, int nq, int levels) {
  __shared__ float redf[33];
  __shared__ int redi[33];
  const size_t base = (size_t)blockIdx.x * n;
  const float* xb = x + base;
  const uint8_t* mb = mask + base;
  float* fb = folded + base;

  int cnt = 0;
  float lo = vt::kBig, hi = -vt::kBig;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = xb[i];
    const bool ok = mb[i] && isfinite(v);
    fb[i] = ok ? v : __int_as_float(0x7fc00000);
    if (ok) {
      ++cnt;
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
  // the reductions' barriers also publish `folded` to the whole block
  const int nvalid = vt::block_sum(cnt, redi);
  lo = vt::block_min(lo, redf);
  hi = vt::block_max(hi, redf);

  const float nf = (float)nvalid;
  for (int q = 0; q < nq; ++q) {
    const float target = fr.v[q] * vt::jmax(nf - 1.0f, 0.0f);
    const float v = vt::bisect_quantile(FoldedValue{fb}, n, target, lo, hi, levels, redi);
    if (threadIdx.x == 0) out[(size_t)blockIdx.x * nq + q] = nvalid > 0 ? v : 0.0f;
  }
}

}  // namespace

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
