// K7: the whole robust (IRLS, Cauchy-weighted) 2-D polynomial fit, one CTA.
//
// Replaces the JAX package's pallas/polyfit_kernel.py::robust_polyfit2d_pallas.
// Per round: the w^2-weighted normal equations as plane sums (21 + 6 for
// order 2), +1e-9 on the diagonal, an unrolled Cholesky solve by thread 0;
// then, in the first `resigma_iters` rounds, the bisection median and MAD
// of the residual over the mask; Cauchy weights 1 / (1 + u^2) with
// u = r / (c * 1.4826 * (mad + 1e-6)).  The weights are recomputed from the
// previous round's coefficients instead of being kept as a plane.  Output:
// the coefficients, zeros when the mask holds fewer than 200 pixels.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCoef = 6;
constexpr int kSums = 27;  // 21 normal-matrix entries + 6 right-hand sides

struct Basis {
  float cx, cy;
  int w, ncoef;
  __device__ __forceinline__ void at(int pix, float* col) const {
    const int v = pix / w, u = pix - v * w;
    const float xn = ((float)u - cx) / cx;
    const float yn = ((float)v - cy) / cy;
    col[0] = xn;
    col[1] = yn;
    col[2] = 1.0f;
    col[3] = xn * xn;
    col[4] = xn * yn;
    col[5] = yn * yn;
  }
  __device__ __forceinline__ float residual(float z, const float* coef, const float* col) const {
    float r = z;
    for (int a = 0; a < ncoef; ++a) r = r - coef[a] * col[a];
    return r;
  }
};

// x = H^-1 g for the symmetric positive definite H (upper triangle H[j][i],
// j <= i), unrolled Cholesky and two substitutions
__device__ void chol_solve(const float (*H)[kMaxCoef], const float* g, int n, float* x) {
  float L[kMaxCoef][kMaxCoef];
  for (int j = 0; j < n; ++j) {
    float s = H[j][j];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(vt::jmax(s, 1e-20f));
    for (int i = j + 1; i < n; ++i) {
      float t = H[j][i];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[kMaxCoef];
  for (int i = 0; i < n; ++i) {
    float t = g[i];
    for (int k = 0; k < i; ++k) t = t - L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float t = y[i];
    for (int k = i + 1; k < n; ++k) t = t - L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
}

struct MaskedResidual {
  const float* z;
  const uint8_t* mask;
  const Basis* basis;
  const float* coef;
  float center;  // subtracted before |.|; NaN means "the signed residual"
  __device__ bool operator()(int i, float* v) const {
    const float zi = z[i];
    if (!(mask[i] && isfinite(zi))) return false;
    float col[kMaxCoef];
    basis->at(i, col);
    const float r = basis->residual(zi, coef, col);
    *v = isnan(center) ? r : fabsf(r - center);
    return true;
  }
};

__global__ void __launch_bounds__(kThreads)
polyfit_kernel(const float* __restrict__ z, const uint8_t* __restrict__ mask,
               float* __restrict__ out, int h, int w, int ncoef, int iters,
               int resigma_iters, float cauchy_c, int levels) {
  __shared__ float red[kSums * 33];
  __shared__ int redi[33];
  __shared__ float coef_s[kMaxCoef];
  const int n = h * w;
  const Basis basis{0.5f * (float)(w - 1), 0.5f * (float)(h - 1), w, ncoef};

  int cnt = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) cnt += (mask[i] && isfinite(z[i])) ? 1 : 0;
  cnt = vt::block_sum(cnt, redi);
  const float nf = (float)cnt;

  float coef[kMaxCoef] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float sigma = 1.0f;
  for (int round = 0; round < iters; ++round) {
    const float cs = cauchy_c * sigma;
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float zi = z[i];
      const bool m = mask[i] && isfinite(zi);
      const float zz = m ? zi : 0.0f;
      float col[kMaxCoef];
      basis.at(i, col);
      float wt = 1.0f;
      if (round > 0) {
        const float u = basis.residual(zz, coef, col) / cs;
        wt = 1.0f / (1.0f + u * u);
      }
      const float wm = wt * (m ? 1.0f : 0.0f);
      const float w2 = wm * wm;
      int q = 0;
      for (int a = 0; a < ncoef; ++a)
        for (int b = a; b < ncoef; ++b) acc[q++] += (w2 * col[a]) * col[b];
      for (int a = 0; a < ncoef; ++a) acc[21 + a] += (w2 * col[a]) * zz;
    }
    vt::block_reduce(acc, red, vt::SumOp(), 0.0f);

    if (threadIdx.x == 0) {
      float H[kMaxCoef][kMaxCoef];
      int q = 0;
      for (int a = 0; a < ncoef; ++a)
        for (int b = a; b < ncoef; ++b) H[a][b] = acc[q++];
      for (int a = 0; a < ncoef; ++a) H[a][a] = H[a][a] + 1e-9f;
      float x[kMaxCoef];
      chol_solve(H, acc + 21, ncoef, x);
      for (int a = 0; a < ncoef; ++a) coef_s[a] = x[a];
    }
    __syncthreads();
    for (int a = 0; a < ncoef; ++a) coef[a] = coef_s[a];

    if (round < resigma_iters) {
      float lo = vt::kBig, hi = -vt::kBig;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zi = z[i];
        if (!(mask[i] && isfinite(zi))) continue;
        float col[kMaxCoef];
        basis.at(i, col);
        const float r = basis.residual(zi, coef, col);
        lo = fminf(lo, r);
        hi = fmaxf(hi, r);
      }
      lo = vt::block_min(lo, red);
      hi = vt::block_max(hi, red);
      const float target = 0.5f * vt::jmax(nf - 1.0f, 0.0f);
      const float nan = __int_as_float(0x7fc00000);
      const float med = vt::bisect_quantile(MaskedResidual{z, mask, &basis, coef, nan}, n,
                                            target, lo, hi, levels, redi);
      const float mad =
          vt::bisect_quantile(MaskedResidual{z, mask, &basis, coef, med}, n, target, 0.0f,
                              vt::jmax(hi - med, med - lo), levels, redi);
      sigma = 1.4826f * (mad + 1e-6f);
    }
  }
  if (threadIdx.x < ncoef) out[threadIdx.x] = nf >= 200.0f ? coef[threadIdx.x] : 0.0f;
}

}  // namespace

// z, mask: (h, w); out: (ncoef,), ncoef 3 (order 1) or 6 (order 2).
extern "C" int vt_robust_polyfit2d(const float* z, const uint8_t* mask, float* out, int h,
                                   int w, int ncoef, int iters, int resigma_iters,
                                   float cauchy_c, int levels, void* stream) {
  if (h < 1 || w < 1 || (ncoef != 3 && ncoef != 6) || iters < 0 || levels < 0)
    return (int)cudaErrorInvalidValue;
  polyfit_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(z, mask, out, h, w, ncoef, iters,
                                                           resigma_iters, cauchy_c, levels);
  return (int)cudaGetLastError();
}
