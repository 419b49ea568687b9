// K8: the fused per-pixel temperature models, one thread per pixel.
//
// Replaces the JAX package's pallas/temp_kernel.py::make_fused_temperature_fn
// (fused_temperature_maps).  Per pixel of the blurred (H, W, 3) BGR crop:
// OpenCV 8-bit LAB and gray -> chroma -> the WIDE polynomial over
// (L, a, b, gray) and the COLOR polynomial over (L, a, b), each with its
// optional isotonic calibrator -> gating by roi_eff and by the colour
// support, color_support_pre & (chroma >= chroma_min).
//
// The arithmetic is the Pallas body's, operation for operation, in float32
// (compiled with --fmad=false): the cube root is exp(log(max(t, 1e-30)) *
// (1/3)), every constant is the float32 rounding of its double value,
// rounding is half to even (rintf), a monomial multiplies its factors in
// feature order starting from the first, and the isotonic map takes the
// last segment with pred >= x0 (a NaN prediction keeps y[0]).  The host
// drops zero-coefficient terms and x1 <= x0 segments, as the Pallas kernel
// skips them.
//
// Bound: 14 bytes in and 9 out a pixel, each touched once, so the kernel is
// memory-bound on the H100 (23 B x 2.68 Mpx = 61.5 MB, ~18 us at 3.35 TB/s);
// its 100 to 300 float32 operations a pixel stay under that line.  The
// model tables ride in the kernel's parameter space (constant bank), read
// uniformly by every thread; the isotonic segments are one small device
// table that stays in L1.
#include <algorithm>

#include "common.cuh"

// the float32 rounding of a double constant, as the JAX kernel rounds its
// weak-typed Python floats (a float literal could round differently)
#define F32(x) ((float)(x))

constexpr int kMaxTerms = 64;
constexpr int kMaxFeatures = 4;

// PolyModel and TempParams are mirrored field for field by ctypes structures
// in kernels/temp_kernel.py.
struct PolyModel {
  float mean[kMaxFeatures];
  float scale[kMaxFeatures];
  float coef[kMaxTerms];
  float intercept;
  int n_terms;
  int n_feat;
  int n_seg;
  int has_iso;
  float iso_y0;
  uint8_t powers[kMaxTerms][kMaxFeatures];
};

struct TempParams {
  PolyModel wide;
  PolyModel color;
  float chroma_min;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float cbrt_exp_log(float t) {
  return expf(logf(vt::jmax(t, F32(1e-30))) * F32(1.0 / 3.0));
}

__device__ __forceinline__ float inv_gamma(float c) {
  return c <= F32(0.04045) ? c * F32(1.0 / 12.92)
                           : powf((c + F32(0.055)) * F32(1.0 / 1.055), F32(2.4));
}

__device__ __forceinline__ float f_lab(float t, float cbrt_t) {
  return t > F32(0.008856) ? cbrt_t : F32(7.787) * t + F32(16.0 / 116.0);
}

__device__ __forceinline__ float clip255(float v) {
  return vt::jmin(vt::jmax(v, 0.0f), 255.0f);
}

__device__ __forceinline__ float poly_eval(const PolyModel& m,
                                           const float (&feat)[kMaxFeatures],
                                           const float4* __restrict__ seg) {
  float s[kMaxFeatures];
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) {
    s[f] = f < m.n_feat ? (feat[f] - m.mean[f]) / m.scale[f] : 0.0f;
  }
  float out = m.intercept;
  for (int p = 0; p < m.n_terms; ++p) {
    float term = 0.0f;
    bool any = false;
#pragma unroll
    for (int f = 0; f < kMaxFeatures; ++f) {
      const int e = f < m.n_feat ? m.powers[p][f] : 0;
      for (int k = 0; k < e; ++k) {
        term = any ? term * s[f] : s[f];
        any = true;
      }
    }
    out = any ? out + m.coef[p] * term : out + m.coef[p];
  }
  if (!m.has_iso) return out;
  // last segment (in table order) with out >= x0; none (or NaN) keeps y[0]
  for (int i = m.n_seg - 1; i >= 0; --i) {
    const float4 q = seg[i];
    if (out >= q.x) {
      const float t = vt::jmin(vt::jmax((out - q.x) / q.z, 0.0f), 1.0f);
      return q.y + t * q.w;
    }
  }
  return m.iso_y0;
}

__global__ void __launch_bounds__(kThreads)
fused_temp_kernel(const float* __restrict__ bgr, const uint8_t* __restrict__ roi_eff,
                  const uint8_t* __restrict__ csup_pre, float* __restrict__ wide_out,
                  float* __restrict__ color_out, uint8_t* __restrict__ csup_out, int n,
                  const __grid_constant__ TempParams p,
                  const float4* __restrict__ wide_seg,
                  const float4* __restrict__ color_seg) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const float b = bgr[3 * (size_t)i];
    const float g = bgr[3 * (size_t)i + 1];
    const float r = bgr[3 * (size_t)i + 2];
    const float bl = inv_gamma(b * F32(1.0 / 255.0));
    const float gl = inv_gamma(g * F32(1.0 / 255.0));
    const float rl = inv_gamma(r * F32(1.0 / 255.0));
    const float x = (F32(0.412453) * rl + F32(0.357580) * gl + F32(0.180423) * bl) /
                    F32(0.950456);
    const float y = F32(0.212671) * rl + F32(0.715160) * gl + F32(0.072169) * bl;
    const float z = (F32(0.019334) * rl + F32(0.119193) * gl + F32(0.950227) * bl) /
                    F32(1.088754);
    const float cy = cbrt_exp_log(y);
    const float fx = f_lab(x, cbrt_exp_log(x));
    const float fy = f_lab(y, cy);
    const float fz = f_lab(z, cbrt_exp_log(z));
    const float L = y > F32(0.008856) ? 116.0f * cy - 16.0f : F32(903.3) * y;
    const float A = 500.0f * (fx - fy) + 128.0f;
    const float B = 200.0f * (fy - fz) + 128.0f;
    float feat[kMaxFeatures];
    feat[0] = clip255(rintf(L * F32(255.0 / 100.0)));
    feat[1] = clip255(rintf(A));
    feat[2] = clip255(rintf(B));
    feat[3] = rintf(F32(0.299) * r + F32(0.587) * g + F32(0.114) * b);
    const float da = feat[1] - 128.0f;
    const float db = feat[2] - 128.0f;
    const float chroma = sqrtf(da * da + db * db);
    const bool cs = csup_pre[i] && chroma >= p.chroma_min;

    wide_out[i] =
        roi_eff[i] ? poly_eval(p.wide, feat, wide_seg) : __int_as_float(0x7fc00000);
    color_out[i] = cs ? poly_eval(p.color, feat, color_seg) : __int_as_float(0x7fc00000);
    csup_out[i] = cs ? 1 : 0;
  }
}

}  // namespace

// sizeof(TempParams), which the Python side checks against its ctypes mirror
extern "C" int vt_temp_params_size() { return (int)sizeof(TempParams); }

// bgr: (n, 3) float32; roi_eff, csup_pre, csup_out: (n,) bool; wide_out,
// color_out: (n,) float32; params: host pointer to TempParams; wide_seg,
// color_seg: (n_seg, 4) float32 device tables.
extern "C" int vt_fused_temperature(const float* bgr, const uint8_t* roi_eff,
                                    const uint8_t* csup_pre, float* wide_out,
                                    float* color_out, uint8_t* csup_out, int n,
                                    const TempParams* params, const float4* wide_seg,
                                    const float4* color_seg, void* stream) {
  if (n < 1 || params == nullptr) return (int)cudaErrorInvalidValue;
  const PolyModel* ms[2] = {&params->wide, &params->color};
  for (const PolyModel* m : ms) {
    if (m->n_terms < 0 || m->n_terms > kMaxTerms || m->n_feat < 1 ||
        m->n_feat > kMaxFeatures || m->n_seg < 0)
      return (int)cudaErrorInvalidValue;
  }
  const int blocks = (int)std::min<long long>(((long long)n + kThreads - 1) / kThreads,
                                              132LL * 16);
  fused_temp_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      bgr, roi_eff, csup_pre, wide_out, color_out, csup_out, n, *params, wide_seg,
      color_seg);
  return (int)cudaGetLastError();
}
