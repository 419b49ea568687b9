// K8: the fused per-pixel temperature models, four pixels a thread.
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
// rounding is half to even (rintf), each term's monomial is the left fold of
// its factors in feature order, `out` adds the terms in table order, and the
// isotonic map takes the last segment with pred >= x0 (a NaN prediction
// keeps y[0]).  The host drops zero-coefficient terms and x1 <= x0
// segments, as the Pallas kernel skips them.
//
// Bound and design.  23 bytes a pixel (12 of BGR and 2 of masks in, 8 of
// maps and 1 of support out), 61.5 MB at the 1608 x 1664 crop, ~18 us at
// 3.35 TB/s; the arithmetic (~75 operations of LAB, gray and chroma, then the
// models' products) is what the kernel spends, so the design cuts
// instructions and gives them parallelism:
// - each thread takes 4 consecutive pixels (three float4 loads of BGR, a
//   uchar4 of each mask, float4 and uchar4 stores; the last n % 4 pixels by
//   scalar accesses), so the transcendentals of 4 pixels are independent;
// - the models run a node program the host built (kernels/temp_kernel.py::
//   node_program): a term's left fold is its parent's (the term without its
//   last factor) times one factor, so each monomial costs one multiply from
//   an earlier one, with the same bits.  Nodes that later terms reuse stay in
//   shared memory, [slot][thread] as float4 (a warp touches distinct banks);
//   a chain's next node takes the last value from registers;
// - the calibrator's kept x0 are non-decreasing for an isotonic fit, so the
//   last segment with pred >= x0 is found by binary search (ceil(log2(n+1))
//   steps); a table the host finds out of order takes the backward scan,
//   both in this kernel.
// The model tables ride in the kernel's parameter space; the node programs
// and segments are one small device table read uniformly (L1).
#include <algorithm>

#include "common.cuh"

// the float32 rounding of a double constant, as the JAX kernel rounds its
// weak-typed Python floats (a float literal could round differently)
#define F32(x) ((float)(x))

constexpr int kMaxFeatures = 4;

// ModelHdr and TempParams are mirrored field for field by ctypes structures
// in kernels/temp_kernel.py.  steps_off / seg_off index the int32 table.
struct ModelHdr {
  float mean[kMaxFeatures];
  float scale[kMaxFeatures];
  float intercept;
  float iso_y0;
  int n_feat;
  int n_steps;
  int steps_off;
  int n_seg;
  int seg_off;
  int has_iso;
  int seg_sorted;
};

struct TempParams {
  ModelHdr wide;
  ModelHdr color;
  float chroma_min;
  int n_slots;
};

namespace {

constexpr int kThreads = 128;
// a node program step: code = src | dst << 8 | feat << 16 | term << 20, with
// src 0 = none, 1 = the previous step's value, 2 + k = slot k; dst 0 = none,
// 1 + k = slot k; feat 0 = none, 1 + f = times scaled feature f
constexpr int kSrcSlot = 2;

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

// OpenCV 8-bit (L, a, b) and gray of one pixel: feat = [L, a, b, gray]
__device__ __forceinline__ void lab_gray(float b, float g, float r, float (&feat)[4]) {
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
  feat[0] = clip255(rintf(L * F32(255.0 / 100.0)));
  feat[1] = clip255(rintf(A));
  feat[2] = clip255(rintf(B));
  feat[3] = rintf(F32(0.299) * r + F32(0.587) * g + F32(0.114) * b);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// out + c * v, lane by lane (two roundings)
__device__ __forceinline__ float4 axpy4(float4 out, float c, float4 v) {
  return make_float4(out.x + c * v.x, out.y + c * v.y, out.z + c * v.z, out.w + c * v.w);
}

__device__ __forceinline__ float4 pick(const float4 (&s)[kMaxFeatures], int f) {
  switch (f) {  // uniform across the warp: every thread runs the same step
    case 0: return s[0];
    case 1: return s[1];
    case 2: return s[2];
    default: return s[3];
  }
}

// The isotonic map of one prediction: the last segment (x0, y0, dx, dy)
// with pred >= x0, clipped to it; none (or a NaN prediction) keeps y[0].
__device__ __forceinline__ float iso_map(const ModelHdr& m, const float4* __restrict__ seg,
                                         float pred) {
  int idx = -1;
  if (m.seg_sorted) {
    if (pred == pred) {  // count of x0 <= pred: x0 non-decreasing
      int lo = 0, hi = m.n_seg;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(&seg[mid].x) <= pred) lo = mid + 1;
        else hi = mid;
      }
      idx = lo - 1;
    }
  } else {
    for (int i = m.n_seg - 1; i >= 0; --i) {
      if (pred >= __ldg(&seg[i].x)) {
        idx = i;
        break;
      }
    }
  }
  if (idx < 0) return m.iso_y0;
  const float4 q = __ldg(&seg[idx]);
  const float t = vt::jmin(vt::jmax((pred - q.x) / q.z, 0.0f), 1.0f);
  return q.y + t * q.w;
}

// One model on 4 pixels, feat[f] their features f: the scaled features,
// the node program, then the calibrator.  `slots` is this thread's first
// node slot; slot k is slots[k * kThreads].
__device__ __forceinline__ float4 eval_model(const ModelHdr& m, const int* __restrict__ tables,
                                             const float4 (&feat)[kMaxFeatures],
                                             float4* slots) {
  float4 s[kMaxFeatures];
#pragma unroll
  for (int f = 0; f < kMaxFeatures; ++f) {
    const float mu = f < m.n_feat ? m.mean[f] : 0.0f;
    const float sd = f < m.n_feat ? m.scale[f] : 1.0f;
    s[f] = make_float4((feat[f].x - mu) / sd, (feat[f].y - mu) / sd, (feat[f].z - mu) / sd,
                       (feat[f].w - mu) / sd);
  }
  float4 out = make_float4(m.intercept, m.intercept, m.intercept, m.intercept);
  float4 prev = out;
  const int2* steps = reinterpret_cast<const int2*>(tables + m.steps_off);
  for (int i = 0; i < m.n_steps; ++i) {
    const int2 e = __ldg(&steps[i]);
    const int src = e.x & 0xff, dst = (e.x >> 8) & 0xff, feat_f = (e.x >> 16) & 7;
    const float c = __int_as_float(e.y);
    float4 v = prev;
    if (src >= kSrcSlot) v = slots[(src - kSrcSlot) * kThreads];
    if (feat_f) v = src ? mul4(v, pick(s, feat_f - 1)) : pick(s, feat_f - 1);
    if (dst) slots[(dst - 1) * kThreads] = v;
    if ((e.x >> 20) & 1) {
      if (src || feat_f) out = axpy4(out, c, v);
      else out = make_float4(out.x + c, out.y + c, out.z + c, out.w + c);  // constant term
    }
    prev = v;
  }
  if (m.has_iso) {
    const float4* seg = reinterpret_cast<const float4*>(tables + m.seg_off);
    out = make_float4(iso_map(m, seg, out.x), iso_map(m, seg, out.y), iso_map(m, seg, out.z),
                      iso_map(m, seg, out.w));
  }
  return out;
}

__global__ void __launch_bounds__(kThreads)
fused_temp_kernel(const float* __restrict__ bgr, const uint8_t* __restrict__ roi_eff,
                  const uint8_t* __restrict__ csup_pre, float* __restrict__ wide_out,
                  float* __restrict__ color_out, uint8_t* __restrict__ csup_out, int n,
                  const __grid_constant__ TempParams p, const int* __restrict__ tables) {
  extern __shared__ float4 node_slots[];
  float4* slots = node_slots + threadIdx.x;
  const float nan = __int_as_float(0x7fc00000);
  const int nq = (n + 3) / 4;
  for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < nq; q += gridDim.x * blockDim.x) {
    const int i0 = 4 * q;
    const bool full = i0 + 4 <= n;
    float px[12];  // b, g, r of the 4 pixels
    uint8_t roi[4], cpre[4];
    if (full) {
      const float4* src = reinterpret_cast<const float4*>(bgr + 3 * (size_t)i0);
      const float4 x0 = __ldg(src), x1 = __ldg(src + 1), x2 = __ldg(src + 2);
      const float v[12] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w,
                           x2.x, x2.y, x2.z, x2.w};
#pragma unroll
      for (int k = 0; k < 12; ++k) px[k] = v[k];
      const uchar4 r4 = __ldg(reinterpret_cast<const uchar4*>(roi_eff + i0));
      const uchar4 c4 = __ldg(reinterpret_cast<const uchar4*>(csup_pre + i0));
      roi[0] = r4.x; roi[1] = r4.y; roi[2] = r4.z; roi[3] = r4.w;
      cpre[0] = c4.x; cpre[1] = c4.y; cpre[2] = c4.z; cpre[3] = c4.w;
    } else {  // the last n % 4 pixels; the missing lanes repeat the last one
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = min(i0 + k, n - 1);
        px[3 * k] = bgr[3 * (size_t)i];
        px[3 * k + 1] = bgr[3 * (size_t)i + 1];
        px[3 * k + 2] = bgr[3 * (size_t)i + 2];
        roi[k] = roi_eff[i];
        cpre[k] = csup_pre[i];
      }
    }
    float f[4][kMaxFeatures];
    bool cs[4];
    bool any_roi = false, any_cs = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lab_gray(px[3 * k], px[3 * k + 1], px[3 * k + 2], f[k]);
      const float da = f[k][1] - 128.0f;
      const float db = f[k][2] - 128.0f;
      const float chroma = sqrtf(da * da + db * db);
      cs[k] = cpre[k] && chroma >= p.chroma_min;
      any_roi = any_roi || roi[k];
      any_cs = any_cs || cs[k];
    }
    float4 feat[kMaxFeatures];
#pragma unroll
    for (int j = 0; j < kMaxFeatures; ++j)
      feat[j] = make_float4(f[0][j], f[1][j], f[2][j], f[3][j]);
    float4 wv = make_float4(nan, nan, nan, nan), cv = wv;
    if (any_roi) wv = eval_model(p.wide, tables, feat, slots);
    if (any_cs) cv = eval_model(p.color, tables, feat, slots);
    const float wo[4] = {roi[0] ? wv.x : nan, roi[1] ? wv.y : nan, roi[2] ? wv.z : nan,
                         roi[3] ? wv.w : nan};
    const float co[4] = {cs[0] ? cv.x : nan, cs[1] ? cv.y : nan, cs[2] ? cv.z : nan,
                         cs[3] ? cv.w : nan};
    if (full) {
      reinterpret_cast<float4*>(wide_out)[q] = make_float4(wo[0], wo[1], wo[2], wo[3]);
      reinterpret_cast<float4*>(color_out)[q] = make_float4(co[0], co[1], co[2], co[3]);
      reinterpret_cast<uchar4*>(csup_out)[q] = make_uchar4(cs[0], cs[1], cs[2], cs[3]);
    } else {
      for (int k = 0; i0 + k < n; ++k) {
        wide_out[i0 + k] = wo[k];
        color_out[i0 + k] = co[k];
        csup_out[i0 + k] = cs[k] ? 1 : 0;
      }
    }
  }
}

}  // namespace

// sizeof(TempParams), which the Python side checks against its ctypes mirror
extern "C" int vt_temp_params_size() { return (int)sizeof(TempParams); }

// bgr: (n, 3) float32, 16-byte aligned; roi_eff, csup_pre, csup_out: (n,)
// bool, 4-byte aligned; wide_out, color_out: (n,) float32, 16-byte aligned;
// params: host pointer to TempParams; tables: the int32 device table of both
// models' node programs ((code, coefficient bits) pairs) and segments
// ((x0, y0, dx, dy) float32, 16-byte aligned).
extern "C" int vt_fused_temperature(const float* bgr, const uint8_t* roi_eff,
                                    const uint8_t* csup_pre, float* wide_out,
                                    float* color_out, uint8_t* csup_out, int n,
                                    const TempParams* params, const int* tables,
                                    void* stream) {
  if (n < 1 || params == nullptr || tables == nullptr) return (int)cudaErrorInvalidValue;
  const ModelHdr* ms[2] = {&params->wide, &params->color};
  for (const ModelHdr* m : ms) {
    if (m->n_feat < 1 || m->n_feat > kMaxFeatures || m->n_steps < 0 || m->n_seg < 0 ||
        m->steps_off < 0 || m->seg_off % 4 != 0)
      return (int)cudaErrorInvalidValue;
  }
  const uintptr_t a16 = (uintptr_t)bgr | (uintptr_t)wide_out | (uintptr_t)color_out;
  const uintptr_t a4 = (uintptr_t)roi_eff | (uintptr_t)csup_pre | (uintptr_t)csup_out;
  if ((a16 & 15) != 0 || (a4 & 3) != 0 || ((uintptr_t)tables & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long smem = (long long)params->n_slots * kThreads * (long long)sizeof(float4);
  if (params->n_slots < 0 || smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_temp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long quads = ((long long)n + 3) / 4;
  const int blocks = (int)std::min<long long>((quads + kThreads - 1) / kThreads, 132LL * 16);
  fused_temp_kernel<<<blocks, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      bgr, roi_eff, csup_pre, wide_out, color_out, csup_out, n, *params, tables);
  return (int)cudaGetLastError();
}
