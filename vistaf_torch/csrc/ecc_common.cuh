// Shared ECC Gauss-Newton iteration core of K4 (ecc_moments.cu) and K5
// (ecc_loop.cu), as the TPU kernels share pallas/ecc_kernel.py::warp_moment_rows:
// the two-pass shear warp of the [I, gx, gy, mask] stack (2K + 1 hat taps,
// zero border) and the six masked moment rows
// [m, T m, I m, G_theta, gx m, gy m] whose 21 pair products are the
// moment matrix.
#pragma once

#include "common.cuh"

namespace vt {

constexpr int kEccMoments = 21;

// Scalars of the two shear passes and the rotation:
// vertical displacement cy_u*u + cy_v*v + cy_c, horizontal cx_u*u + cx_v*v + cx_c.
struct ShearScalars {
  float cy_u, cy_v, cy_c, cx_u, cx_v, cx_c, c, s;
};

// The shear decomposition of [[c, -s, tx], [s, c, ty]] (ops/warp.py), in
// the TPU kernels' f32 order.
__device__ __forceinline__ ShearScalars shear_scalars(float theta, float tx, float ty) {
  const float c = cosf(theta), s = sinf(theta);
  const float r = s / c;
  return ShearScalars{r, c - r * (-s) - 1.0f, ty - r * tx, c - 1.0f, -s, tx, c, s};
}

// Vertical pass at (v, u) of one (h, w) plane P:
// sum_k P(v + k, u) * max(0, 1 - |disp_y - k|), zeros beyond the edge.
__device__ __forceinline__ float shear_vertical(const float* __restrict__ P, int h, int w,
                                                int K, const ShearScalars& sc, int v,
                                                int u) {
  const float disp = (sc.cy_u * (float)u + sc.cy_v * (float)v) + sc.cy_c;
  float acc = 0.0f;
  for (int k = -K; k <= K; ++k) {
    const int vv = v + k;
    if (vv < 0 || vv >= h) continue;  // zero border adds exactly nothing
    const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
    acc = acc + P[vv * w + u] * wt;
  }
  return acc;
}

// The vertical pass at (v, u) of all four planes of the (4, h, w) stack S
// at once (one hat weight a tap): the same bits as shear_vertical per plane.
__device__ __forceinline__ float4 shear_vertical4(const float* __restrict__ S, int h, int w,
                                                  int K, const ShearScalars& sc, int v,
                                                  int u) {
  const size_t hw = (size_t)h * w;
  const float disp = (sc.cy_u * (float)u + sc.cy_v * (float)v) + sc.cy_c;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int k = -K; k <= K; ++k) {
    const int vv = v + k;
    if (vv < 0 || vv >= h) continue;
    const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
    const float* p = S + (size_t)vv * w + u;
    a0 = a0 + __ldg(p) * wt;
    a1 = a1 + __ldg(p + hw) * wt;
    a2 = a2 + __ldg(p + 2 * hw) * wt;
    a3 = a3 + __ldg(p + 3 * hw) * wt;
  }
  return make_float4(a0, a1, a2, a3);
}

// The mask threshold and the six moment rows at pixel `pix` = (v, u) from
// the four warped samples a = [I, gx, gy, mask].
__device__ __forceinline__ void moment_row(const float (&a)[4], const float* __restrict__ T,
                                           const float* __restrict__ SM,
                                           const ShearScalars& sc, int pix, int v, int u,
                                           float (&row)[6]) {
  const float fu = (float)u, fv = (float)v;
  const float mf = (a[3] > 0.95f ? 1.0f : 0.0f) * SM[pix];
  const float gxm = a[1] * mf;
  const float gym = a[2] * mf;
  const float dwx = -sc.s * fu - sc.c * fv;
  const float dwy = sc.c * fu - sc.s * fv;
  row[0] = mf;
  row[1] = T[pix] * mf;
  row[2] = a[0] * mf;
  row[3] = gxm * dwx + gym * dwy;
  row[4] = gxm;
  row[5] = gym;
}

// Horizontal pass at (v, u) of the four vertically sheared planes:
// a[ch] = sum_k mid_at(u + k)[ch] * max(0, 1 - |disp_x - k|), zeros beyond
// the edge; mid_at(uu) gives row v's four samples at column uu.
template <class MidAt>
__device__ __forceinline__ void shear_horizontal(MidAt mid_at, int w, int K,
                                                 const ShearScalars& sc, int v, int u,
                                                 float (&a)[4]) {
  const float disp = (sc.cx_u * (float)u + sc.cx_v * (float)v) + sc.cx_c;
  for (int k = -K; k <= K; ++k) {
    const int uu = u + k;
    if (uu < 0 || uu >= w) continue;
    const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
    const float4 m = mid_at(uu);
    a[0] = a[0] + m.x * wt;
    a[1] = a[1] + m.y * wt;
    a[2] = a[2] + m.z * wt;
    a[3] = a[3] + m.w * wt;
  }
}

// Horizontal pass of the four vertically sheared planes `mid` (4, h, w) at
// pixel `pix`, the mask threshold and the six moment rows.
__device__ __forceinline__ void shear_moment_row(const float* __restrict__ mid,
                                                 const float* __restrict__ T,
                                                 const float* __restrict__ SM, int h, int w,
                                                 int K, const ShearScalars& sc, int pix,
                                                 float (&row)[6]) {
  const int hw = h * w;
  const int v = pix / w, u = pix - v * w;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  shear_horizontal(
      [&](int uu) {
        const int o = v * w + uu;
        return make_float4(mid[o], mid[hw + o], mid[2 * hw + o], mid[3 * hw + o]);
      },
      w, K, sc, v, u, a);
  moment_row(a, T, SM, sc, pix, v, u, row);
}

// mom[(i, j)] += row[i] * row[j] for the upper triangle i <= j, row-major.
__device__ __forceinline__ void accumulate_moments(const float (&row)[6],
                                                   float (&mom)[kEccMoments]) {
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) mom[q++] += row[i] * row[j];
}

}  // namespace vt
