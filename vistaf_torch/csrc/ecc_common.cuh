// Shared ECC Gauss-Newton iteration core of K4 (ecc_gn_loop.cu) and K5
// (ecc_loop.cu), as the TPU kernels share pallas/ecc_kernel.py::warp_moment_rows:
// the two-pass shear warp of the [I, gx, gy, mask] stack (2K + 1 hat taps,
// zero border), the six masked moment rows [m, T m, I m, G_theta, gx m, gy m]
// whose 21 pair products are the moment matrix, and the Gauss-Newton update
// that follows each matrix (the two kernels differ only in its 3x3 solve).
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
// the TPU kernels' f32 order (kernels/ecc_kernel.py::shear_coeffs).
__device__ __forceinline__ ShearScalars shear_scalars(float theta, float tx, float ty) {
  const float c = cosf(theta), s = sinf(theta);
  const float r = s / c;
  return ShearScalars{r, c - r * (-s) - 1.0f, ty - r * tx, c - 1.0f, -s, tx, c, s};
}

// The vertical pass at (v, u) of all four planes at once (one hat weight a
// tap): sum_k P(v + k, u) * max(0, 1 - |disp_y - k|), zeros beyond the edge;
// at(vv) gives the four planes' samples at row vv, column u.
template <class At>
__device__ __forceinline__ float4 shear_vertical4(At at, int h, int K, const ShearScalars& sc,
                                                  int v, int u) {
  const float disp = (sc.cy_u * (float)u + sc.cy_v * (float)v) + sc.cy_c;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int k = -K; k <= K; ++k) {
    const int vv = v + k;
    if (vv < 0 || vv >= h) continue;  // zero border adds exactly nothing
    const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
    const float4 p = at(vv);
    a0 = a0 + p.x * wt;
    a1 = a1 + p.y * wt;
    a2 = a2 + p.z * wt;
    a3 = a3 + p.w * wt;
  }
  return make_float4(a0, a1, a2, a3);
}

// The same over the (4, h, w) stack S in global memory.
__device__ __forceinline__ float4 shear_vertical4(const float* __restrict__ S, int h, int w,
                                                  int K, const ShearScalars& sc, int v,
                                                  int u) {
  const size_t hw = (size_t)h * w;
  return shear_vertical4(
      [&](int vv) {
        const float* p = S + (size_t)vv * w + u;
        return make_float4(__ldg(p), __ldg(p + hw), __ldg(p + 2 * hw), __ldg(p + 3 * hw));
      },
      h, K, sc, v, u);
}

// The mask threshold and the six moment rows at (v, u) from the four warped
// samples a = [I, gx, gy, mask], the template value t and the statistics
// grid's value sm there.
__device__ __forceinline__ void moment_row(const float (&a)[4], float t, float sm,
                                           const ShearScalars& sc, int v, int u,
                                           float (&row)[6]) {
  const float fu = (float)u, fv = (float)v;
  const float mf = (a[3] > 0.95f ? 1.0f : 0.0f) * sm;
  const float gxm = a[1] * mf;
  const float gym = a[2] * mf;
  const float dwx = -sc.s * fu - sc.c * fv;
  const float dwy = sc.c * fu - sc.s * fv;
  row[0] = mf;
  row[1] = t * mf;
  row[2] = a[0] * mf;
  row[3] = gxm * dwx + gym * dwy;
  row[4] = gxm;
  row[5] = gym;
}

__device__ __forceinline__ void moment_row(const float (&a)[4], const float* __restrict__ T,
                                           const float* __restrict__ SM,
                                           const ShearScalars& sc, int pix, int v, int u,
                                           float (&row)[6]) {
  moment_row(a, T[pix], SM[pix], sc, v, u, row);
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

// mom[(i, j)] += row[i] * row[j] for the upper triangle i <= j, row-major.
__device__ __forceinline__ void accumulate_moments(const float (&row)[6],
                                                   float (&mom)[kEccMoments]) {
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) mom[q++] += row[i] * row[j];
}

// The state of the Gauss-Newton while loop (the JAX ecc_align's carry):
// every thread of every CTA of a solve holds the same bits.
struct GnState {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f;
  float last_rho = -2.f, rho = -1.f;
  float best_rho = -2.f, b0 = 0.f, b1 = 0.f, b2 = 0.f;
  int it = 0, stall = 0;
  bool failed = false;

  __device__ bool keep_going(int max_iters, float eps, int stall_patience) const {
    bool go = (it < max_iters) && (fabsf(rho - last_rho) >= eps) && !failed;
    if (stall_patience > 0) go = go && (stall < stall_patience);
    return go;
  }

  // with stall_patience, a stalled solve returns its best-rho iterate
  __device__ void finish(int stall_patience) {
    if (stall_patience > 0 && stall >= stall_patience) {
      p0 = b0;
      p1 = b1;
      p2 = b2;
      rho = best_rho;
    }
  }
};

// One Gauss-Newton update from the 21 upper-triangle moments M[(i, j)],
// i <= j < 6: solve(H, Gt, Gi, u, v) sets u = H^-1 Gt and v = H^-1 Gi for
// the regularized H = M[3:, 3:] + 1e-12 I (row-major 3x3); then the lambda
// step, rho, cv2's StsNoConv failure rule and the stall bookkeeping.
template <class Solve>
__device__ void gn_step(GnState& st, const float* mom, Solve solve) {
  float M[6][6];  // unrolled: every index is a constant, M stays in registers
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) {
      M[i][j] = mom[k++];
      M[j][i] = M[i][j];
    }

  const float n = jmax(M[0][0], 1.0f);
  const float stt = M[0][1], si = M[0][2];
  const float sg[3] = {M[0][3], M[0][4], M[0][5]};
  const float corr = M[1][2] - stt * si / n;
  const float tnorm2 = M[1][1] - stt * stt / n;
  const float inorm2 = M[2][2] - si * si / n;
  float Gt[3], Gi[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    Gt[q] = M[1][3 + q] - (stt / n) * sg[q];
    Gi[q] = M[2][3 + q] - (si / n) * sg[q];
  }
  const float reg = 1e-12f;
  float H[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) H[i][j] = i == j ? M[3 + i][3 + j] + reg : M[3 + i][3 + j];
  float u[3], v[3];
  solve(H, Gt, Gi, u, v);
  const float lam_num = inorm2 - (Gi[0] * v[0] + Gi[1] * v[1] + Gi[2] * v[2]);
  const float lam_den = corr - (Gt[0] * v[0] + Gt[1] * v[1] + Gt[2] * v[2]);
  const float lam = lam_num / (fabsf(lam_den) < 1e-12f ? 1e-12f : lam_den);
  const float dp0 = lam * u[0] - v[0];
  const float dp1 = lam * u[1] - v[1];
  const float dp2 = lam * u[2] - v[2];

  const float new_rho =
      corr / jmax(sqrtf(jmax(tnorm2, 0.0f) * jmax(inorm2, 0.0f)), 1e-12f);
  const bool now_failed = (lam_den <= 0.0f) || isnan(new_rho);
  const float q0 = now_failed ? st.p0 : st.p0 + dp0;
  const float q1 = now_failed ? st.p1 : st.p1 + dp1;
  const float q2 = now_failed ? st.p2 : st.p2 + dp2;
  const bool improved = new_rho > st.best_rho;
  if (improved) {
    st.best_rho = new_rho;
    st.b0 = st.p0;
    st.b1 = st.p1;
    st.b2 = st.p2;
  }
  st.stall = improved ? 0 : st.stall + 1;
  st.p0 = q0;
  st.p1 = q1;
  st.p2 = q2;
  st.last_rho = st.rho;
  st.rho = new_rho;
  st.it += 1;
  st.failed = st.failed || now_failed;
}

}  // namespace vt
