// K5: the whole euclidean ECC Gauss-Newton solve, one CTA.
//
// Replaces the JAX package's pallas/ecc_loop_kernel.py::ecc_loop_euclidean.  Each
// iteration of the device-side while loop:
//   1. thread 0 turns the warp (theta, tx, ty) into the two shear passes'
//      coefficients (the TPU kernel's scalars) and broadcasts them;
//   2. vertical shear pass of the 4 planes [I, gx, gy, mask] with 2K+1 hat
//      taps and a zero border, into 4 scratch planes;
//   3. horizontal pass, mask threshold, steepest-descent rows and the 21
//      moment sums, accumulated per thread and reduced in a fixed order;
//   4. thread 0 runs the scalar tail (two adjugate 3x3 solves, the lambda
//      step, rho, the StsNoConv failure rule, eps, stall bookkeeping) and
//      broadcasts whether to go on.
// Output: [theta, tx, ty, rho, iters, failed]; identity/NaN handling on
// failure stays with the caller.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMoments = 21;

struct Solver {
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
};

// x = H^-1 b for the symmetric (regularized) 3x3 H, by the adjugate
__device__ void solve3_adjugate(float h00, float h01, float h02, float h11, float h12,
                                float h22, float b0, float b1, float b2, float* x) {
  const float A00 = h11 * h22 - h12 * h12;
  const float A01 = h02 * h12 - h01 * h22;
  const float A02 = h01 * h12 - h02 * h11;
  const float A11 = h00 * h22 - h02 * h02;
  const float A12 = h01 * h02 - h00 * h12;
  const float A22 = h00 * h11 - h01 * h01;
  float det = h00 * A00 + h01 * A01 + h02 * A02;
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  x[0] = (A00 * b0 + A01 * b1 + A02 * b2) / det;
  x[1] = (A01 * b0 + A11 * b1 + A12 * b2) / det;
  x[2] = (A02 * b0 + A12 * b1 + A22 * b2) / det;
}

// One GN update from the 21 upper-triangle moments M[(i, j)], i <= j < 6.
__device__ void gn_step(Solver& st, const float* mom) {
  float M[6][6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) M[i][j] = mom[k++];

  const float n = vt::jmax(M[0][0], 1.0f);
  const float stt = M[0][1], si = M[0][2];
  const float sg[3] = {M[0][3], M[0][4], M[0][5]};
  const float corr = M[1][2] - stt * si / n;
  const float tnorm2 = M[1][1] - stt * stt / n;
  const float inorm2 = M[2][2] - si * si / n;
  float Gt[3], Gi[3];
  for (int q = 0; q < 3; ++q) {
    Gt[q] = M[1][3 + q] - (stt / n) * sg[q];
    Gi[q] = M[2][3 + q] - (si / n) * sg[q];
  }
  const float reg = 1e-12f;
  const float h00 = M[3][3] + reg, h11 = M[4][4] + reg, h22 = M[5][5] + reg;
  const float h01 = M[3][4], h02 = M[3][5], h12 = M[4][5];
  float u[3], v[3];
  solve3_adjugate(h00, h01, h02, h11, h12, h22, Gt[0], Gt[1], Gt[2], u);
  solve3_adjugate(h00, h01, h02, h11, h12, h22, Gi[0], Gi[1], Gi[2], v);
  const float lam_num = inorm2 - (Gi[0] * v[0] + Gi[1] * v[1] + Gi[2] * v[2]);
  const float lam_den = corr - (Gt[0] * v[0] + Gt[1] * v[1] + Gt[2] * v[2]);
  const float lam = lam_num / (fabsf(lam_den) < 1e-12f ? 1e-12f : lam_den);
  const float dp0 = lam * u[0] - v[0];
  const float dp1 = lam * u[1] - v[1];
  const float dp2 = lam * u[2] - v[2];

  const float new_rho =
      corr / vt::jmax(sqrtf(vt::jmax(tnorm2, 0.0f) * vt::jmax(inorm2, 0.0f)), 1e-12f);
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

__global__ void __launch_bounds__(kThreads)
ecc_loop_kernel(const float* __restrict__ S, const float* __restrict__ T,
                const float* __restrict__ SM, float* __restrict__ mid,
                float* __restrict__ out, int h, int w, int K, int max_iters, float eps,
                int stall_patience) {
  __shared__ float red[kMoments * 33];
  __shared__ float sc[8];
  __shared__ int go;
  const int hw = h * w;
  Solver st;  // meaningful in thread 0 only

  if (threadIdx.x == 0) go = st.keep_going(max_iters, eps, stall_patience);
  __syncthreads();
  while (go) {
    if (threadIdx.x == 0) {
      const float c = cosf(st.p0), s = sinf(st.p0);
      // shear decomposition of [[c, -s, tx], [s, c, ty]] (ops/warp.py)
      const float r = s / c;
      sc[0] = r;
      sc[1] = c - r * (-s) - 1.0f;
      sc[2] = st.p2 - r * st.p1;
      sc[3] = c - 1.0f;
      sc[4] = -s;
      sc[5] = st.p1;
      sc[6] = c;
      sc[7] = s;
    }
    __syncthreads();
    const float cy_u = sc[0], cy_v = sc[1], cy_c = sc[2];
    const float cx_u = sc[3], cx_v = sc[4], cx_c = sc[5];
    const float c = sc[6], s = sc[7];

    // vertical pass: mid(v, u) = sum_k S(v + k, u) * hat(disp_y - k)
    for (int idx = threadIdx.x; idx < 4 * hw; idx += blockDim.x) {
      const int ch = idx / hw;
      const int pix = idx - ch * hw;
      const int v = pix / w, u = pix - v * w;
      const float* P = S + (size_t)ch * hw;
      const float disp = (cy_u * (float)u + cy_v * (float)v) + cy_c;
      float acc = 0.0f;
      for (int k = -K; k <= K; ++k) {
        const int vv = v + k;
        if (vv < 0 || vv >= h) continue;  // zero border adds exactly nothing
        const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
        acc = acc + P[vv * w + u] * wt;
      }
      mid[idx] = acc;
    }
    __syncthreads();

    // horizontal pass + moment rows [m, T m, I m, G_theta, gx m, gy m]
    float mom[kMoments];
#pragma unroll
    for (int q = 0; q < kMoments; ++q) mom[q] = 0.0f;
    for (int pix = threadIdx.x; pix < hw; pix += blockDim.x) {
      const int v = pix / w, u = pix - v * w;
      const float fu = (float)u, fv = (float)v;
      const float disp = (cx_u * fu + cx_v * fv) + cx_c;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = -K; k <= K; ++k) {
        const int uu = u + k;
        if (uu < 0 || uu >= w) continue;
        const float wt = fmaxf(0.0f, 1.0f - fabsf(disp - (float)k));
        const int o = v * w + uu;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) a[ch] = a[ch] + mid[(size_t)ch * hw + o] * wt;
      }
      const float mf = (a[3] > 0.95f ? 1.0f : 0.0f) * SM[pix];
      const float gxm = a[1] * mf;
      const float gym = a[2] * mf;
      const float dwx = -s * fu - c * fv;
      const float dwy = c * fu - s * fv;
      const float row[6] = {mf, T[pix] * mf, a[0] * mf, gxm * dwx + gym * dwy, gxm, gym};
      int q = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j) mom[q++] += row[i] * row[j];
    }
    vt::block_reduce(mom, red, vt::SumOp(), 0.0f);

    if (threadIdx.x == 0) {
      gn_step(st, mom);
      go = st.keep_going(max_iters, eps, stall_patience);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    if (stall_patience > 0 && st.stall >= stall_patience) {
      st.p0 = st.b0;
      st.p1 = st.b1;
      st.p2 = st.b2;
      st.rho = st.best_rho;
    }
    out[0] = st.p0;
    out[1] = st.p1;
    out[2] = st.p2;
    out[3] = st.rho;
    out[4] = (float)st.it;
    out[5] = st.failed ? 1.0f : 0.0f;
  }
}

}  // namespace

// S: (4, h, w) centred [I, gx, gy, mask01]; T, SM: (h, w); mid: (4, h, w)
// scratch; out: (6,).
extern "C" int vt_ecc_loop_euclidean(const float* S, const float* T, const float* SM,
                                     float* mid, float* out, int h, int w, int K,
                                     int max_iters, float eps, int stall_patience,
                                     void* stream) {
  if (h < 1 || w < 1 || K < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  ecc_loop_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(S, T, SM, mid, out, h, w, K,
                                                           max_iters, eps, stall_patience);
  return (int)cudaGetLastError();
}
