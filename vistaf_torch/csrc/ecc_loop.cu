// K5: the whole euclidean ECC Gauss-Newton solve, one launch of one
// thread-block cluster of kCtas = 16 CTAs.
//
// Replaces the JAX package's pallas/ecc_loop_kernel.py::ecc_loop_euclidean.  Each
// iteration of the device-side while loop:
//   1. every thread turns the warp (theta, tx, ty) into the two shear
//      passes' coefficients (the TPU kernel's scalars);
//   2. vertical shear pass of the 4 planes [I, gx, gy, mask] with 2K+1 hat
//      taps and a zero border, the CTA's row band into shared memory;
//   3. horizontal pass, mask threshold, steepest-descent rows and the 21
//      moment sums over the band, reduced in a fixed order (the warp and
//      rows are ecc_common.cuh, shared with K4);
//   4. one exchange: the CTAs' 21 sums through distributed shared memory,
//      combined in rank order, so every CTA holds the same bits;
//   5. every thread runs the scalar tail (two adjugate 3x3 solves, the
//      lambda step, rho, the StsNoConv failure rule, eps, stall bookkeeping)
//      on those bits, so all CTAs agree on whether to go on without a
//      broadcast.
// Output: [theta, tx, ty, rho, iters, failed]; identity/NaN handling on
// failure stays with the caller.
//
// Bound and design.  A solve is a few dense stencil passes per iteration
// (~4 M hat taps at 236^2) on a plane that never changes, and the
// iterations are sequential: what costs is the chain of plane-wide sums and
// the latency between them, not bytes (the inputs are 1.3 MB) nor
// arithmetic (~1 us at the FP32 peak for a whole solve), so the plane is
// spread over many SMs: it is split into row bands, one per CTA of a
// 16-CTA cluster (non-portable size: the attribute is set before launch).
// The vertical pass at (v, u) reads rows v-K..v+K of S from L1/L2; the
// horizontal pass at (v, u) reads only row v of the vertically sheared
// planes, so the band's `mid` lives in the CTA's shared memory (at most
// ceil(h / 16) * w * 16 bytes: ~57 KB at 236^2, 90 KB at 352x256, 180 KB for
// an 8-row plane at the budget's width) and never touches global memory.
// A cluster rather than a cooperative grid: its barrier is the hardware's
// and its exchange is 21 words of distributed shared memory, one per
// iteration, with double-buffered slots (a slot is rewritten two exchanges
// later, after every CTA has passed the barrier in between and so has read
// it).  The sums keep one fixed order (per-thread pixel order, the block
// reduction's, then rank order): rho's stop rule compares at one f32 ulp,
// and the same input gives the same bits on every call.
#include <cooperative_groups.h>

#include "ecc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCtas = 16;
constexpr int kMoments = vt::kEccMoments;
// dynamic shared memory a CTA may take: the 227 KB opt-in less the static part
constexpr int kMaxBandBytes = 232448 - 8192;

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

// Rows per CTA of an h-row plane.
int band_rows(int h) { return (h + kCtas - 1) / kCtas; }

// One solve, one cluster; CTA `rank` owns rows [rank * band, (rank + 1) * band).
__global__ void __launch_bounds__(kThreads)
ecc_loop_kernel(const float* __restrict__ S, const float* __restrict__ T,
                const float* __restrict__ SM, float* __restrict__ out, int h, int w, int K,
                int max_iters, float eps, int stall_patience, int band) {
  extern __shared__ float4 mid[];  // the band's vertically sheared [I, gx, gy, mask]
  __shared__ float red[kMoments * 33];
  __shared__ float slot[2][kMoments];
  __shared__ float tot[kMoments];

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int v0 = min(h, rank * band);
  const int rows = min(h, v0 + band) - v0;
  const int npix = rows * w;
  Solver st;  // every thread of every CTA holds the same state
  int par = 0;

  while (st.keep_going(max_iters, eps, stall_patience)) {
    const vt::ShearScalars sc = vt::shear_scalars(st.p0, st.p1, st.p2);
    for (int i = threadIdx.x; i < npix; i += kThreads) {
      const int dv = i / w, u = i - dv * w;
      mid[i] = vt::shear_vertical4(S, h, w, K, sc, v0 + dv, u);
    }
    __syncthreads();

    // horizontal pass + moment rows [m, T m, I m, G_theta, gx m, gy m]
    float mom[kMoments];
#pragma unroll
    for (int q = 0; q < kMoments; ++q) mom[q] = 0.0f;
    for (int i = threadIdx.x; i < npix; i += kThreads) {
      const int dv = i / w, u = i - dv * w;
      const int v = v0 + dv;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      vt::shear_horizontal([&](int uu) { return mid[dv * w + uu]; }, w, K, sc, v, u, a);
      float row[6];
      vt::moment_row(a, T, SM, sc, v * w + u, v, u, row);
      vt::accumulate_moments(row, mom);
    }
    // its barriers also keep `mid` from being rewritten while still read
    vt::block_reduce(mom, red, vt::SumOp(), 0.0f);

    // the exchange: every CTA sums the 16 CTAs' slots in rank order
    if (threadIdx.x < kMoments) slot[par][threadIdx.x] = mom[threadIdx.x];
    cl.sync();
    if (threadIdx.x < kMoments) {
      float s = cl.map_shared_rank(&slot[par][0], 0)[threadIdx.x];
      for (int r = 1; r < kCtas; ++r) s = s + cl.map_shared_rank(&slot[par][0], r)[threadIdx.x];
      tot[threadIdx.x] = s;
    }
    __syncthreads();
    par ^= 1;
    gn_step(st, tot);  // every thread, the same bits
  }

  if (stall_patience > 0 && st.stall >= stall_patience) {
    st.p0 = st.b0;
    st.p1 = st.b1;
    st.p2 = st.b2;
    st.rho = st.best_rho;
  }
  if (rank == 0 && threadIdx.x == 0) {
    out[0] = st.p0;
    out[1] = st.p1;
    out[2] = st.p2;
    out[3] = st.rho;
    out[4] = (float)st.it;
    out[5] = st.failed ? 1.0f : 0.0f;
  }
  cl.sync();  // no CTA leaves while another may still read its slots
}

}  // namespace

// S: (4, h, w) centred [I, gx, gy, mask01]; T, SM: (h, w); out: (6,).  One
// cluster launch on `stream`; a band that does not fit a CTA's shared memory
// (wider than ecc_loop_kernel.fits admits) is refused.
extern "C" int vt_ecc_loop_euclidean(const float* S, const float* T, const float* SM,
                                     float* out, int h, int w, int K, int max_iters,
                                     float eps, int stall_patience, void* stream) {
  if (h < 1 || w < 1 || K < 0 || max_iters < 0) return (int)cudaErrorInvalidValue;
  const int band = band_rows(h);
  const long long bytes = (long long)band * w * (long long)sizeof(float4);
  if (bytes > kMaxBandBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ecc_loop_kernel,
                                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ecc_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ecc_loop_kernel, S, T, SM, out, h, w, K, max_iters, eps,
                           stall_patience, band);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
