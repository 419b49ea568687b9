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
// failure stays with the caller.  A stack of B solves (jax.vmap of the
// solve) is one launch of B clusters, solve b on grid.y = b, each running its
// own loop to its own stop: the H100's GPCs hold about seven 16-CTA clusters
// at once, so a larger B runs in waves.
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

// x = H^-1 b for the symmetric (regularized) 3x3 H, by the adjugate
__device__ void solve3_adjugate(const float (&H)[3][3], const float (&b)[3], float (&x)[3]) {
  const float h00 = H[0][0], h01 = H[0][1], h02 = H[0][2];
  const float h11 = H[1][1], h12 = H[1][2], h22 = H[2][2];
  const float A00 = h11 * h22 - h12 * h12;
  const float A01 = h02 * h12 - h01 * h22;
  const float A02 = h01 * h12 - h02 * h11;
  const float A11 = h00 * h22 - h02 * h02;
  const float A12 = h01 * h02 - h00 * h12;
  const float A22 = h00 * h11 - h01 * h01;
  float det = h00 * A00 + h01 * A01 + h02 * A02;
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  x[0] = (A00 * b[0] + A01 * b[1] + A02 * b[2]) / det;
  x[1] = (A01 * b[0] + A11 * b[1] + A12 * b[2]) / det;
  x[2] = (A02 * b[0] + A12 * b[1] + A22 * b[2]) / det;
}

// The TPU loop kernel's tail: two adjugate solves
struct AdjugateSolve {
  __device__ void operator()(const float (&H)[3][3], const float (&Gt)[3],
                             const float (&Gi)[3], float (&u)[3], float (&v)[3]) const {
    solve3_adjugate(H, Gt, u);
    solve3_adjugate(H, Gi, v);
  }
};

// Rows per CTA of an h-row plane.
int band_rows(int h) { return (h + kCtas - 1) / kCtas; }

// One solve a cluster, solve blockIdx.y; CTA `rank` owns rows
// [rank * band, (rank + 1) * band).
__global__ void __launch_bounds__(kThreads)
ecc_loop_kernel(const float* __restrict__ S, const float* __restrict__ T,
                const float* __restrict__ SM, float* __restrict__ out, int h, int w, int K,
                int max_iters, float eps, int stall_patience, int band) {
  S += (size_t)blockIdx.y * 4 * h * w;
  T += (size_t)blockIdx.y * h * w;
  out += (size_t)blockIdx.y * 6;
  extern __shared__ float4 mid[];  // the band's vertically sheared [I, gx, gy, mask]
  __shared__ float red[kMoments * 33];
  __shared__ float slot[2][kMoments];
  __shared__ float tot[kMoments];

  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int v0 = min(h, rank * band);
  const int rows = min(h, v0 + band) - v0;
  const int npix = rows * w;
  vt::GnState st;  // every thread of every CTA holds the same state
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
    vt::gn_step(st, tot, AdjugateSolve());  // every thread, the same bits
  }

  st.finish(stall_patience);
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

// S: (solves, 4, h, w) centred [I, gx, gy, mask01]; T: (solves, h, w); SM:
// (h, w), shared; out: (solves, 6).  One launch of `solves` clusters on
// `stream`; a band that does not fit a CTA's shared memory (wider than
// ecc_loop_kernel.fits admits) is refused.
extern "C" int vt_ecc_loop_euclidean(const float* S, const float* T, const float* SM,
                                     float* out, int solves, int h, int w, int K,
                                     int max_iters, float eps, int stall_patience,
                                     void* stream) {
  if (h < 1 || w < 1 || K < 0 || max_iters < 0 || solves < 1 || solves > 65535)
    return (int)cudaErrorInvalidValue;
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
  cfg.gridDim = dim3(kCtas, solves, 1);
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
