// K4: one ECC Gauss-Newton iteration's (6, 6) moment matrix, multi-CTA.
//
// Replaces the JAX package's pallas/ecc_kernel.py::gn_moments_euclidean.  The
// input is the 8 shear-pass scalars [cy_u, cy_v, cy_c, cx_u, cx_v, cx_c,
// cos, sin] of the current warp, on the device; the warp and moment rows
// are ecc_common.cuh, shared with K5's whole-solve loop.  Three launches:
//   1. vertical shear pass of the 4 planes [I, gx, gy, mask] into `mid`,
//      one thread per (plane, pixel);
//   2. horizontal pass, moment rows and the 21 moment sums, each CTA over a
//      fixed grid-stride share of the pixels, reduced in a fixed order into
//      one partial row per CTA;
//   3. one CTA sums the partials in CTA order and writes the symmetric
//      (6, 6) matrix.
// No atomics: the partition depends on the shape only, so the sums are the
// same bits on every run (the ECC stopping rule compares rho at the level
// of one f32 ulp).
//
// Bound: at the native-4K coarse grid (295 x 295, K = 4) one iteration is
// ~3.1 M hat taps per pass and 87 k moment rows; spread over ~260 CTAs it
// is launch- and latency-bound (a few microseconds of work), so the design
// keeps every intermediate in L2 and adds no host synchronisation.
#include "ecc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 264;  // two waves of CTAs on 132 SMs
constexpr int kMoments = vt::kEccMoments;

__device__ __forceinline__ vt::ShearScalars load_scalars(const float* __restrict__ co) {
  return vt::ShearScalars{co[0], co[1], co[2], co[3], co[4], co[5], co[6], co[7]};
}

__global__ void __launch_bounds__(kThreads)
vertical_kernel(const float* __restrict__ S, const float* __restrict__ co,
                float* __restrict__ mid, int h, int w, int K) {
  const int hw = h * w;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * hw) return;
  const vt::ShearScalars sc = load_scalars(co);
  const int ch = idx / hw;
  const int pix = idx - ch * hw;
  const int v = pix / w, u = pix - v * w;
  mid[idx] = vt::shear_vertical(S + (size_t)ch * hw, h, w, K, sc, v, u);
}

__global__ void __launch_bounds__(kThreads)
moments_partial_kernel(const float* __restrict__ mid, const float* __restrict__ T,
                       const float* __restrict__ SM, const float* __restrict__ co,
                       float* __restrict__ partials, int h, int w, int K) {
  __shared__ float red[kMoments * 33];
  const vt::ShearScalars sc = load_scalars(co);
  const int hw = h * w;
  float mom[kMoments];
#pragma unroll
  for (int q = 0; q < kMoments; ++q) mom[q] = 0.0f;
  for (int pix = blockIdx.x * blockDim.x + threadIdx.x; pix < hw;
       pix += gridDim.x * blockDim.x) {
    float row[6];
    vt::shear_moment_row(mid, T, SM, h, w, K, sc, pix, row);
    vt::accumulate_moments(row, mom);
  }
  vt::block_reduce(mom, red, vt::SumOp(), 0.0f);
  if (threadIdx.x < kMoments) partials[blockIdx.x * kMoments + threadIdx.x] = mom[threadIdx.x];
}

__global__ void moments_final_kernel(const float* __restrict__ partials, int nblk,
                                     float* __restrict__ out) {
  const int q = threadIdx.x;
  if (q >= kMoments) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s = s + partials[b * kMoments + q];
  // upper-triangle index q -> (i, j), mirrored into the full matrix
  int i = 0, rest = q;
  while (rest >= 6 - i) {
    rest -= 6 - i;
    ++i;
  }
  const int j = i + rest;
  out[i * 6 + j] = s;
  out[j * 6 + i] = s;
}

}  // namespace

// Number of CTAs of the partial-sum pass for an (h, w) plane; the wrapper
// allocates `partials` as (blocks, 21).
extern "C" int vt_gn_moments_blocks(int h, int w) {
  const int need = (h * w + kThreads - 1) / kThreads;
  return need < kMaxBlocks ? need : kMaxBlocks;
}

// S: (4, h, w) centred [I, gx, gy, mask01]; T, SM: (h, w); coeffs: (8,);
// mid: (4, h, w) scratch; partials: (vt_gn_moments_blocks(h, w), 21)
// scratch; out: (6, 6).
extern "C" int vt_gn_moments_euclidean(const float* S, const float* T, const float* SM,
                                       const float* coeffs, float* mid, float* partials,
                                       float* out, int h, int w, int K, void* stream) {
  if (h < 1 || w < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int hw = h * w;
  vertical_kernel<<<(4 * hw + kThreads - 1) / kThreads, kThreads, 0, st>>>(S, coeffs, mid,
                                                                         h, w, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nblk = vt_gn_moments_blocks(h, w);
  moments_partial_kernel<<<nblk, kThreads, 0, st>>>(mid, T, SM, coeffs, partials, h, w, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moments_final_kernel<<<1, 32, 0, st>>>(partials, nblk, out);
  return (int)cudaGetLastError();
}
