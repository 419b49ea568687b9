// K6: the whole weighted-least-squares phase unwrap, multi-CTA.
//
// Replaces the JAX package's pallas/unwrap_kernel.py::unwrap_wls_pallas.  On the
// tile-padded (Hp, Wp) domain (zero weights in the padding): binary edge
// weights, wrapped gradients in the real form x - 2pi*round(x/2pi),
// divergence, then a fixed trip of `cg_iters` PCG steps with the
// DCT-Poisson preconditioner, each step applied only while
// sum(r*r) > tol^2 * sum(r0*r0) (the TPU kernel's `live` mask), then the
// two-pass gauge on the masked mean and the congruence step
// psi + 2pi*round((phi - psi)/2pi); NaN off the mask.
//
// Bound: the preconditioner is four dense DCT products per application
// (Dh r, . Dw^T, Dh^T ., . Dw): ~122 MFLOP at 240 x 256, 17 applications
// per solve, about 2.1 GFLOP.  One CTA would take milliseconds, so the
// solve is a sequence of multi-CTA launches on one stream: a tiled FP32
// FMA matrix product (32 x 32 tiles through shared memory, no tensor
// cores, no TF32) for each product, stencil/update kernels over the plane,
// and per-CTA partial sums reduced in a fixed order by one warp, which also
// forms alpha, beta and the `live` flag in device memory.  The host
// enqueues the whole solve in one call and never waits on it.  No atomics:
// every sum has a fixed order, so the trip is reproducible.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRedBlocks = 120;  // CTAs of every reduction pass
constexpr int kTile = 32;        // matrix-product tile (kTile x kTile outputs)
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;

// scalar slots in device memory
enum Slot { kRz = 0, kTol2R0, kAlpha, kBeta, kLive, kN, kS1, kS2, kSlots };

// a[v + k] along columns (axis 1) / rows (axis 0), 0 beyond the edge
__device__ __forceinline__ float at_or0(const float* __restrict__ a, int Hp, int Wp, int i,
                                        int j) {
  return (i >= 0 && i < Hp && j >= 0 && j < Wp) ? a[i * Wp + j] : 0.0f;
}

__device__ __forceinline__ float wrap(float x) { return x - kTwoPi * rintf(x * kInvTwoPi); }

// divergence of edge fluxes at (i, j): (fx - fx[j-1]) + (fy - fy[i-1])
template <class Fx, class Fy>
__device__ __forceinline__ float div2(Fx fx, Fy fy, int i, int j) {
  const float fx0 = fx(i, j);
  const float fx1 = j > 0 ? fx(i, j - 1) : 0.0f;
  const float fy0 = fy(i, j);
  const float fy1 = i > 0 ? fy(i - 1, j) : 0.0f;
  return (fx0 - fx1) + (fy0 - fy1);
}

// wx = m * m[., j+1], wy = m * m[i+1, .]; r = div2(wrap(dpsi) * w); phi = 0
__global__ void __launch_bounds__(kThreads)
setup_kernel(const float* __restrict__ psi, const float* __restrict__ m,
             float* __restrict__ wx, float* __restrict__ wy, float* __restrict__ phi,
             float* __restrict__ r, int Hp, int Wp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= Hp * Wp) return;
  const int i = idx / Wp, j = idx - i * Wp;
  auto wxa = [&](int a, int b) { return m[a * Wp + b] * at_or0(m, Hp, Wp, a, b + 1); };
  auto wya = [&](int a, int b) { return m[a * Wp + b] * at_or0(m, Hp, Wp, a + 1, b); };
  auto dx = [&](int a, int b) {
    return wrap(at_or0(psi, Hp, Wp, a, b + 1) - psi[a * Wp + b]) * wxa(a, b);
  };
  auto dy = [&](int a, int b) {
    return wrap(at_or0(psi, Hp, Wp, a + 1, b) - psi[a * Wp + b]) * wya(a, b);
  };
  wx[idx] = wxa(i, j);
  wy[idx] = wya(i, j);
  r[idx] = div2(dx, dy, i, j);
  phi[idx] = 0.0f;
}

// C = A (M x K) @ B (K x N), row-major; C *= S elementwise when S is given.
// Skipped entirely while the solve is no longer live.
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ S, float* __restrict__ C, int M, int N, int K,
              const float* __restrict__ live) {
  if (live != nullptr && !(*live > 0.5f)) return;
  __shared__ float As[kTile][kTile + 1];  // As[k][m]
  __shared__ float Bs[kTile][kTile + 1];  // Bs[k][n]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < K; k0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int a = e / kTile, b = e - a * kTile;  // a: row of the tile, b: column
      const int am = m0 + a, ak = k0 + b;
      As[b][a] = (am < M && ak < K) ? A[(size_t)am * K + ak] : 0.0f;
      const int bk = k0 + a, bn = n0 + b;
      Bs[a][b] = (bk < K && bn < N) ? B[(size_t)bk * N + bn] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a0 = As[kk][ty], a1 = As[kk][ty + 16];
      const float b0 = Bs[kk][tx], b1 = Bs[kk][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int row = m0 + ty + 16 * a, col = n0 + tx + 16 * b;
      if (row < M && col < N) {
        const size_t o = (size_t)row * N + col;
        C[o] = S != nullptr ? acc[a][b] * S[o] : acc[a][b];
      }
    }
}

// per-CTA partial sums of two products over the plane: part[b] = (sum x0*y0, sum x1*y1)
template <class F>
__device__ __forceinline__ void partial_pair(F term, int n, float* __restrict__ part) {
  __shared__ float red[2 * 33];
  float v[2] = {0.0f, 0.0f};
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x)
    term(idx, v);
  vt::block_reduce(v, red, vt::SumOp(), 0.0f);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = v[0];
    part[2 * blockIdx.x + 1] = v[1];
  }
}

// Total of one slot of the per-CTA partials, called by all 32 lanes of a
// one-warp launch: lane l sums CTAs l, l + 32, ... in order, then a warp
// butterfly (a fixed order; every lane returns the same bits).
__device__ __forceinline__ float total(const float* __restrict__ part, int slot) {
  float s = 0.0f;
  for (int b = threadIdx.x; b < kRedBlocks; b += 32) s = s + part[2 * b + slot];
  return vt::warp_reduce(s, vt::SumOp());
}

// z = precond(r); p = z; partials of (r z, r r)
__global__ void __launch_bounds__(kThreads)
init_partials_kernel(const float* __restrict__ r, const float* __restrict__ z,
                     float* __restrict__ p, float* __restrict__ part, int n) {
  partial_pair(
      [&](int idx, float* v) {
        p[idx] = z[idx];
        v[0] = v[0] + r[idx] * z[idx];
        v[1] = v[1] + r[idx] * r[idx];
      },
      n, part);
}

__global__ void init_scalars_kernel(const float* __restrict__ part, float tol2,
                                    float* __restrict__ sc) {
  const float rz = total(part, 0);
  const float r0n = total(part, 1);
  if (threadIdx.x != 0) return;
  sc[kRz] = rz;
  sc[kTol2R0] = tol2 * r0n;
  sc[kLive] = 1.0f;
}

// Ap = wlap(p); partials of (r r, p Ap)
__global__ void __launch_bounds__(kThreads)
wlap_partials_kernel(const float* __restrict__ p, const float* __restrict__ wx,
                     const float* __restrict__ wy, const float* __restrict__ r,
                     float* __restrict__ Ap, float* __restrict__ part, int Hp, int Wp) {
  auto fx = [&](int a, int b) {
    return wx[a * Wp + b] * (at_or0(p, Hp, Wp, a, b + 1) - p[a * Wp + b]);
  };
  auto fy = [&](int a, int b) {
    return wy[a * Wp + b] * (at_or0(p, Hp, Wp, a + 1, b) - p[a * Wp + b]);
  };
  partial_pair(
      [&](int idx, float* v) {
        const int i = idx / Wp, j = idx - i * Wp;
        const float ap = div2(fx, fy, i, j);
        Ap[idx] = ap;
        v[0] = v[0] + r[idx] * r[idx];
        v[1] = v[1] + p[idx] * ap;
      },
      Hp * Wp, part);
}

// live = rr > tol^2 r0r0 (the loop entry condition); alpha = rz / pAp
__global__ void alpha_kernel(const float* __restrict__ part, float* __restrict__ sc) {
  const float rr = total(part, 0);
  const float pAp = total(part, 1);
  if (threadIdx.x != 0) return;
  sc[kLive] = rr > sc[kTol2R0] ? 1.0f : 0.0f;
  sc[kAlpha] = sc[kRz] / (fabsf(pAp) < 1e-30f ? 1e-30f : pAp);
}

// while live: phi += alpha p; r -= alpha Ap
__global__ void __launch_bounds__(kThreads)
update_kernel(float* __restrict__ phi, float* __restrict__ r, const float* __restrict__ p,
              const float* __restrict__ Ap, const float* __restrict__ sc, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n || !(sc[kLive] > 0.5f)) return;
  const float alpha = sc[kAlpha];
  phi[idx] = phi[idx] + alpha * p[idx];
  r[idx] = r[idx] - alpha * Ap[idx];
}

// partials of (r z, 0)
__global__ void __launch_bounds__(kThreads)
rz_partials_kernel(const float* __restrict__ r, const float* __restrict__ z,
                   const float* __restrict__ sc, float* __restrict__ part, int n) {
  if (!(sc[kLive] > 0.5f)) return;
  partial_pair([&](int idx, float* v) { v[0] = v[0] + r[idx] * z[idx]; }, n, part);
}

// beta = rz_new / rz; rz = rz_new (while live)
__global__ void beta_kernel(const float* __restrict__ part, float* __restrict__ sc) {
  if (!(sc[kLive] > 0.5f)) return;  // uniform over the warp
  const float rz2 = total(part, 0);
  if (threadIdx.x != 0) return;
  const float rz = sc[kRz];
  sc[kBeta] = rz2 / (fabsf(rz) < 1e-30f ? 1e-30f : rz);
  sc[kRz] = rz2;
}

// while live: p = z + beta p
__global__ void __launch_bounds__(kThreads)
direction_kernel(float* __restrict__ p, const float* __restrict__ z,
                 const float* __restrict__ sc, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n || !(sc[kLive] > 0.5f)) return;
  p[idx] = z[idx] + sc[kBeta] * p[idx];
}

// gauge, pass 1: partials of (m, (psi - phi) m)
__global__ void __launch_bounds__(kThreads)
gauge1_partials_kernel(const float* __restrict__ psi, const float* __restrict__ phi,
                       const float* __restrict__ m, float* __restrict__ part, int n) {
  partial_pair(
      [&](int idx, float* v) {
        v[0] = v[0] + m[idx];
        v[1] = v[1] + (psi[idx] - phi[idx]) * m[idx];
      },
      n, part);
}

__global__ void gauge1_kernel(const float* __restrict__ part, float* __restrict__ sc) {
  const float n = vt::jmax(total(part, 0), 1.0f);
  const float dm = total(part, 1);
  if (threadIdx.x != 0) return;
  sc[kN] = n;
  sc[kS1] = dm / n;
}

// gauge, pass 2: partials of ((psi - phi - s1) m, 0)
__global__ void __launch_bounds__(kThreads)
gauge2_partials_kernel(const float* __restrict__ psi, const float* __restrict__ phi,
                       const float* __restrict__ m, const float* __restrict__ sc,
                       float* __restrict__ part, int n) {
  const float s1 = sc[kS1];
  partial_pair(
      [&](int idx, float* v) { v[0] = v[0] + ((psi[idx] - phi[idx]) - s1) * m[idx]; }, n,
      part);
}

__global__ void gauge2_kernel(const float* __restrict__ part, float* __restrict__ sc) {
  const float s = total(part, 0);
  if (threadIdx.x != 0) return;
  sc[kS2] = s / sc[kN];
}

// phi = (phi + s1) + s2, congruence, crop to (h, w), NaN off the mask
__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ psi, const float* __restrict__ phi,
              const uint8_t* __restrict__ mask, const float* __restrict__ sc,
              float* __restrict__ out, int h, int w, int Wp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= h * w) return;
  const int i = idx / w, j = idx - i * w;
  const int o = i * Wp + j;
  const float g = (phi[o] + sc[kS1]) + sc[kS2];
  const float k = rintf((g - psi[o]) * kInvTwoPi);
  out[idx] = mask[idx] ? psi[o] + kTwoPi * k : __int_as_float(0x7fc00000);
}

struct Solve {
  const float *Dh, *DhT, *Dw, *DwT, *inv_denom;
  float *t1, *t2;
  int Hp, Wp;
  cudaStream_t st;

  // z = Dh^T ((Dh r Dw^T) * inv_denom) Dw
  cudaError_t precond(const float* r, float* z, const float* live) const {
    const dim3 blk(kThreads);
    const dim3 g_hw((Wp + kTile - 1) / kTile, (Hp + kTile - 1) / kTile);
    matmul_kernel<<<g_hw, blk, 0, st>>>(Dh, r, nullptr, t1, Hp, Wp, Hp, live);
    matmul_kernel<<<g_hw, blk, 0, st>>>(t1, DwT, inv_denom, t2, Hp, Wp, Wp, live);
    matmul_kernel<<<g_hw, blk, 0, st>>>(DhT, t2, nullptr, t1, Hp, Wp, Hp, live);
    matmul_kernel<<<g_hw, blk, 0, st>>>(t1, Dw, nullptr, z, Hp, Wp, Wp, live);
    return cudaGetLastError();
  }
};

}  // namespace

// Float elements of the scratch `work` for a padded (Hp, Wp) solve.
extern "C" int vt_unwrap_work_elems(int Hp, int Wp) {
  return 9 * Hp * Wp + 2 * kRedBlocks + kSlots;
}

// psi, m: (Hp, Wp) masked wrapped phase and 0/1 mask, zero-padded; Dh, DhT:
// (Hp, Hp) and Dw, DwT: (Wp, Wp) orthonormal DCT-II matrices and their
// transposes; inv_denom: (Hp, Wp); mask: (h, w) bool; out: (h, w);
// work: vt_unwrap_work_elems(Hp, Wp) floats; tol2 = tol * tol.
extern "C" int vt_unwrap_wls(const float* psi, const float* m, const float* Dh,
                             const float* DhT, const float* Dw, const float* DwT,
                             const float* inv_denom, const uint8_t* mask, float* out,
                             float* work, int h, int w, int Hp, int Wp, int cg_iters,
                             float tol2, void* stream) {
  if (h < 1 || w < 1 || Hp < h || Wp < w || cg_iters < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = Hp * Wp;
  float* wx = work;
  float* wy = wx + n;
  float* phi = wy + n;
  float* r = phi + n;
  float* p = r + n;
  float* z = p + n;
  float* Ap = z + n;
  float* t1 = Ap + n;
  float* t2 = t1 + n;
  float* part = t2 + n;
  float* sc = part + 2 * kRedBlocks;
  const int g_n = (n + kThreads - 1) / kThreads;
  const Solve solve{Dh, DhT, Dw, DwT, inv_denom, t1, t2, Hp, Wp, st};
  cudaError_t err;
#define VT_CHECK()                                \
  do {                                            \
    err = cudaGetLastError();                     \
    if (err != cudaSuccess) return (int)err;      \
  } while (0)

  setup_kernel<<<g_n, kThreads, 0, st>>>(psi, m, wx, wy, phi, r, Hp, Wp);
  VT_CHECK();
  if ((err = solve.precond(r, z, nullptr)) != cudaSuccess) return (int)err;
  init_partials_kernel<<<kRedBlocks, kThreads, 0, st>>>(r, z, p, part, n);
  init_scalars_kernel<<<1, 32, 0, st>>>(part, tol2, sc);
  VT_CHECK();
  const float* live = sc + kLive;
  for (int it = 0; it < cg_iters; ++it) {
    wlap_partials_kernel<<<kRedBlocks, kThreads, 0, st>>>(p, wx, wy, r, Ap, part, Hp, Wp);
    alpha_kernel<<<1, 32, 0, st>>>(part, sc);
    update_kernel<<<g_n, kThreads, 0, st>>>(phi, r, p, Ap, sc, n);
    VT_CHECK();
    if ((err = solve.precond(r, z, live)) != cudaSuccess) return (int)err;
    rz_partials_kernel<<<kRedBlocks, kThreads, 0, st>>>(r, z, sc, part, n);
    beta_kernel<<<1, 32, 0, st>>>(part, sc);
    direction_kernel<<<g_n, kThreads, 0, st>>>(p, z, sc, n);
    VT_CHECK();
  }
  gauge1_partials_kernel<<<kRedBlocks, kThreads, 0, st>>>(psi, phi, m, part, n);
  gauge1_kernel<<<1, 32, 0, st>>>(part, sc);
  gauge2_partials_kernel<<<kRedBlocks, kThreads, 0, st>>>(psi, phi, m, sc, part, n);
  gauge2_kernel<<<1, 32, 0, st>>>(part, sc);
  finish_kernel<<<(h * w + kThreads - 1) / kThreads, kThreads, 0, st>>>(psi, phi, mask, sc,
                                                                      out, h, w, Wp);
  VT_CHECK();
#undef VT_CHECK
  return 0;
}
