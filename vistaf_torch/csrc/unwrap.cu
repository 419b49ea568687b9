// K6: the whole weighted-least-squares phase unwrap, one persistent
// cooperative launch.
//
// Replaces the JAX package's pallas/unwrap_kernel.py::unwrap_wls_pallas.  On the
// tile-padded (Hp, Wp) domain (zero weights in the padding): binary edge
// weights, wrapped gradients in the real form x - 2pi*round(x/2pi),
// divergence, then up to `cg_iters` PCG steps with the DCT-Poisson
// preconditioner Dh^T ((Dh r Dw^T) * inv_denom) Dw, each step taken only
// while sum(r*r) > tol^2 * sum(r0*r0) (the TPU kernel's `live` mask: once it
// is false the state never changes again, so the loop ends there), then the
// two-pass gauge on the masked mean and the congruence step
// psi + 2pi*round((phi - psi)/2pi); NaN off the mask.
//
// Bound and design.  The preconditioner is four dense DCT products per
// application, ~122 MFLOP at 240 x 256 and 17 applications a solve (about
// 2.1 GFLOP, 31 us at the FP32 peak), on a state of 11 planes and the four
// matrices (~4 MB at 240 x 256, ~11 MB at 448 x 384) that stays in L2.  Each
// product is small (~15 M FMA), so what costs is the chain of dependent
// phases and the gaps between them, not bandwidth.  One cooperative launch
// of one 512-thread CTA per SM runs the
// whole solve, its phases separated by grid barriers (cooperative groups;
// the launch guarantees co-residency and fails with its CUDA error if the
// grid cannot be resident).  A PCG step is five phases:
//   a. t1 = Dh r', with r' = r - alpha Ap formed as the product's operand;
//      the tile's owner also stores r' and phi += alpha p (alpha from the
//      last phase's partials);
//   b. t2 = (t1 Dw^T) * inv_denom;   c. t1 = Dh^T t2;
//   d. z = t1 Dw, with the (r' z, r' r') partials;
//   e. beta from them; p' = z + beta p; Ap = wlap(p') with p' formed at the
//      stencil's neighbours; the (p' Ap) partials.
// Products tile the (Hp, Wp) output in 16 x 32 tiles (120 tiles at
// 240 x 256, 336 at 448 x 384), each staged whole-K in shared memory and
// computed by eight split-K groups of 64 threads with 2 x 4 FP32 FMA
// register tiles (explicit fmaf; no tensor cores, no TF32), the groups'
// partials added in group order.  r and p are double-buffered so that a
// phase never writes what another CTA of it still reads.  Every CTA forms
// alpha, beta and `live` itself from the per-CTA partials summed in index
// order: no atomics in any sum, so the result is the same bits every call.
//
// A stack of 2 to kMaxPlanes solves (jax.vmap of the unwrap) is one launch
// of `unwrap_kernel<true>`: each phase runs over every plane's tiles (plane b's
// tiles start at CTA (b * tiles) mod grid, so the CTAs share the B * tiles
// evenly), each plane has its own state, its own alpha, beta and `live`,
// and its own per-CTA partial slots (kMaxGrid a plane), summed in index
// order.  A plane that is no longer live is skipped, its state frozen as
// the TPU kernel's `live` mask freezes it; the loop ends when none is live.
// A single solve runs `unwrap_kernel<false>`, the same phases without the
// plane loops: the stack kernel at one plane visits the same tiles in the
// same order, but ran 8% slower at the 640 crop (ptxas allocates each
// kernel's registers on its own).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kGroups = 8;              // split-K groups of a product tile
constexpr int kTM = 16, kTN = 32;       // product tile: kTM * kTN == kThreads outputs
constexpr int kApad = kTM + 2;          // row stride of the k-major A tile
constexpr int kMaxGrid = 1024;          // per-CTA partial slots a solve reserves in `work`
constexpr int kPlanes = 11;             // state planes a solve keeps in `work`
constexpr int kMaxPlanes = 16;          // solves a launch takes
constexpr int kBatch = 8;               // loads a thread keeps in flight while staging
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;
static_assert(kTM * kTN == kThreads, "one combined output a thread");
static_assert(kThreads / 32 == kTM, "one warp stages one A row");

struct Args {
  const float *wrapped, *Dh, *DhT, *Dw, *DwT, *inv;
  const uint8_t* mask;
  float* out;
  float* work;
  int planes, h, w, Hp, Wp, cg_iters;
  float tol2;
};

// The padded inputs at (i, j) of the (Hp, Wp) domain, 0 outside the
// (h, w) plane: psi = where(mask, wrapped, 0) and m = mask as 0/1.
struct Padded {
  const float* wrapped;
  const uint8_t* mask;
  int h, w;
  __device__ __forceinline__ bool inside(int i, int j) const {
    return i < h && j < w && mask[i * w + j];
  }
  __device__ __forceinline__ float psi(int i, int j) const {
    return inside(i, j) ? __ldg(wrapped + i * w + j) : 0.0f;
  }
  __device__ __forceinline__ float m(int i, int j) const { return inside(i, j) ? 1.0f : 0.0f; }
};

__device__ __forceinline__ float wrap(float x) { return x - kTwoPi * rintf(x * kInvTwoPi); }

__device__ __forceinline__ float guard(float d) { return fabsf(d) < 1e-30f ? 1e-30f : d; }

// divergence of edge fluxes at (i, j): (fx - fx[j-1]) + (fy - fy[i-1])
template <class Fx, class Fy>
__device__ __forceinline__ float div2(Fx fx, Fy fy, int i, int j) {
  const float fx0 = fx(i, j);
  const float fx1 = j > 0 ? fx(i, j - 1) : 0.0f;
  const float fy0 = fy(i, j);
  const float fy1 = i > 0 ? fy(i - 1, j) : 0.0f;
  return (fx0 - fx1) + (fy0 - fy1);
}

// This CTA's N partial sums into part[blockIdx.x * N + q], in the block
// reduction's fixed order.
template <int N>
__device__ void publish(float (&v)[N], float* part) {
  __shared__ float red[N * 33];
  vt::block_reduce(v, red, vt::SumOp(), 0.0f);
  if (threadIdx.x < N) part[blockIdx.x * N + threadIdx.x] = v[threadIdx.x];
}

// The grid's totals of the N partial sums, after a grid barrier: warp 0
// adds CTAs lane, lane + 32, ... in order, then a butterfly; every thread of
// every CTA returns the same bits.
template <int N>
__device__ void grid_total(const float* part, float (&t)[N]) {
  __shared__ float sh[N];
  if (threadIdx.x < 32) {
    const int nb = (int)gridDim.x;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float s = 0.0f;
      for (int b0 = threadIdx.x; b0 < nb; b0 += 32 * kBatch) {
        float v[kBatch];  // loads first, then the adds in CTA order
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = b0 + 32 * u;
          v[u] = b < nb ? part[b * N + q] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (b0 + 32 * u < nb) s = s + v[u];
      }
      s = vt::warp_reduce(s, vt::SumOp());
      if (threadIdx.x == 0) sh[q] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < N; ++q) t[q] = sh[q];
  __syncthreads();
}

// C = A (M x Kd) @ B (Kd x N) over this CTA's share of the 16 x 32 output
// tiles, its first tile the `rot`-th before its own index (mod the grid; a
// single solve's 0, its own index): a_at(i, k) and b_at(k, j) give the
// operands' elements, epi(i, j, c) takes each output.  N is a multiple of
// 32 and Kd of 8.
template <class AAt, class BAt, class Epi>
__device__ void product(int M, int N, int Kd, AAt a_at, BAt b_at, Epi epi, float* smem,
                        int rot = 0) {
  float* As = smem;                    // [Kd][kApad], k-major
  float* Bs = As + Kd * kApad;         // [Kd][kTN]
  float* Cs = Bs + Kd * kTN;           // [kGroups][kTM * kTN] split-K partials
  const int tiles_n = N / kTN;
  const int tiles = ((M + kTM - 1) / kTM) * tiles_n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 6, t = threadIdx.x & 63;
  const int r0 = (t >> 3) * 2, c0 = (t & 7) * 4;
  const int kc = Kd / kGroups;
  const int first = rot == 0 ? (int)blockIdx.x
                             : ((int)blockIdx.x + (int)gridDim.x - rot) % (int)gridDim.x;
  for (int tile = first; tile < tiles; tile += gridDim.x) {
    const int i0 = (tile / tiles_n) * kTM, j0 = (tile % tiles_n) * kTN;
    // staging: kBatch loads in flight a thread, then their stores
    const int i = i0 + warp;
    for (int k0 = lane; k0 < Kd; k0 += 32 * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + 32 * u;
        v[u] = (k < Kd && i < M) ? a_at(i, k) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (k0 + 32 * u < Kd) As[(k0 + 32 * u) * kApad + warp] = v[u];
    }
    for (int e0 = threadIdx.x; e0 < Kd * kTN; e0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + kThreads * u;
        v[u] = e < Kd * kTN ? b_at(e >> 5, j0 + (e & 31)) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (e0 + kThreads * u < Kd * kTN) Bs[e0 + kThreads * u] = v[u];
    }
    __syncthreads();
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    for (int k = g * kc; k < (g + 1) * kc; ++k) {
      const float2 av = *reinterpret_cast<const float2*>(&As[k * kApad + r0]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k * kTN + c0]);
      acc[0][0] = fmaf(av.x, bv.x, acc[0][0]);
      acc[0][1] = fmaf(av.x, bv.y, acc[0][1]);
      acc[0][2] = fmaf(av.x, bv.z, acc[0][2]);
      acc[0][3] = fmaf(av.x, bv.w, acc[0][3]);
      acc[1][0] = fmaf(av.y, bv.x, acc[1][0]);
      acc[1][1] = fmaf(av.y, bv.y, acc[1][1]);
      acc[1][2] = fmaf(av.y, bv.z, acc[1][2]);
      acc[1][3] = fmaf(av.y, bv.w, acc[1][3]);
    }
    float* Cg = Cs + g * (kTM * kTN);
#pragma unroll
    for (int a = 0; a < 2; ++a)
      *reinterpret_cast<float4*>(&Cg[(r0 + a) * kTN + c0]) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    __syncthreads();
    float s = Cs[threadIdx.x];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) s = s + Cs[q * (kTM * kTN) + threadIdx.x];
    const int io = i0 + (threadIdx.x >> 5);
    if (io < M) epi(io, j0 + (threadIdx.x & 31), s);
    __syncthreads();  // the next tile restages As, Bs and Cs
  }
}

// One plane's state in `work`: the solve's planes, then its partial slots.
// Plain pointers only (the double buffers by arithmetic, not by an indexed
// array), so that the products' operand lambdas keep them in registers.
struct Plane {
  float *wx, *wy, *phi, *z, *Ap, *t1, *t2;
  float *partD, *partE, *partG1, *partG2;
  Padded in;
  float* out;
  int n;
  // r and p, double-buffered: buffer i of each
  __device__ __forceinline__ float* rb(int i) const { return phi + (1 + i) * n; }
  __device__ __forceinline__ float* pb(int i) const { return phi + (3 + i) * n; }
  __device__ Plane(const Args& a, int b) {
    n = a.Hp * a.Wp;
    float* base = a.work + (size_t)b * (kPlanes * (size_t)n + 6 * kMaxGrid);
    wx = base;
    wy = wx + n;
    phi = wy + n;
    z = phi + 5 * n;
    Ap = z + n;
    t1 = Ap + n;
    t2 = t1 + n;
    partD = t2 + n;                   // (r' z, r' r'), 2 a CTA
    partE = partD + 2 * kMaxGrid;     // (p' Ap)
    partG1 = partE + kMaxGrid;        // (m, (psi - phi) m)
    partG2 = partG1 + 2 * kMaxGrid;   // ((psi - phi - s1) m)
    const size_t off = (size_t)b * a.h * a.w;
    in = Padded{a.wrapped + off, a.mask + off, a.h, a.w};
    out = a.out + off;
  }
};

// unwrap_kernel<false>: one solve; unwrap_kernel<true>: a stack of 2 to
// kMaxPlanes solves (see the top of the file).
template <bool kStack>
__global__ void __launch_bounds__(kThreads, 1) unwrap_kernel(const Args a) {
  if constexpr (!kStack) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int Hp = a.Hp, Wp = a.Wp, n = Hp * Wp;
    float* wx = a.work;
    float* wy = wx + n;
    float* phi = wy + n;
    float* rb[2] = {phi + n, phi + 2 * n};
    float* pb[2] = {phi + 3 * n, phi + 4 * n};
    float* z = phi + 5 * n;
    float* Ap = z + n;
    float* t1 = Ap + n;
    float* t2 = t1 + n;
    float* partD = t2 + n;              // (r' z, r' r'), 2 a CTA
    float* partE = partD + 2 * kMaxGrid;  // (p' Ap)
    float* partG1 = partE + kMaxGrid;   // (m, (psi - phi) m)
    float* partG2 = partG1 + 2 * kMaxGrid;  // ((psi - phi - s1) m)
    const int tid = blockIdx.x * kThreads + threadIdx.x;
    const int nthr = gridDim.x * kThreads;
    const Padded in{a.wrapped, a.mask, a.h, a.w};

    // wx = m * m[., j+1], wy = m * m[i+1, .]; r = div2(wrap(dpsi) * w); phi = 0
    for (int idx = tid; idx < n; idx += nthr) {
      const int i = idx / Wp, j = idx - i * Wp;
      auto wxa = [&](int u, int v) { return in.m(u, v) * in.m(u, v + 1); };
      auto wya = [&](int u, int v) { return in.m(u, v) * in.m(u + 1, v); };
      auto dx = [&](int u, int v) { return wrap(in.psi(u, v + 1) - in.psi(u, v)) * wxa(u, v); };
      auto dy = [&](int u, int v) { return wrap(in.psi(u + 1, v) - in.psi(u, v)) * wya(u, v); };
      wx[idx] = wxa(i, j);
      wy[idx] = wya(i, j);
      rb[0][idx] = div2(dx, dy, i, j);
      phi[idx] = 0.0f;
    }
    grid.sync();

    // phases b-d of a preconditioner application z = precond(r') once t1 =
    // Dh r' is in place; the (r' z, r' r') partials
    auto precond_tail = [&](const float* rn) {
      product(Hp, Wp, Wp, [&](int i, int k) { return t1[i * Wp + k]; },
              [&](int k, int j) { return __ldg(a.DwT + k * Wp + j); },
              [&](int i, int j, float s) { t2[i * Wp + j] = s * __ldg(a.inv + i * Wp + j); },
              smem);
      grid.sync();
      product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.DhT + i * Hp + k); },
              [&](int k, int j) { return t2[k * Wp + j]; },
              [&](int i, int j, float s) { t1[i * Wp + j] = s; }, smem);
      grid.sync();
      float v[2] = {0.0f, 0.0f};
      product(Hp, Wp, Wp, [&](int i, int k) { return t1[i * Wp + k]; },
              [&](int k, int j) { return __ldg(a.Dw + k * Wp + j); },
              [&](int i, int j, float s) {
                const int o = i * Wp + j;
                z[o] = s;
                v[0] = v[0] + rn[o] * s;
                v[1] = v[1] + rn[o] * rn[o];
              },
              smem);
      publish(v, partD);
      grid.sync();
    };

    // phase e: p' = z (first) or z + beta p; Ap = wlap(p'); the (p' Ap) partials
    auto direction = [&](const float* pc, float* pn, float beta, bool first) {
      auto pv = [&](int u, int v) {
        if (u >= Hp || v >= Wp) return 0.0f;
        const int o = u * Wp + v;
        return first ? z[o] : z[o] + beta * pc[o];
      };
      auto fx = [&](int u, int v) { return wx[u * Wp + v] * (pv(u, v + 1) - pv(u, v)); };
      auto fy = [&](int u, int v) { return wy[u * Wp + v] * (pv(u + 1, v) - pv(u, v)); };
      float e[1] = {0.0f};
      for (int idx = tid; idx < n; idx += nthr) {
        const int i = idx / Wp, j = idx - i * Wp;
        const float ap = div2(fx, fy, i, j);
        const float p = pv(i, j);
        pn[idx] = p;
        Ap[idx] = ap;
        e[0] = e[0] + p * ap;
      }
      publish(e, partE);
      grid.sync();
    };

    float rz = 0.0f, rr = 0.0f, tol2r0 = 0.0f;
    int rc = 0, pc = 0;
    if (a.cg_iters > 0) {  // z = precond(r0); p = z; rz; tol^2 r0 r0
      product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.Dh + i * Hp + k); },
              [&](int k, int j) { return rb[0][k * Wp + j]; },
              [&](int i, int j, float s) { t1[i * Wp + j] = s; }, smem);
      grid.sync();
      precond_tail(rb[0]);
      float t[2];
      grid_total(partD, t);
      rz = t[0];
      rr = t[1];
      tol2r0 = a.tol2 * rr;
      direction(pb[0], pb[1], 0.0f, true);
      pc = 1;
    }
    for (int it = 0; it < a.cg_iters; ++it) {
      if (!(rr > tol2r0)) break;  // not live: no later step changes anything
      float pap[1];
      grid_total(partE, pap);
      const float alpha = rz / guard(pap[0]);
      const float* r = rb[rc];
      float* rn = rb[rc ^ 1];
      const float* p = pb[pc];
      // phase a: t1 = Dh (r - alpha Ap); the tile's owner stores r' and phi
      product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.Dh + i * Hp + k); },
              [&](int k, int j) {
                const int o = k * Wp + j;
                return r[o] - alpha * Ap[o];
              },
              [&](int i, int j, float s) {
                const int o = i * Wp + j;
                t1[o] = s;
                rn[o] = r[o] - alpha * Ap[o];
                phi[o] = phi[o] + alpha * p[o];
              },
              smem);
      grid.sync();
      precond_tail(rn);
      float t[2];
      grid_total(partD, t);
      const float beta = t[0] / guard(rz);
      rz = t[0];
      rr = t[1];
      direction(p, pb[pc ^ 1], beta, false);
      rc ^= 1;
      pc ^= 1;
    }

    // gauge: phi + s1 + s2 on the masked mean, in two passes
    float g[2] = {0.0f, 0.0f};
    for (int idx = tid; idx < n; idx += nthr) {
      const int i = idx / Wp, j = idx - i * Wp;
      g[0] = g[0] + in.m(i, j);
      g[1] = g[1] + (in.psi(i, j) - phi[idx]) * in.m(i, j);
    }
    publish(g, partG1);
    grid.sync();
    grid_total(partG1, g);
    const float nm = vt::jmax(g[0], 1.0f);
    const float s1 = g[1] / nm;
    float g2[1] = {0.0f};
    for (int idx = tid; idx < n; idx += nthr) {
      const int i = idx / Wp, j = idx - i * Wp;
      g2[0] = g2[0] + ((in.psi(i, j) - phi[idx]) - s1) * in.m(i, j);
    }
    publish(g2, partG2);
    grid.sync();
    grid_total(partG2, g2);
    const float s2 = g2[0] / nm;

    // congruence, crop to (h, w), NaN off the mask
    for (int idx = tid; idx < a.h * a.w; idx += nthr) {
      const int i = idx / a.w, j = idx - i * a.w;
      const float psi = in.psi(i, j);
      const float gp = (phi[i * Wp + j] + s1) + s2;
      const float k = rintf((gp - psi) * kInvTwoPi);
      a.out[idx] = a.mask[idx] ? psi + kTwoPi * k : __int_as_float(0x7fc00000);
    }
  } else {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    cg::grid_group grid = cg::this_grid();
    const int Hp = a.Hp, Wp = a.Wp, n = Hp * Wp, B = a.planes;
    const int tid = blockIdx.x * kThreads + threadIdx.x;
    const int nthr = gridDim.x * kThreads;
    const int tiles = ((Hp + kTM - 1) / kTM) * (Wp / kTN);
    // plane b's products start (b * tiles) mod grid CTAs along
    auto rot = [&](int b) { return (int)(((long long)b * tiles) % gridDim.x); };

    // wx = m * m[., j+1], wy = m * m[i+1, .]; r = div2(wrap(dpsi) * w); phi = 0
    for (int b = 0; b < B; ++b) {
      const Plane P(a, b);
      const Padded& in = P.in;
      for (int idx = tid; idx < n; idx += nthr) {
        const int i = idx / Wp, j = idx - i * Wp;
        auto wxa = [&](int u, int v) { return in.m(u, v) * in.m(u, v + 1); };
        auto wya = [&](int u, int v) { return in.m(u, v) * in.m(u + 1, v); };
        auto dx = [&](int u, int v) { return wrap(in.psi(u, v + 1) - in.psi(u, v)) * wxa(u, v); };
        auto dy = [&](int u, int v) { return wrap(in.psi(u + 1, v) - in.psi(u, v)) * wya(u, v); };
        P.wx[idx] = wxa(i, j);
        P.wy[idx] = wya(i, j);
        P.rb(0)[idx] = div2(dx, dy, i, j);
        P.phi[idx] = 0.0f;
      }
    }
    grid.sync();

    // per-plane scalars: every thread of every CTA holds the same bits
    float rz[kMaxPlanes], rr[kMaxPlanes], tol2r0[kMaxPlanes], alpha[kMaxPlanes];
    int rc[kMaxPlanes], pc[kMaxPlanes];
    bool live[kMaxPlanes];
    for (int b = 0; b < B; ++b) {
      rz[b] = rr[b] = tol2r0[b] = alpha[b] = 0.0f;
      rc[b] = pc[b] = 0;
      live[b] = true;
    }

    // phases b-d of a preconditioner application z = precond(r') of every
    // live plane once its t1 = Dh r' is in place; the (r' z, r' r') partials
    auto precond_tail = [&]() {
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        product(Hp, Wp, Wp, [&](int i, int k) { return P.t1[i * Wp + k]; },
                [&](int k, int j) { return __ldg(a.DwT + k * Wp + j); },
                [&](int i, int j, float s) { P.t2[i * Wp + j] = s * __ldg(a.inv + i * Wp + j); },
                smem, rot(b));
      }
      grid.sync();
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.DhT + i * Hp + k); },
                [&](int k, int j) { return P.t2[k * Wp + j]; },
                [&](int i, int j, float s) { P.t1[i * Wp + j] = s; }, smem, rot(b));
      }
      grid.sync();
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        const float* rn = P.rb(rc[b] ^ 1);
        float v[2] = {0.0f, 0.0f};
        product(Hp, Wp, Wp, [&](int i, int k) { return P.t1[i * Wp + k]; },
                [&](int k, int j) { return __ldg(a.Dw + k * Wp + j); },
                [&](int i, int j, float s) {
                  const int o = i * Wp + j;
                  P.z[o] = s;
                  v[0] = v[0] + rn[o] * s;
                  v[1] = v[1] + rn[o] * rn[o];
                },
                smem, rot(b));
        publish(v, P.partD);
      }
      grid.sync();
    };

    // phase e of every live plane: p' = z (first) or z + beta p; Ap =
    // wlap(p'); the (p' Ap) partials
    auto direction = [&](const float (&beta)[kMaxPlanes], bool first) {
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        const float* pcur = P.pb(pc[b]);
        float* pn = P.pb(pc[b] ^ 1);
        const float bb = beta[b];
        auto pv = [&](int u, int v) {
          if (u >= Hp || v >= Wp) return 0.0f;
          const int o = u * Wp + v;
          return first ? P.z[o] : P.z[o] + bb * pcur[o];
        };
        auto fx = [&](int u, int v) { return P.wx[u * Wp + v] * (pv(u, v + 1) - pv(u, v)); };
        auto fy = [&](int u, int v) { return P.wy[u * Wp + v] * (pv(u + 1, v) - pv(u, v)); };
        float e[1] = {0.0f};
        for (int idx = tid; idx < n; idx += nthr) {
          const int i = idx / Wp, j = idx - i * Wp;
          const float ap = div2(fx, fy, i, j);
          const float p = pv(i, j);
          pn[idx] = p;
          P.Ap[idx] = ap;
          e[0] = e[0] + p * ap;
        }
        publish(e, P.partE);
      }
      grid.sync();
    };

    float beta[kMaxPlanes];
    if (a.cg_iters > 0) {  // z = precond(r0); p = z; rz; tol^2 r0 r0
      for (int b = 0; b < B; ++b) {
        const Plane P(a, b);
        product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.Dh + i * Hp + k); },
                [&](int k, int j) { return P.rb(0)[k * Wp + j]; },
                [&](int i, int j, float s) { P.t1[i * Wp + j] = s; }, smem, rot(b));
        rc[b] = 1;  // precond_tail reads rb[rc ^ 1] = rb[0]
      }
      grid.sync();
      precond_tail();
      for (int b = 0; b < B; ++b) {
        const Plane P(a, b);
        float t[2];
        grid_total(P.partD, t);
        rz[b] = t[0];
        rr[b] = t[1];
        tol2r0[b] = a.tol2 * rr[b];
        rc[b] = 0;
        beta[b] = 0.0f;
      }
      direction(beta, true);
      for (int b = 0; b < B; ++b) pc[b] = 1;
    }
    for (int it = 0; it < a.cg_iters; ++it) {
      bool any = false;
      for (int b = 0; b < B; ++b) {
        // not live: no later step changes anything of this plane
        live[b] = live[b] && rr[b] > tol2r0[b];
        any = any || live[b];
      }
      if (!any) break;
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        float pap[1];
        grid_total(P.partE, pap);
        alpha[b] = rz[b] / guard(pap[0]);
      }
      // phase a: t1 = Dh (r - alpha Ap); the tile's owner stores r' and phi
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        const float al = alpha[b];
        const float* r = P.rb(rc[b]);
        float* rn = P.rb(rc[b] ^ 1);
        const float* p = P.pb(pc[b]);
        product(Hp, Wp, Hp, [&](int i, int k) { return __ldg(a.Dh + i * Hp + k); },
                [&](int k, int j) {
                  const int o = k * Wp + j;
                  return r[o] - al * P.Ap[o];
                },
                [&](int i, int j, float s) {
                  const int o = i * Wp + j;
                  P.t1[o] = s;
                  rn[o] = r[o] - al * P.Ap[o];
                  P.phi[o] = P.phi[o] + al * p[o];
                },
                smem, rot(b));
      }
      grid.sync();
      precond_tail();
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        const Plane P(a, b);
        float t[2];
        grid_total(P.partD, t);
        beta[b] = t[0] / guard(rz[b]);
        rz[b] = t[0];
        rr[b] = t[1];
      }
      direction(beta, false);
      for (int b = 0; b < B; ++b) {
        if (!live[b]) continue;
        rc[b] ^= 1;
        pc[b] ^= 1;
      }
    }

    // gauge: phi + s1 + s2 on the masked mean, in two passes
    float nm[kMaxPlanes], s1[kMaxPlanes];
    for (int b = 0; b < B; ++b) {
      const Plane P(a, b);
      float g[2] = {0.0f, 0.0f};
      for (int idx = tid; idx < n; idx += nthr) {
        const int i = idx / Wp, j = idx - i * Wp;
        g[0] = g[0] + P.in.m(i, j);
        g[1] = g[1] + (P.in.psi(i, j) - P.phi[idx]) * P.in.m(i, j);
      }
      publish(g, P.partG1);
    }
    grid.sync();
    for (int b = 0; b < B; ++b) {
      const Plane P(a, b);
      float g[2];
      grid_total(P.partG1, g);
      nm[b] = vt::jmax(g[0], 1.0f);
      s1[b] = g[1] / nm[b];
      float g2[1] = {0.0f};
      for (int idx = tid; idx < n; idx += nthr) {
        const int i = idx / Wp, j = idx - i * Wp;
        g2[0] = g2[0] + ((P.in.psi(i, j) - P.phi[idx]) - s1[b]) * P.in.m(i, j);
      }
      publish(g2, P.partG2);
    }
    grid.sync();

    // congruence, crop to (h, w), NaN off the mask
    for (int b = 0; b < B; ++b) {
      const Plane P(a, b);
      float g2[1];
      grid_total(P.partG2, g2);
      const float s2 = g2[0] / nm[b];
      for (int idx = tid; idx < a.h * a.w; idx += nthr) {
        const int i = idx / a.w, j = idx - i * a.w;
        const float psi = P.in.psi(i, j);
        const float gp = (P.phi[i * Wp + j] + s1[b]) + s2;
        const float k = rintf((gp - psi) * kInvTwoPi);
        P.out[idx] = P.in.mask[idx] ? psi + kTwoPi * k : __int_as_float(0x7fc00000);
      }
    }
  }
}

}  // namespace

// Float elements of the scratch `work` a padded (Hp, Wp) solve takes; a
// launch of `planes` solves takes `planes` times as many, plane after plane.
extern "C" int vt_unwrap_work_elems(int Hp, int Wp) {
  return kPlanes * Hp * Wp + 6 * kMaxGrid;
}

// wrapped: (planes, h, w) wrapped phases; mask: (planes, h, w) bool; each
// solve runs on the zero-padded (Hp, Wp) domain, Hp a multiple of 8 and Wp
// of 128; Dh, DhT: (Hp, Hp) and Dw, DwT: (Wp, Wp) orthonormal DCT-II
// matrices and their transposes; inv_denom: (Hp, Wp); out: (planes, h, w);
// work: planes * vt_unwrap_work_elems(Hp, Wp) floats; tol2 = tol * tol.  One
// cooperative launch on `stream` for every plane.
extern "C" int vt_unwrap_wls(const float* wrapped, const float* Dh,
                             const float* DhT, const float* Dw, const float* DwT,
                             const float* inv_denom, const uint8_t* mask, float* out,
                             float* work, int planes, int h, int w, int Hp, int Wp,
                             int cg_iters, float tol2, void* stream) {
  if (h < 1 || w < 1 || Hp < h || Wp < w || Hp % 8 != 0 || Wp % 128 != 0 || cg_iters < 0 ||
      planes < 1 || planes > kMaxPlanes)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int kmax = Hp > Wp ? Hp : Wp;
  const int bytes = (kmax * (kApad + kTN) + kGroups * kTM * kTN) * (int)sizeof(float);
  const auto kernel = planes == 1 ? unwrap_kernel<false> : unwrap_kernel<true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || sms > kMaxGrid) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args args{wrapped, Dh, DhT, Dw, DwT, inv_denom, mask, out, work,
            planes, h, w, Hp, Wp, cg_iters, tol2};
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(sms), dim3(kThreads),
                                    params, (size_t)bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
