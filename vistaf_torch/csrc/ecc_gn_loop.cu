// K4: the per-iteration ECC Gauss-Newton loop, one persistent cooperative
// launch with the loop on the device.
//
// Replaces the JAX package's pallas/ecc_kernel.py::gn_moments_euclidean and the
// jax.lax.while_loop that calls it once an iteration (ops/registration.py:
// 281-331, the route of a seeded solve and of planes above the whole-solve
// kernel's budget).  Each iteration:
//   1. every thread turns the warp p = (theta, tx, ty) into the two shear
//      passes' scalars, in kernels/ecc_kernel.py::shear_coeffs' f32 order;
//   2. each CTA runs the vertical shear pass of the [I, gx, gy, mask] stack
//      over its tile (2K + 1 hat taps, zero border) into shared memory, then
//      the horizontal pass, the mask threshold, the six moment rows and
//      their 21 sums over the tile (ecc_common.cuh, shared with K5);
//   3. one exchange: each CTA writes its 21 partials to a double-buffered
//      slot in global memory, one grid barrier, and every CTA adds all the
//      partials in one fixed order, so every CTA holds the same bits;
//   4. every thread takes the Gauss-Newton step on those bits: the JAX K4
//      route's tail, linalg.solve of H + 1e-12 I for both right-hand sides by
//      LU with partial pivoting in LAPACK's sgetf2/sgetrs order, then the
//      lambda step, cv2's StsNoConv rule, eps and stall_patience
//      (ecc_common.cuh::gn_step), so all CTAs agree on going on.
// Output: [theta, tx, ty, rho, iters, failed]; the identity/NaN handling on
// failure stays with the caller.  Given the 8 shear scalars instead of a
// seed, the same kernel runs one iteration and writes the (6, 6) moment
// matrix (the one-iteration function gn_moments_euclidean).
//
// Bound and design.  At the native-4K coarse grid (295 x 295, K = 4) an
// iteration is ~3 M hat taps a pass on a stack that never changes: a few
// microseconds of arithmetic spread over the card, on 1.4 MB of inputs.
// What costs is the chain of sequential plane-wide sums, so the loop, its
// sums and its tail stay on the card and nothing waits on the host.  The
// plane is cut into nr x nc tiles, one per CTA, at most one CTA per SM
// (cooperative launch: co-residency is guaranteed, or the launch fails with
// its CUDA error).  A tile's inputs (the stack's rows and columns within K
// of the tile, the template and the statistics grid) are copied into shared
// memory once per solve with Hopper's bulk asynchronous copy
// (cp.async.bulk, completing on an mbarrier; the ragged ends of a row that
// are not 16-byte aligned by plain loads), and every iteration's two passes
// run from there: the horizontal pass at (v, u) reads only row v of the
// vertically sheared planes, columns u - K .. u + K, so the tile's `mid`
// lives in shared memory as well.  The host (kernels/ecc_kernel.py::
// tile_plan) picks nr x nc so that the largest tile fits a CTA's shared
// memory and the fewest thread rounds cover it.  The sums keep one fixed
// order (per-thread pixel order, the block reduction's, then each lane's
// CTAs in index order and a warp butterfly) and no atomics: the stop rule
// compares rho at one f32 ulp, and two calls give the same bits.
//
// A stack of solves (jax.vmap of the JAX loop, its gn_moments_euclidean
// vmapped inside the vmapped while_loop): one cooperative launch of as
// many solves' tilings as can be resident at once, the stack in waves of
// that many (at 295 x 295 one solve's 99 CTAs fill 99 of the H100's 132
// SMs, so a wave is one solve).  A solve's tiling depends on its shape
// only, so each solve sums its own tiles in the single launch's order and
// takes its own step and stop, bit for bit its single launch; a solve that
// has stopped computes nothing and waits, and a wave ends once none of its
// solves is live (each CTA writes its solve's live flag beside its partials).
#include <cooperative_groups.h>
#include <float.h>
#include <limits.h>

#include "ecc_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMoments = vt::kEccMoments;
// dynamic shared memory a CTA may take: the 227 KB opt-in less the static part
constexpr int kMaxSmem = 232448 - 8192;

struct Args {
  const float *S, *T, *SM;
  const float* p0;      // (3,) seed of the loop
  const float* coeffs;  // (8,) shear scalars: one iteration, the matrix out
  float* out;           // [theta, tx, ty, rho, iters, failed], or the (6, 6) matrix
  float* part;          // 2 * nr * nc * 21 partial sums
  int h, w, K, nr, nc, max_iters;
  float eps;
  int stall_patience;
};

// Shared-memory layout of the largest tile, the same in every CTA (mirrored
// by kernels/ecc_kernel.py::tile_bytes): `mid` (rh x wc float4), the
// stack's 4 planes of wr window rows and the template and statistics grid
// of rh tile rows, each row padded so that a row's copy can start at its
// global address' 16-byte phase.
struct Layout {
  int rh, cw, wr, wc, ld_s, ld_t;
  __host__ __device__ Layout(int h, int w, int K, int nr, int nc) {
    rh = (h + nr - 1) / nr;
    cw = (w + nc - 1) / nc;
    wr = rh + 2 * K < h ? rh + 2 * K : h;
    wc = cw + 2 * K < w ? cw + 2 * K : w;
    ld_s = (wc + 6) / 4 * 4;
    ld_t = (cw + 6) / 4 * 4;
  }
  __host__ __device__ long long floats() const {
    return 4LL * rh * wc + 4LL * wr * ld_s + 2LL * rh * ld_t;
  }
};

int vt_gn_loop_smem_bytes_impl(int h, int w, int K, int nr, int nc) {
  const long long bytes = Layout(h, w, K, nr, nc).floats() * (long long)sizeof(float);
  return bytes < INT_MAX ? (int)bytes : INT_MAX;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies src[0, n) to dst[lead + j], lead = src's float offset within its
// 16-byte line (dst is 16-byte aligned): the aligned interior with one bulk
// asynchronous copy that completes on `bar`, the ragged ends with plain
// loads.  Returns the bytes the bulk copy brings.
__device__ uint32_t stage_row(float* dst, const float* __restrict__ src, int n, uint64_t* bar) {
  const int lead = (int)(((uintptr_t)src >> 2) & 3);
  float* d = dst + lead;
  const int j0 = (4 - lead) & 3;                   // first 16-byte aligned element
  const int nb = n > j0 ? (n - j0) & ~3 : 0;       // elements of the bulk copy
  for (int j = 0; j < n && j < j0; ++j) d[j] = __ldg(src + j);
  for (int j = j0 + nb; j < n; ++j) d[j] = __ldg(src + j);
  if (nb > 0) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(d + j0)),
        "l"(src + j0), "r"(nb * 4), "r"(smem_u32(bar))
        : "memory");
  }
  return (uint32_t)nb * 4u;
}

// x = H^-1 B for both columns of B by LU with partial pivoting, in LAPACK's
// order (sgetf2: the first largest |pivot|, a row swap, the column scaled by
// the pivot's reciprocal, the rank-1 update; sgetrs: the swaps, then the
// unit-lower and upper triangular solves of the reference strsm, which skip
// a zero right-hand side entry).
struct LuSolve {
  // every loop is unrolled and each row swap is a choice among constant
  // indices, so A and B stay in registers
  __device__ void operator()(const float (&H)[3][3], const float (&Gt)[3],
                             const float (&Gi)[3], float (&u)[3], float (&v)[3]) const {
    float A[3][3], B[3][2];
    int piv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) A[i][j] = H[i][j];
      B[i][0] = Gt[i];
      B[i][1] = Gi[i];
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      int p = j;
      float big = fabsf(A[j][j]);
#pragma unroll
      for (int i = j + 1; i < 3; ++i) {
        if (fabsf(A[i][j]) > big) {
          big = fabsf(A[i][j]);
          p = i;
        }
      }
      piv[j] = p;
      float pivot = A[j][j];
#pragma unroll
      for (int i = j + 1; i < 3; ++i) pivot = p == i ? A[i][j] : pivot;
      if (pivot != 0.0f) {
#pragma unroll
        for (int i = j + 1; i < 3; ++i) {
          if (p == i) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float t = A[j][k];
              A[j][k] = A[i][k];
              A[i][k] = t;
            }
          }
        }
        if (fabsf(A[j][j]) >= FLT_MIN) {
          const float r = 1.0f / A[j][j];
#pragma unroll
          for (int i = j + 1; i < 3; ++i) A[i][j] = A[i][j] * r;
        } else {
#pragma unroll
          for (int i = j + 1; i < 3; ++i) A[i][j] = A[i][j] / A[j][j];
        }
      }
#pragma unroll
      for (int i = j + 1; i < 3; ++i) {
#pragma unroll
        for (int k = j + 1; k < 3; ++k) A[i][k] = A[i][k] + A[i][j] * (-A[j][k]);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int i = j + 1; i < 3; ++i) {
        if (piv[j] == i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float t = B[j][c];
            B[j][c] = B[i][c];
            B[i][c] = t;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (B[k][c] != 0.0f) {
#pragma unroll
          for (int i = k + 1; i < 3; ++i) B[i][c] = B[i][c] - B[k][c] * A[i][k];
        }
      }
#pragma unroll
      for (int k = 2; k >= 0; --k) {
        if (B[k][c] != 0.0f) {
          B[k][c] = B[k][c] / A[k][k];
#pragma unroll
          for (int i = 0; i < k; ++i) B[i][c] = B[i][c] - B[k][c] * A[i][k];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      u[i] = B[i][0];
      v[i] = B[i][1];
    }
  }
};

// A CTA's tile [v0, v1) x [c0, c1) of the nr x nc tiling and its window
// [ws0, ws1) x [cs0, cs1) of the stack (the tile's rows and columns within K).
struct Tile {
  int v0, v1, c0, c1, ws0, ws1, cs0, cs1, nrows, ncols, nwr, nwc;
  __device__ Tile(int h, int w, int K, int nr, int nc, int tile) {
    const int ti = tile / nc, tj = tile % nc;
    v0 = ti * h / nr;
    v1 = (ti + 1) * h / nr;
    c0 = tj * w / nc;
    c1 = (tj + 1) * w / nc;
    ws0 = max(0, v0 - K);
    ws1 = min(h, v1 + K);
    cs0 = max(0, c0 - K);
    cs1 = min(w, c1 + K);
    nrows = v1 - v0;
    ncols = c1 - c0;
    nwr = ws1 - ws0;
    nwc = cs1 - cs0;
  }
};

// The tile's pieces of shared memory (Layout): `mid`, the stack's window,
// the template's and the statistics grid's tile rows.
struct Smem {
  float4* mid;
  float *sS, *sT, *sSM;
  __device__ Smem(float4* base, const Layout& L) {
    mid = base;                                              // [nrows][L.wc]
    sS = reinterpret_cast<float*>(mid + (size_t)L.rh * L.wc);  // [4][L.wr][L.ld_s]
    sT = sS + (size_t)4 * L.wr * L.ld_s;                     // [L.rh][L.ld_t]
    sSM = sT + (size_t)L.rh * L.ld_t;
  }
};

// Stage one solve's tile inputs into shared memory: every thread arrives on
// `bar` with the bytes of the bulk copies it started, and waits for the
// barrier's phase `parity` to complete.
__device__ __forceinline__ void stage_tile(const Smem& sm, const Layout& L, const Tile& t,
                                           const float* S, const float* T, const float* SM,
                                           int w, size_t hw, uint64_t* bar, uint32_t parity) {
  uint32_t bytes = 0;
  for (int r = threadIdx.x; r < 4 * t.nwr + 2 * t.nrows; r += kThreads) {
    if (r < 4 * t.nwr) {
      const int ch = r / t.nwr, rr = r - ch * t.nwr;
      bytes += stage_row(sm.sS + (size_t)(ch * L.wr + rr) * L.ld_s,
                         S + (size_t)ch * hw + (size_t)(t.ws0 + rr) * w + t.cs0, t.nwc, bar);
    } else {
      const int r2 = r - 4 * t.nwr, which = r2 / t.nrows, rr = r2 - which * t.nrows;
      bytes += stage_row((which ? sm.sSM : sm.sT) + (size_t)rr * L.ld_t,
                         (which ? SM : T) + (size_t)(t.v0 + rr) * w + t.c0, t.ncols, bar);
    }
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  {
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    }
  }
  __syncthreads();  // and the plain loads of the ragged ends
}

// One iteration's 21 moment sums over the tile at the warp `sc`, the
// block's total in every thread's `mom`: the vertical pass over the tile's
// rows and its window's columns into `mid`, then the horizontal pass and the
// moment rows [m, T m, I m, G_theta, gx m, gy m].
__device__ __forceinline__ void tile_moments(const Smem& sm, const Layout& L, const Tile& t,
                                             const float* S, const float* T, const float* SM,
                                             int h, int w, int K, const vt::ShearScalars& sc,
                                             float (&red)[kMoments * 33],
                                             float (&mom)[kMoments]) {
  const int hw = h * w;
  // a staged row's float offset within its 16-byte line, as stage_row placed it
  const uint32_t lead_s = (uint32_t)((uintptr_t)S >> 2) + (uint32_t)t.cs0;
  const uint32_t lead_t = (uint32_t)((uintptr_t)T >> 2) + (uint32_t)t.c0;
  const uint32_t lead_m = (uint32_t)((uintptr_t)SM >> 2) + (uint32_t)t.c0;
  for (int i = threadIdx.x; i < t.nrows * t.nwc; i += kThreads) {
    const int dv = i / t.nwc, uc = i - dv * t.nwc;
    sm.mid[dv * L.wc + uc] = vt::shear_vertical4(
        [&](int vv) {
          const uint32_t e = lead_s + (uint32_t)vv * (uint32_t)w;
          const float* row = sm.sS + (size_t)(vv - t.ws0) * L.ld_s + uc;
          const size_t plane = (size_t)L.wr * L.ld_s;
          return make_float4(row[e & 3], row[plane + ((e + hw) & 3)],
                             row[2 * plane + ((e + 2 * hw) & 3)],
                             row[3 * plane + ((e + 3 * hw) & 3)]);
        },
        h, K, sc, t.v0 + dv, t.cs0 + uc);
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kMoments; ++q) mom[q] = 0.0f;
  for (int i = threadIdx.x; i < t.nrows * t.ncols; i += kThreads) {
    const int dv = i / t.ncols, ut = i - dv * t.ncols;
    const int v = t.v0 + dv, u = t.c0 + ut;
    float av[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    vt::shear_horizontal([&](int uu) { return sm.mid[dv * L.wc + (uu - t.cs0)]; }, w, K, sc, v,
                         u, av);
    const uint32_t vw = (uint32_t)v * (uint32_t)w;
    const float tv = sm.sT[dv * L.ld_t + ((lead_t + vw) & 3) + ut];
    const float smv = sm.sSM[dv * L.ld_t + ((lead_m + vw) & 3) + ut];
    float row[6];
    vt::moment_row(av, tv, smv, sc, v, u, row);
    vt::accumulate_moments(row, mom);
  }
  // its barriers also keep `mid` from being rewritten while still read
  vt::block_reduce(mom, red, vt::SumOp(), 0.0f);
}

// The exchange: the 21 sums of `n` CTAs' partials (stride `ld` floats) into
// `tot`, each warp one moment, lane l adding those of CTAs l, l + 32, ... in
// order, then a butterfly; the same bits in every CTA.
__device__ __forceinline__ void exchange_sum(const float* part, int n, int ld, float* tot) {
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < kMoments; q += kThreads / 32) {
    float s = 0.0f;
    for (int b = lane; b < n; b += 32) s = s + __ldcg(part + b * ld + q);
    s = vt::warp_reduce(s, vt::SumOp());
    if (lane == 0) tot[q] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(kThreads)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One solve (kStack false): the grid is the solve's nr x nc tiles.  A stack
// of solves (kStack true, StackArgs): the grid is `slots` solves' tiles at
// once, CTA slot * nr * nc + tile, and the stack runs in waves of `slots`
// solves.  Each solve keeps its own 21 sums (over its own tiles, in the
// single solve's order), its own step and its own stop, and freezes once it
// stops; a wave ends once none of its solves is live, which every CTA reads
// from the live flags written beside the partials.
struct StackArgs {
  Args a;
  int n, slots;
};

constexpr int kLd = kMoments + 1;  // a CTA's partials and its solve's live flag

template <bool kStack>
__global__ void __launch_bounds__(kThreads, 1) gn_loop_kernel(const StackArgs sa) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kMoments * 33];
  __shared__ float tot[kMoments];
  __shared__ alignas(8) uint64_t bar;
  cg::grid_group grid = cg::this_grid();

  const Args a = sa.a;
  const int h = a.h, w = a.w, K = a.K;
  const size_t hw = (size_t)h * w;
  const Layout L(h, w, K, a.nr, a.nc);
  const Smem sm(smem4, L);
  init_barrier(&bar);

  if constexpr (!kStack) {
    const Tile t(h, w, K, a.nr, a.nc, (int)blockIdx.x);
    stage_tile(sm, L, t, a.S, a.T, a.SM, w, hw, &bar, 0);
    vt::GnState st;
    if (a.coeffs == nullptr) {
      st.p0 = st.b0 = a.p0[0];
      st.p1 = st.b1 = a.p0[1];
      st.p2 = st.b2 = a.p0[2];
    }
    int par = 0;
    for (;;) {
      vt::ShearScalars sc;
      if (a.coeffs != nullptr) {
        const float* co = a.coeffs;
        sc = vt::ShearScalars{co[0], co[1], co[2], co[3], co[4], co[5], co[6], co[7]};
      } else {
        if (!st.keep_going(a.max_iters, a.eps, a.stall_patience)) break;
        sc = vt::shear_scalars(st.p0, st.p1, st.p2);
      }
      float mom[kMoments];
      tile_moments(sm, L, t, a.S, a.T, a.SM, h, w, K, sc, red, mom);
      float* slot = a.part + (size_t)par * gridDim.x * kMoments;
      if (threadIdx.x < kMoments) slot[blockIdx.x * kMoments + threadIdx.x] = mom[threadIdx.x];
      grid.sync();
      exchange_sum(slot, (int)gridDim.x, kMoments, tot);
      par ^= 1;

      if (a.coeffs != nullptr) {  // one iteration: the symmetric (6, 6) matrix
        if (blockIdx.x == 0 && threadIdx.x < kMoments) {
          int i = 0, rest = threadIdx.x;
          while (rest >= 6 - i) {
            rest -= 6 - i;
            ++i;
          }
          const int j = i + rest;
          a.out[i * 6 + j] = tot[threadIdx.x];
          a.out[j * 6 + i] = tot[threadIdx.x];
        }
        return;
      }
      vt::gn_step(st, tot, LuSolve());  // every thread, the same bits
    }

    st.finish(a.stall_patience);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.out[0] = st.p0;
      a.out[1] = st.p1;
      a.out[2] = st.p2;
      a.out[3] = st.rho;
      a.out[4] = (float)st.it;
      a.out[5] = st.failed ? 1.0f : 0.0f;
    }
  } else {
    const int tiles = a.nr * a.nc;
    const int slot = (int)blockIdx.x / tiles;
    const Tile t(h, w, K, a.nr, a.nc, (int)blockIdx.x - slot * tiles);
    const int waves = (sa.n + sa.slots - 1) / sa.slots;
    int par = 0;
    for (int wave = 0; wave < waves; ++wave) {
      const int solve = wave * sa.slots + slot;
      const bool active = solve < sa.n;
      const float* S = a.S + (size_t)solve * 4 * hw;
      const float* T = a.T + (size_t)solve * hw;
      const float* SM = a.SM + (size_t)solve * hw;
      vt::GnState st;
      if (active) {
        // the last wave's reads of shared memory come before the bulk copies' writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage_tile(sm, L, t, S, T, SM, w, hw, &bar, (uint32_t)(wave & 1));
        st.p0 = st.b0 = a.p0[3 * solve];
        st.p1 = st.b1 = a.p0[3 * solve + 1];
        st.p2 = st.b2 = a.p0[3 * solve + 2];
      }
      for (;;) {
        const bool live = active && st.keep_going(a.max_iters, a.eps, a.stall_patience);
        float mom[kMoments];
        if (live) {
          tile_moments(sm, L, t, S, T, SM, h, w, K, vt::shear_scalars(st.p0, st.p1, st.p2),
                       red, mom);
        }
        float* part = a.part + (size_t)par * gridDim.x * kLd;
        if (live && threadIdx.x < kMoments) part[blockIdx.x * kLd + threadIdx.x] = mom[threadIdx.x];
        if (threadIdx.x == kMoments) part[blockIdx.x * kLd + kMoments] = live ? 1.0f : 0.0f;
        grid.sync();
        par ^= 1;
        bool any = false;
        for (int s = 0; s < sa.slots; ++s)
          any = any || __ldcg(part + (size_t)s * tiles * kLd + kMoments) != 0.0f;
        if (!any) break;
        if (live) {
          exchange_sum(part + (size_t)slot * tiles * kLd, tiles, kLd, tot);
          vt::gn_step(st, tot, LuSolve());
        }
      }
      if (active) {
        st.finish(a.stall_patience);
        if (t.v0 == 0 && t.c0 == 0 && threadIdx.x == 0) {
          float* o = a.out + 6 * (size_t)solve;
          o[0] = st.p0;
          o[1] = st.p1;
          o[2] = st.p2;
          o[3] = st.rho;
          o[4] = (float)st.it;
          o[5] = st.failed ? 1.0f : 0.0f;
        }
      }
      __syncthreads();
    }
  }
}

// The solves one cooperative launch of gn_loop_kernel<kStack> holds with
// all its CTAs resident (at most `solves`), and its dynamic shared memory;
// refused when a tile does not fit a CTA's shared memory or one solve's
// tiles cannot all be resident.
template <bool kStack>
int resident_solves(const Args& a, int solves, int* slots, int* bytes) {
  if (a.h < 1 || a.w < 1 || a.K < 0 || a.nr < 1 || a.nr > a.h || a.nc < 1 || a.nc > a.w ||
      a.max_iters < 0 || solves < 1)
    return (int)cudaErrorInvalidValue;
  *bytes = vt_gn_loop_smem_bytes_impl(a.h, a.w, a.K, a.nr, a.nc);
  if (*bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gn_loop_kernel<kStack>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_loop_kernel<kStack>, kThreads,
                                                      (size_t)*bytes);
  if (err != cudaSuccess) return (int)err;
  const int fit = per_sm < 1 ? 0 : sms * per_sm / (a.nr * a.nc);
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *slots = solves < fit ? solves : fit;
  return 0;
}

template <bool kStack>
int launch(StackArgs sa, void* stream) {
  int bytes = 0;
  const int err = resident_solves<kStack>(sa.a, sa.n, &sa.slots, &bytes);
  if (err != 0) return err;
  void* params[] = {&sa};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)gn_loop_kernel<kStack>, dim3(sa.slots * sa.a.nr * sa.a.nc), dim3(kThreads),
      params, (size_t)bytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, of the nr x nc tiling of an (h, w) plane
// (INT_MAX for any size above it).
extern "C" int vt_gn_loop_smem_bytes(int h, int w, int K, int nr, int nc) {
  return vt_gn_loop_smem_bytes_impl(h, w, K, nr, nc);
}

// S: (4, h, w) centred [I, gx, gy, mask01]; T, SM: (h, w); p0: (3,) seed;
// coeffs: (8,) shear scalars, or null; out: (6,) [theta, tx, ty, rho, iters,
// failed], or (6, 6) when coeffs is given; part: 2 * nr * nc * 21 floats of
// scratch.  One cooperative launch of nr * nc CTAs on `stream`; a tiling
// whose tile does not fit a CTA's shared memory, or more CTAs than can be
// resident, is refused.
extern "C" int vt_gn_loop_euclidean(const float* S, const float* T, const float* SM,
                                    const float* p0, const float* coeffs, float* out,
                                    float* part, int h, int w, int K, int nr, int nc,
                                    int max_iters, float eps, int stall_patience,
                                    void* stream) {
  if (coeffs == nullptr && p0 == nullptr) return (int)cudaErrorInvalidValue;
  return launch<false>(StackArgs{Args{S, T, SM, p0, coeffs, out, part, h, w, K, nr, nc,
                                      max_iters, eps, stall_patience},
                                 1, 1},
                       stream);
}

// The solves a wave of an n-solve stack holds at the nr x nc tiling (its
// launch is slots * nr * nc CTAs), or a negative CUDA error.
extern "C" int vt_gn_loop_stack_slots(int n, int h, int w, int K, int nr, int nc) {
  Args a{};
  a.h = h;
  a.w = w;
  a.K = K;
  a.nr = nr;
  a.nc = nc;
  int slots = 0, bytes = 0;
  const int err = resident_solves<true>(a, n, &slots, &bytes);
  return err != 0 ? -err : slots;
}

// n solves: S (n, 4, h, w), T and SM (n, h, w), p0 (n, 3); out (n, 6), each
// solve's [theta, tx, ty, rho, iters, failed]; part: 2 * slots * nr * nc *
// 22 floats of scratch (slots from vt_gn_loop_stack_slots).  One
// cooperative launch of slots * nr * nc CTAs on `stream`, the solves in
// waves of `slots`, each solve bit for bit its single launch.
extern "C" int vt_gn_loop_euclidean_stack(const float* S, const float* T, const float* SM,
                                          const float* p0, float* out, float* part, int n,
                                          int h, int w, int K, int nr, int nc, int max_iters,
                                          float eps, int stall_patience, void* stream) {
  if (p0 == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(StackArgs{Args{S, T, SM, p0, nullptr, out, part, h, w, K, nr, nc,
                                     max_iters, eps, stall_patience},
                                n, 0},
                      stream);
}
