// K7: the whole robust (IRLS, Cauchy-weighted) 2-D polynomial fit, held in
// the shared memory of one thread-block cluster.
//
// Replaces the JAX package's pallas/polyfit_kernel.py::robust_polyfit2d_pallas.
// Per round: the w^2-weighted normal equations as plane sums (21 + 6 for
// order 2, 6 + 3 for order 1), +1e-9 on the diagonal, an unrolled Cholesky
// solve; then, in the first `resigma_iters` rounds, the bisection median and
// MAD of the residual over the mask; Cauchy weights 1 / (1 + u^2) with
// u = r / (c * 1.4826 * (mad + 1e-6)).  The weights are recomputed from the
// previous round's coefficients instead of being kept as a plane.  Output:
// the coefficients, zeros when the mask holds fewer than 200 pixels.
//
// Bound and design.  The function must read the plane and its mask once
// (5 bytes a pixel: 0.3 MB at the 640 path's 236^2 crop, 0.1 us of HBM
// time); what costs is the chain of plane-wide decisions: a round's solve
// needs all its sums, a bisection level all its counts.  The TPU kernel
// holds the plane in VMEM for the whole fit; here one portable cluster of
// kCtas = 8 CTAs holds it in shared memory: each CTA loads its eighth of z
// once (mask folded in as NaN, 4 bytes an element, at most 150 KB at the
// largest plane polyfit_kernel.fits admits) and no fitting pass reads global
// memory again.  A plane-wide total is one exchange through distributed
// shared memory: every CTA writes its block-reduced words into its slot,
// the cluster syncs, and every CTA combines the 8 slots in rank order, so
// all CTAs hold the same bits (no float atomics; the slots are
// double-buffered, so one cluster barrier per exchange suffices).  Every CTA
// then solves the same sums itself.  The median and MAD take the bisection
// ladder (ladder.cuh), 8 levels an exchange: each CTA builds the 255-node
// tree, counts its leaves in shared memory, and every CTA sums the 8 CTAs'
// leaf counts and walks the same bracket.  A round is 1 exchange, plus
// 1 + 2 ceil(levels / 8) in a resigma round (5 at 16 levels): 14 for the
// 640 deploy preset's 4 rounds with 2 resigma rounds, instead of 70
// block-barrier passes over the plane on one SM.  A stack of planes
// (jax.vmap of the fit) is one launch of one cluster a plane, plane
// blockIdx.y, each fitting its own plane.
#include <cooperative_groups.h>

#include "ladder.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCtas = 8;             // the portable cluster size
constexpr int kMaxElems = 300000;    // polyfit_kernel._MAX_PADDED_ELEMS
constexpr int kSlotWords = vt::kLeaves;

// Elements each CTA of the cluster holds (a multiple of 4).
int fit_chunk(int n) { return ((n + kCtas - 1) / kCtas + 3) & ~3; }

template <int kCoef>
struct Basis {
  float cx, cy;
  int w;
  // [xn, yn, 1] (+ [xn^2, xn*yn, yn^2]) at pixel `pix`, as polyfit_kernel.basis
  __device__ __forceinline__ void at(int pix, float (&col)[kCoef]) const {
    const int v = pix / w, u = pix - v * w;
    const float xn = ((float)u - cx) / cx;
    const float yn = ((float)v - cy) / cy;
    col[0] = xn;
    col[1] = yn;
    col[2] = 1.0f;
    if constexpr (kCoef == 6) {
      col[3] = xn * xn;
      col[4] = xn * yn;
      col[5] = yn * yn;
    }
  }
  __device__ __forceinline__ float residual(float z, const float (&coef)[kCoef],
                                            const float (&col)[kCoef]) const {
    float r = z;
#pragma unroll
    for (int a = 0; a < kCoef; ++a) r = r - coef[a] * col[a];
    return r;
  }
};

// x = H^-1 g for the symmetric positive definite H, +1e-9 on the diagonal:
// unrolled Cholesky and two substitutions.  `sums` holds the float bits of
// H's upper triangle (pairs a <= b in row order), then of g.
template <int N>
__device__ __forceinline__ void chol_solve(const int* sums, float (&x)[N]) {
  float H[N][N], g[N];
  int q = 0;
#pragma unroll
  for (int a = 0; a < N; ++a)
#pragma unroll
    for (int b = a; b < N; ++b) H[a][b] = __int_as_float(sums[q++]);
#pragma unroll
  for (int a = 0; a < N; ++a) g[a] = __int_as_float(sums[q++]);
#pragma unroll
  for (int a = 0; a < N; ++a) H[a][a] = H[a][a] + 1e-9f;
  float L[N][N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float s = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(vt::jmax(s, 1e-20f));
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      float t = H[j][i];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float t = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = t - L[i][k] * y[k];
    y[i] = t / L[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float t = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) t = t - L[k][i] * x[k];
    x[i] = t / L[i][i];
  }
}

template <class T>
__device__ __forceinline__ T from_word(int v);
template <>
__device__ __forceinline__ int from_word<int>(int v) { return v; }
template <>
__device__ __forceinline__ float from_word<float>(int v) { return __int_as_float(v); }

// Word j of `slot` in every CTA of the cluster, combined in rank order.
template <class T, class Op>
__device__ __forceinline__ T over_cluster(cg::cluster_group& cl, int* slot, int j, Op op) {
  T s = from_word<T>(cl.map_shared_rank(slot, 0)[j]);
  for (int r = 1; r < kCtas; ++r) s = op(s, from_word<T>(cl.map_shared_rank(slot, r)[j]));
  return s;
}

// The cluster's shared state.  slot[par] is this CTA's half of the current
// exchange; after cluster.sync() every CTA combines the 8 CTAs' slots into
// its own `tot`.  An exchange flips `par`: a slot is written again two
// exchanges later, after every CTA has passed the barrier of the exchange in
// between, and so has read it.
struct Exchange {
  cg::cluster_group cl;
  int (*slot)[kSlotWords];
  int* tot;
  int par;
};

// The bisection ladder over value(i, z) of the valid elements i of the
// CTA's chunk (z = zs[i] not NaN), `levels` levels from the bracket [a, b]:
// one exchange of leaf counts per 8 levels.  Every thread of every CTA
// returns the same bracket.
template <class Value>
__device__ void cluster_ladder(Exchange& ex, const float* zs, int len, float* tree, int levels,
                               float target, float& a, float& b, Value value) {
  for (int pass = 0; pass * vt::kLadderBits < levels; ++pass) {
    const int bits = vt::pass_bits(levels, pass);
    const int leaves = 1 << bits;
    int* hist = ex.slot[ex.par];
    for (int i = threadIdx.x; i < leaves; i += blockDim.x) {
      hist[i] = 0;
      if (i) tree[i] = vt::node_midpoint(a, b, i);
    }
    __syncthreads();
    int below = 0;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const float zi = zs[i];
      if (zi != zi) continue;
      const float y = value(i, zi);
      if (y != y) continue;  // the plain version never counts a NaN
      vt::count_leaf(vt::leaf_of(y, tree, bits), leaves, hist, below);
    }
    vt::flush_below(below, hist);
    ex.cl.sync();
    for (int i = threadIdx.x; i < leaves; i += blockDim.x)
      ex.tot[i] = over_cluster<int>(ex.cl, hist, i, vt::SumOp());
    __syncthreads();
    ex.par ^= 1;
    vt::walk_leaves(ex.tot, bits, target, a, b);  // every warp, the same bits
  }
}

// One fit a cluster of kCtas CTAs, of plane blockIdx.y; CTA `rank` holds
// elements [rank * chunk, (rank + 1) * chunk) of the plane in dynamic shared
// memory.
template <int kCoef, bool kVec>
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads)
polyfit_kernel(const float* __restrict__ z, const uint8_t* __restrict__ mask,
               float* __restrict__ out, int h, int w, int iters, int resigma_iters,
               float cauchy_c, int levels, int chunk) {
  z += (size_t)blockIdx.y * h * w;
  mask += (size_t)blockIdx.y * h * w;
  out += (size_t)blockIdx.y * kCoef;
  constexpr int kPairs = kCoef * (kCoef + 1) / 2;
  constexpr int kSums = kPairs + kCoef;  // normal matrix, then right-hand side
  static_assert(kSums + 1 <= kSlotWords, "the sums and the count fit a slot");
  extern __shared__ float zs[];
  __shared__ int slot[2][kSlotWords];
  __shared__ int tot[kSlotWords];
  __shared__ float tree[vt::kLeaves];
  __shared__ float red[kSums * 33];
  __shared__ int redi[33];

  Exchange ex{cg::this_cluster(), slot, tot, 0};
  const int n = h * w;
  const int begin = min(n, (int)ex.cl.block_rank() * chunk);
  const int len = min(n, begin + chunk) - begin;
  const Basis<kCoef> basis{0.5f * (float)(w - 1), 0.5f * (float)(h - 1), w};

  int cnt = 0;
  vt::for_each_masked<kVec>(z, mask, begin, begin + len, [&](int i, float v, bool ok) {
    zs[i - begin] = ok ? v : __int_as_float(0x7fc00000);
    cnt += ok ? 1 : 0;
  });
  cnt = vt::block_sum(cnt, redi);  // its barrier also publishes zs

  float coef[kCoef];
#pragma unroll
  for (int a = 0; a < kCoef; ++a) coef[a] = 0.0f;
  float sigma = 1.0f;
  int nvalid = 0;
  for (int round = 0; round < iters; ++round) {
    const float cs = cauchy_c * sigma;
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.0f;
    // pixels outside the mask have weight 0 and add nothing
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const float zi = zs[i];
      if (zi != zi) continue;
      float col[kCoef];
      basis.at(begin + i, col);
      float wt = 1.0f;
      if (round > 0) {
        const float u = basis.residual(zi, coef, col) / cs;
        wt = 1.0f / (1.0f + u * u);
      }
      const float w2 = wt * wt;
      int q = 0;
#pragma unroll
      for (int a = 0; a < kCoef; ++a)
#pragma unroll
        for (int b = a; b < kCoef; ++b) acc[q++] += (w2 * col[a]) * col[b];
#pragma unroll
      for (int a = 0; a < kCoef; ++a) acc[kPairs + a] += (w2 * col[a]) * zi;
    }
    vt::block_reduce(acc, red, vt::SumOp(), 0.0f);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) slot[ex.par][q] = __float_as_int(acc[q]);
      slot[ex.par][kSums] = cnt;
    }
    ex.cl.sync();
    if (threadIdx.x < kSums)
      tot[threadIdx.x] = __float_as_int(
          over_cluster<float>(ex.cl, slot[ex.par], threadIdx.x, vt::SumOp()));
    else if (threadIdx.x == kSums)
      tot[kSums] = over_cluster<int>(ex.cl, slot[ex.par], kSums, vt::SumOp());
    __syncthreads();
    ex.par ^= 1;
    nvalid = tot[kSums];
    chol_solve(tot, coef);  // every thread, the same bits

    if (round < resigma_iters) {
      float lo[1] = {INFINITY}, hi[1] = {-INFINITY};
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const float zi = zs[i];
        if (zi != zi) continue;
        float col[kCoef];
        basis.at(begin + i, col);
        const float r = basis.residual(zi, coef, col);
        lo[0] = fminf(lo[0], r);
        hi[0] = fmaxf(hi[0], r);
      }
      vt::block_reduce(lo, red, vt::MinOp(), INFINITY);
      vt::block_reduce(hi, red, vt::MaxOp(), -INFINITY);
      if (threadIdx.x == 0) {
        slot[ex.par][0] = __float_as_int(lo[0]);
        slot[ex.par][1] = __float_as_int(hi[0]);
      }
      ex.cl.sync();
      if (threadIdx.x == 0)
        tot[0] = __float_as_int(over_cluster<float>(ex.cl, slot[ex.par], 0, vt::MinOp()));
      else if (threadIdx.x == 1)
        tot[1] = __float_as_int(over_cluster<float>(ex.cl, slot[ex.par], 1, vt::MaxOp()));
      __syncthreads();
      ex.par ^= 1;
      float rlo = __int_as_float(tot[0]), rhi = __int_as_float(tot[1]);
      if (nvalid < n) {  // the plain version's where(valid, r, +-3e38) extremes
        rlo = fminf(rlo, vt::kBig);
        rhi = fmaxf(rhi, -vt::kBig);
      }
      const float target = 0.5f * vt::jmax((float)nvalid - 1.0f, 0.0f);
      auto resid = [&](int i, float zi) {
        float col[kCoef];
        basis.at(begin + i, col);
        return basis.residual(zi, coef, col);
      };
      float a = rlo, b = rhi;
      cluster_ladder(ex, zs, len, tree, levels, target, a, b, resid);
      const float med = 0.5f * (a + b);
      a = 0.0f;
      b = vt::jmax(rhi - med, med - rlo);
      cluster_ladder(ex, zs, len, tree, levels, target, a, b,
                     [&](int i, float zi) { return fabsf(resid(i, zi) - med); });
      const float mad = 0.5f * (a + b);
      sigma = 1.4826f * (mad + 1e-6f);
    }
  }
  if (ex.cl.block_rank() == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a < kCoef; ++a) out[a] = nvalid >= 200 ? coef[a] : 0.0f;
  }
  ex.cl.sync();  // no CTA leaves while another may still read its slots
}

template <int kCoef>
cudaError_t launch_fit(const float* z, const uint8_t* mask, float* out, int planes, int h,
                       int w, int iters, int resigma_iters, float cauchy_c, int levels,
                       cudaStream_t st) {
  const int n = h * w;
  const int chunk = fit_chunk(n);
  const auto kernel = vt::vector_loads(z, mask, n) ? polyfit_kernel<kCoef, true>
                                                   : polyfit_kernel<kCoef, false>;
  const int bytes = chunk * (int)sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kCtas, planes), kThreads, bytes, st>>>(z, mask, out, h, w, iters,
                                                      resigma_iters, cauchy_c, levels, chunk);
  return cudaGetLastError();
}

}  // namespace

// z, mask: (planes, h, w) with h * w <= kMaxElems; out: (planes, ncoef),
// ncoef 3 (order 1) or 6 (order 2).  One launch of `planes` clusters on
// `stream`.
extern "C" int vt_robust_polyfit2d(const float* z, const uint8_t* mask, float* out,
                                   int planes, int h, int w, int ncoef, int iters,
                                   int resigma_iters, float cauchy_c, int levels,
                                   void* stream) {
  if (h < 1 || w < 1 || (long long)h * w > kMaxElems || (ncoef != 3 && ncoef != 6) ||
      iters < 0 || levels < 0 || planes < 1 || planes > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      ncoef == 6
          ? launch_fit<6>(z, mask, out, planes, h, w, iters, resigma_iters, cauchy_c, levels, st)
          : launch_fit<3>(z, mask, out, planes, h, w, iters, resigma_iters, cauchy_c, levels, st);
  return (int)err;
}
