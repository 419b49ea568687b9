// K3: diffusion inpaint, tiled over many CTAs and blocked in time.
//
// Replaces the JAX package's pallas/inpaint_kernel.py::inpaint_diffusion_pallas.
// Unknown pixels start at the mean of the known ones; then `iters` Jacobi
// steps of avg3(cur * w) / max(avg3(w), 1e-6) with an edge-replicate
// border, summed in the TPU kernel's order: (left + centre) + right along
// the row, then (up + mid) + down.  w <- min(w + [den > 1e-6], 1); known
// pixels stay clamped to the input.
//
// Bound.  The function must read the image and the mask once and write the
// result (9 bytes a pixel: 24 MB at the 1608x1664 temperature crop, 7 us of
// HBM time); its 24 operations a pixel a step are far below the card's rate.
// What costs is the step-to-step dependence: every step reads its
// neighbours' previous state, so the plane cannot be split without halos.
//
// Design.  Each plane is covered with kTileH x kTileW output tiles, one CTA
// each (grid: tiles x batch).  A CTA stages its tile plus a halo of kHalo
// pixels of the state (cur as f32; w, exactly 0 or 1 at every step, and the
// known flag as bytes) in shared memory, runs up to kHalo steps there (the
// valid region shrinks by one pixel a step) and writes its tile's interior.
// A step is separable: one pass takes the row sums (left + centre) + right
// of cur * w and of w, a second the column sums (up + mid) + down and
// updates each pixel in place, since it reads only the row sums and its own
// state.  A call makes ceil(iters / kHalo) step launches (at least one, which
// for iters = 0 writes the initial state), plus one launch of fixed-order
// partial sums for the initial mean; the state crosses launches in device
// memory as (cur f32, w u8), 5 bytes a pixel each way.  Neighbour reads clamp
// to the plane before they index the staged region, which holds every pixel
// of the plane within kHalo of the tile, so each step reproduces the
// edge-replicate border and every pixel computes, in the same order and
// rounding (--fmad=false), what the plain version computes from the same
// state.  The initial mean is the sum of the known pixels over their count:
// kMeanCtas CTAs take per-CTA partials in a fixed order, and warp 0 of every
// CTA of the first step launch combines them in a fixed order (each lane's
// share in turn, then a butterfly), so it has the same bits on every run; it
// may differ from torch.sum's order by rounding, which shows only in pixels
// no step reaches.  Everything else is bit-equal.
//
// The choice: 32 x 64 tiles with kHalo = 4 stage a 40 x 72 region: 40.3 KB
// of static shared memory (cur and the two row sums as f32, w and the known
// flags as bytes) on 512 threads, so three CTAs fit on an SM by shared
// memory; the steps recompute 20% of the tile's pixels in the halo and the
// loads read 1.4x the tile.  Warps walk rows and lanes columns, so no thread
// divides.  ptxas (sm_90a): 40 registers and 40,324 bytes of shared memory
// for the step kernel, 16 registers for the mean kernel.  On an H100 a
// 4-step launch still takes several times the bytes' time; which of
// instruction issue, barriers and latency limits it is not measured.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kTileH = 32, kTileW = 64, kHalo = 4;
constexpr int kRegH = kTileH + 2 * kHalo, kRegW = kTileW + 2 * kHalo;
constexpr int kMeanCtas = 256;  // mean partials per plane

// Partial (sum of known pixels, count of known pixels) over the j-th of
// kMeanCtas chunks of each plane.  grid (kMeanCtas, batch).
__global__ void __launch_bounds__(kThreads)
inpaint_mean_kernel(const float* __restrict__ img, const uint8_t* __restrict__ fill,
                    float* __restrict__ partials, int n) {
  __shared__ float red[2 * 33];
  const size_t base = (size_t)blockIdx.y * n;
  const int chunk = (n + kMeanCtas - 1) / kMeanCtas;
  const int begin = min(n, (int)blockIdx.x * chunk);
  const int end = min(n, begin + chunk);
  float s = 0.0f, k = 0.0f;
  for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
    if (!fill[base + i]) {
      s = s + img[base + i];
      k = k + 1.0f;
    }
  }
  float sums[2] = {s, k};
  vt::block_reduce(sums, red, vt::SumOp(), 0.0f);
  if (threadIdx.x == 0) {
    float* out = partials + 2 * ((size_t)blockIdx.y * kMeanCtas + blockIdx.x);
    out[0] = sums[0];
    out[1] = sums[1];
  }
}

// `steps` (<= kHalo) Jacobi steps on one tile.  The first launch (cur_in
// null) builds the initial state from img, fill and the mean partials;
// w_out may be null (the last launch).  grid (tiles, batch).
__global__ void __launch_bounds__(kThreads)
inpaint_steps_kernel(const float* __restrict__ img, const uint8_t* __restrict__ fill,
                     const float* __restrict__ partials, const float* __restrict__ cur_in,
                     const uint8_t* __restrict__ w_in, float* __restrict__ cur_out,
                     uint8_t* __restrict__ w_out, int h, int w, int steps, int tiles_x) {
  constexpr int kReg = kRegH * kRegW;
  __shared__ float cur[kReg];
  __shared__ float hnum[kReg], hden[kReg];  // row sums of cur * w and of w
  __shared__ uint8_t wt[kReg];
  __shared__ uint8_t known[kReg];
  __shared__ float mean0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const size_t base = (size_t)blockIdx.y * h * w;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW;
  // the staged region: the tile and its halo, inside the plane
  const int r0 = max(0, ty0 - kHalo), c0 = max(0, tx0 - kHalo);
  const int r1 = min(h, ty0 + kTileH + kHalo), c1 = min(w, tx0 + kTileW + kHalo);
  const int rw = c1 - c0;
  auto li = [&](int r, int c) { return (r - r0) * rw + (c - c0); };

  const bool first = cur_in == nullptr;
  if (first && warp == 0) {
    // the partials in a fixed order: each lane's in turn, then a butterfly
    const float* pp = partials + 2 * (size_t)blockIdx.y * kMeanCtas;
    float s = 0.0f, k = 0.0f;
    for (int j = lane; j < kMeanCtas; j += 32) {
      s = s + pp[2 * j];
      k = k + pp[2 * j + 1];
    }
    s = vt::warp_reduce(s, vt::SumOp());
    k = vt::warp_reduce(k, vt::SumOp());
    if (lane == 0) mean0 = s / vt::jmax(k, 1.0f);
  }
  __syncthreads();
  for (int r = r0 + warp; r < r1; r += nwarps) {
    for (int c = c0 + lane; c < c1; c += 32) {
      const size_t g = base + (size_t)r * w + c;
      const bool kn = !fill[g];
      const int i = li(r, c);
      known[i] = kn;
      cur[i] = first ? (kn ? img[g] : mean0) : cur_in[g];
      wt[i] = first ? kn : w_in[g];
    }
  }
  __syncthreads();

  for (int s = 1; s <= steps; ++s) {
    // this step's valid region: the tile grown by kHalo - s, inside the plane
    const int m = kHalo - s;
    const int a0 = max(0, ty0 - m), a1 = min(h, ty0 + kTileH + m);
    const int b0 = max(0, tx0 - m), b1 = min(w, tx0 + kTileW + m);
    // row sums (left + centre) + right, the column clamped to the plane, on
    // the rows the column sums read
    for (int r = max(0, a0 - 1) + warp; r < min(h, a1 + 1); r += nwarps) {
      for (int c = b0 + lane; c < b1; c += 32) {
        const int il = li(r, max(c - 1, 0)), ic = li(r, c), ir = li(r, min(c + 1, w - 1));
        const float dl = (float)wt[il], dc = (float)wt[ic], dr = (float)wt[ir];
        hnum[ic] = (cur[il] * dl + cur[ic] * dc) + cur[ir] * dr;
        hden[ic] = (dl + dc) + dr;
      }
    }
    __syncthreads();
    // column sums (up + mid) + down, the row clamped, and the update in
    // place: each pixel reads only the row sums and its own state
    for (int r = a0 + warp; r < a1; r += nwarps) {
      for (int c = b0 + lane; c < b1; c += 32) {
        const int iu = li(max(r - 1, 0), c), ic = li(r, c), id = li(min(r + 1, h - 1), c);
        const float num = (hnum[iu] + hnum[ic]) + hnum[id];
        const float den = (hden[iu] + hden[ic]) + hden[id];
        const bool grow = den > 1e-6f;
        const float upd = num / vt::jmax(den, 1e-6f);
        const float wv = (float)wt[ic];
        wt[ic] = vt::jmin(wv + (grow ? 1.0f : 0.0f), 1.0f) != 0.0f;
        if (!known[ic] && grow) cur[ic] = upd;
      }
    }
    __syncthreads();
  }

  for (int r = ty0 + warp; r < min(h, ty0 + kTileH); r += nwarps) {
    for (int c = tx0 + lane; c < min(w, tx0 + kTileW); c += 32) {
      const size_t g = base + (size_t)r * w + c;
      cur_out[g] = cur[li(r, c)];
      if (w_out) w_out[g] = wt[li(r, c)];
    }
  }
}

}  // namespace

// float elements of fscratch vt_inpaint_diffusion needs: a state plane per
// plane and the mean partials.  wscratch holds 2 * batch * h * w bytes.
extern "C" int vt_inpaint_scratch(int batch, int h, int w) {
  if (batch < 1 || h < 1 || w < 1) return -1;
  return batch * (h * w + 2 * kMeanCtas);
}

// img, fill, out: (batch, h, w).  Enqueues 1 + max(1, ceil(iters / kHalo))
// launches on `stream`.
extern "C" int vt_inpaint_diffusion(const float* img, const uint8_t* fill, float* out,
                                    float* fscratch, uint8_t* wscratch, int batch, int h,
                                    int w, int iters, void* stream) {
  if (batch < 1 || h < 1 || w < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t n = (size_t)h * w;
  float* partials = fscratch + batch * n;
  inpaint_mean_kernel<<<dim3(kMeanCtas, batch), kThreads, 0, st>>>(img, fill, partials,
                                                                   (int)n);
  cudaError_t err = cudaGetLastError();
  const int tiles_x = (w + kTileW - 1) / kTileW, tiles_y = (h + kTileH - 1) / kTileH;
  const dim3 grid(tiles_x * tiles_y, batch);
  const int launches = iters > 0 ? (iters + kHalo - 1) / kHalo : 1;
  // cur alternates between out and fscratch so that the last launch writes out
  float* cur[2] = {out, fscratch};
  uint8_t* wts[2] = {wscratch, wscratch + batch * n};
  for (int k = 0; k < launches && err == cudaSuccess; ++k) {
    const int steps = iters - k * kHalo < kHalo ? iters - k * kHalo : kHalo;
    const bool last = k == launches - 1;
    inpaint_steps_kernel<<<grid, kThreads, 0, st>>>(
        img, fill, partials, k ? cur[(launches - k) & 1] : nullptr, k ? wts[(k - 1) & 1] : nullptr,
        cur[(launches - 1 - k) & 1], last ? nullptr : wts[k & 1], h, w, steps, tiles_x);
    err = cudaGetLastError();
  }
  return (int)err;
}
