// K3: diffusion inpaint, one CTA per plane.
//
// Replaces the JAX package's pallas/inpaint_kernel.py::inpaint_diffusion_pallas.
// Unknown pixels start at the mean of the known ones; then `iters` Jacobi
// steps of avg3(cur * w) / max(avg3(w), 1e-6) with an edge-replicate
// border, summed in the TPU kernel's order: (left + centre) + right along
// the row, then (up + mid) + down.  w <- min(w + [den > 1e-6], 1); known
// pixels stay clamped to the input.  The state ping-pongs between two
// (cur, w) plane pairs in device memory, with a block barrier per step.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

struct Plane {
  const float* cur;
  const float* wt;
  int h, w;
  // (cur * w) at (r, c) and w at (r, c), edge-replicated
  __device__ __forceinline__ void at(int r, int c, float* num, float* den) const {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    const int i = r * w + c;
    *den = wt[i];
    *num = cur[i] * wt[i];
  }
  __device__ __forceinline__ void row3(int r, int c, float* num, float* den) const {
    float nl, dl, nc, dc, nr, dr;
    at(r, c - 1, &nl, &dl);
    at(r, c, &nc, &dc);
    at(r, c + 1, &nr, &dr);
    *num = (nl + nc) + nr;
    *den = (dl + dc) + dr;
  }
};

__global__ void __launch_bounds__(kThreads)
inpaint_kernel(const float* __restrict__ img, const uint8_t* __restrict__ fill,
               float* __restrict__ out, float* __restrict__ scratch, int h, int w,
               int iters) {
  __shared__ float redf[2 * 33];
  const int n = h * w;
  const size_t base = (size_t)blockIdx.x * n;
  const float* x = img + base;
  const uint8_t* unknown = fill + base;
  // ping-pong state: (cur[0], wt[0]) and (cur[1], wt[1])
  float* cur[2] = {out + base, scratch + 3 * base};
  float* wt[2] = {scratch + 3 * base + n, scratch + 3 * base + 2 * n};

  float s = 0.0f, k = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!unknown[i]) {
      s = s + x[i];
      k = k + 1.0f;
    }
  }
  float sums[2] = {s, k};
  vt::block_reduce(sums, redf, vt::SumOp(), 0.0f);
  const float mean0 = sums[0] / vt::jmax(sums[1], 1.0f);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool known = !unknown[i];
    cur[0][i] = known ? x[i] : mean0;
    wt[0][i] = known ? 1.0f : 0.0f;
  }
  __syncthreads();

  int src = 0;
  for (int it = 0; it < iters; ++it) {
    const Plane p{cur[src], wt[src], h, w};
    float* ncur = cur[src ^ 1];
    float* nwt = wt[src ^ 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      float nu, du, nm, dm, nd, dd;
      p.row3(r - 1, c, &nu, &du);
      p.row3(r, c, &nm, &dm);
      p.row3(r + 1, c, &nd, &dd);
      const float num = (nu + nm) + nd;
      const float den = (du + dm) + dd;
      const bool grow = den > 1e-6f;
      const float upd = num / vt::jmax(den, 1e-6f);
      nwt[i] = vt::jmin(p.wt[i] + (grow ? 1.0f : 0.0f), 1.0f);
      ncur[i] = !unknown[i] ? x[i] : (grow ? upd : p.cur[i]);
    }
    __syncthreads();
    src ^= 1;
  }
  if (src == 1) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) cur[0][i] = cur[1][i];
  }
}

}  // namespace

// img, fill, out: (batch, h, w); scratch: (batch, 3, h, w).
extern "C" int vt_inpaint_diffusion(const float* img, const uint8_t* fill, float* out,
                                    float* scratch, int batch, int h, int w, int iters,
                                    void* stream) {
  if (batch < 1 || h < 1 || w < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  inpaint_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(img, fill, out, scratch, h,
                                                               w, iters);
  return (int)cudaGetLastError();
}
