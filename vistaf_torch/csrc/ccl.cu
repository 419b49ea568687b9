// Connected-component labelling (8-connected) by union-find on the card.
//
// Replaces no Pallas kernel.  The JAX package labels with an XLA while loop
// (ops/components.py::label: rounds of neighbour-min propagation and 8
// pointer jumps until no label changes) and reconstructs by dilation with
// another (ops/morphology.py::reconstruct); both loops stay inside its one
// compiled forward.  The port's plain loops test convergence on the host once
// a round; this kernel gives the same labels in a fixed number of launches
// with no host read, so the forward that holds it can be captured into one
// CUDA graph.
//
// Result: each foreground pixel gets the flat row-major index of its
// component's minimum pixel, each background pixel -1 (int64), as the JAX
// label gives.  A (B, h, w) stack of masks is labelled plane by plane in the
// same three launches, the planes on grid.z (grid.y of the flatten), as
// jax.vmap of the label gives it: the indices are each plane's own.
//
// Bound.  The function must read the mask (1 byte a pixel) and write the
// labels (8 bytes a pixel): 0.5 MB at the 640x480 preset's 236x236 crop,
// 0.15 us at 3.35 TB/s, and 12.6 MB at the native-4K crop (1182x1182); a
// few integer compares a pixel are far below the card's rate.  At 236^2 the
// three launches' latency is the cost.
//
// Design (the block-based union-find of Allegretti et al. 2020, with the
// union of Playne and Hawick 2018).  A parent array L (int32) holds, for
// each pixel, an index no larger than its own in the same component; a root
// points to itself.  Three launches:
//   1. tile: one CTA a 16 x 32 tile, one thread a pixel, unites each
//      foreground pixel with its foreground W, NW, N and NE neighbours inside
//      the tile on a tile-local parent array in shared memory, then writes
//      each pixel's global L as the global index of its tile-local root;
//   2. border: each foreground pixel unites with those of its W, NW, N and
//      NE foreground neighbours that lie in another tile, on L in device
//      memory;
//   3. flatten: each foreground pixel follows L to its root and writes it,
//      each background pixel -1.
// Every 8-neighbour pair is seen once, from its later pixel in row-major
// order.  A union links the larger of two roots under the smaller with an
// integer atomicMin and, where the larger had meanwhile been linked
// elsewhere, goes on uniting that parent with the smaller; parents only ever
// decrease and stay in the component, so each tree's root is its minimum
// pixel whatever order the atomics land in, and the labels are the same bits
// on every run (integer atomics only; no float atomics).  Inside a tile the
// local order of (row, column) is the global one, so a tile-local root maps
// to the tile component's global minimum.  Reads of L that race with other
// threads' unions go through volatile loads; a stale parent is still an
// ancestor, so the walk stays correct.
#include "common.cuh"

namespace {

constexpr int kTileH = 16, kTileW = 32, kThreads = kTileH * kTileW;

__device__ __forceinline__ int find_root(const volatile int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

// Unite the sets of a and b (Playne and Hawick's reduction): link the larger
// root under the smaller; where the larger is no longer a root, go on with
// the parent it was linked under.
__device__ __forceinline__ void unite(int* L, int a, int b) {
  a = find_root(L, a);
  b = find_root(L, b);
  while (a != b) {
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&L[a], b);
    if (old == a) return;
    a = old;
  }
}

__device__ __forceinline__ bool fg_at(const uint8_t* __restrict__ mask, int y, int x, int h,
                                      int w) {
  return y >= 0 && x >= 0 && x < w && y < h && mask[(size_t)y * w + x];
}

// grid (tiles_x, tiles_y, planes), kThreads threads.
__global__ void __launch_bounds__(kThreads)
ccl_tile_kernel(const uint8_t* __restrict__ mask, int* __restrict__ L, int h, int w) {
  __shared__ int s[kThreads];
  mask += (size_t)blockIdx.z * h * w;
  L += (size_t)blockIdx.z * h * w;
  const int li = threadIdx.x;
  const int tx = li % kTileW, ty = li / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < w && y < h;
  const bool fg = inside && mask[(size_t)y * w + x];
  s[li] = li;
  __syncthreads();
  if (fg) {
    if (tx > 0 && fg_at(mask, y, x - 1, h, w)) unite(s, li, li - 1);
    if (ty > 0) {
      if (tx > 0 && fg_at(mask, y - 1, x - 1, h, w)) unite(s, li, li - kTileW - 1);
      if (fg_at(mask, y - 1, x, h, w)) unite(s, li, li - kTileW);
      if (tx < kTileW - 1 && fg_at(mask, y - 1, x + 1, h, w)) unite(s, li, li - kTileW + 1);
    }
  }
  __syncthreads();
  if (inside) {
    const int r = fg ? find_root(s, li) : li;
    L[(size_t)y * w + x] = (y0 + r / kTileW) * w + x0 + r % kTileW;
  }
}

// grid (tiles_x, tiles_y, planes), kThreads threads: the pairs that cross a
// tile's top row or its left or right column.
__global__ void __launch_bounds__(kThreads)
ccl_border_kernel(const uint8_t* __restrict__ mask, int* L, int h, int w) {
  mask += (size_t)blockIdx.z * h * w;
  L += (size_t)blockIdx.z * h * w;
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x = blockIdx.x * kTileW + tx, y = blockIdx.y * kTileH + ty;
  if (x >= w || y >= h || (tx > 0 && ty > 0 && tx < kTileW - 1)) return;
  if (!mask[(size_t)y * w + x]) return;
  const int i = y * w + x;
  if (tx == 0 && fg_at(mask, y, x - 1, h, w)) unite(L, i, i - 1);
  if ((tx == 0 || ty == 0) && fg_at(mask, y - 1, x - 1, h, w)) unite(L, i, i - w - 1);
  if (ty == 0 && fg_at(mask, y - 1, x, h, w)) unite(L, i, i - w);
  if ((ty == 0 || tx == kTileW - 1) && fg_at(mask, y - 1, x + 1, h, w)) unite(L, i, i - w + 1);
}

// grid (ceil(n / 256), planes), 256 threads.
__global__ void __launch_bounds__(256)
ccl_flatten_kernel(const uint8_t* __restrict__ mask, const int* L, long long* __restrict__ out,
                   int n) {
  mask += (size_t)blockIdx.y * n;
  L += (size_t)blockIdx.y * n;
  out += (size_t)blockIdx.y * n;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  out[i] = mask[i] ? (long long)find_root(L, i) : -1LL;
}

}  // namespace

// mask: (planes, h, w) bytes 0/1; parent: planes * h * w int32 of scratch;
// out: (planes, h, w) int64.  Enqueues 3 launches on `stream`.
extern "C" int vt_label_components(const uint8_t* mask, int* parent, long long* out,
                                   int planes, int h, int w, void* stream) {
  if (h < 1 || w < 1 || (long long)h * w >= (1LL << 31) || planes < 1 || planes > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 tiles((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, planes);
  ccl_tile_kernel<<<tiles, kThreads, 0, st>>>(mask, parent, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_border_kernel<<<tiles, kThreads, 0, st>>>(mask, parent, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = h * w;
  ccl_flatten_kernel<<<dim3((n + 255) / 256, planes), 256, 0, st>>>(mask, parent, out, n);
  return (int)cudaGetLastError();
}
