// Section render: resample [z, h, w] images at dense (y, x) coordinates with
// nearest, linear, cubic or normalized Lanczos4 weights, one thread per
// output pixel gathering its tap window straight from device memory.
//
// Replaces sofima_tpu/ops/pallas_warp.py `_warp_tiled_kernel` (entry
// pallas_shift_warp_tiled), and serves its `two_pass=True` variant
// (`_warp_tiled_sep_kernel`) with the exact render. The TPU kernel has
// no cheap gather, so it sweeps a static integer-shift lattice over a
// DMA'd halo window with per-tile bases; Hopper gathers well, so here
// each pixel reads only its own 8x8 (Lanczos), 4x4 (cubic), 2x2 (linear)
// or 1 (nearest) taps. No envelope is needed: every in-image tap is
// reachable (the port's tiled_plan_device still reports the `overflow`
// the TPU kernel would have zeroed).
//
// What bounds it on the H100: memory traffic. A 10k^2 section reads 8 B
// of coordinates and writes 4 B per pixel (1.2 GB per section); the tap
// reads (64 per Lanczos pixel) hit L1/L2 because neighbouring threads
// read neighbouring pixels, so the kernel is designed around coalesced
// row-major thread order and reuse in cache rather than staging tiles
// in shared memory. The weights keep the reference's numerics: the
// range-reduced sin(pi d) and quarter-angle planes (sofima_tpu commit
// 78165d3), |t| < 1e-6 -> 1, |t| >= 4 -> 0, taps outside the image read
// 0 but count in the norm, the norm is sum(w_y) * sum(w_x) clamped at
// 1e-12, and the row sums are accumulated in the reference's order.
// NaN coordinates render 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_weights.cuh"

namespace {

using sofima::kLanczos;
using sofima::Planes;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ img, const float* __restrict__ coords,
                   float* __restrict__ out, int h, int w, int oy, int ox,
                   int method, int taps, int left) {
  const int64_t plane = (int64_t)oy * ox;
  const int z = blockIdx.y;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int y = (int)(p / ox), x = (int)(p - (int64_t)y * ox);
    const float cy = __ldg(coords + ((int64_t)z * 2) * plane + p);
    const float cx = __ldg(coords + ((int64_t)z * 2 + 1) * plane + p);
    float result = 0.0f;
    // NaN (and absurdly far) coordinates have no tap in range: 0.
    if (fabsf(cy - (float)y) < 1e8f && fabsf(cx - (float)x) < 1e8f) {
      const float dy = cy - (float)y, dx = cx - (float)x;
      const Planes qy = method == kLanczos ? sofima::lanczos_planes(dy) : Planes{};
      const Planes qx = method == kLanczos ? sofima::lanczos_planes(dx) : Planes{};
      // First tap: the lowest integer shift whose weight can be non-zero
      // (nearest scans floor(d) and floor(d) + 1; exactly one has weight 1).
      const int sy0 = (int)floorf(dy) - left;
      const int sx0 = (int)floorf(dx) - left;
      const float* src = img + (int64_t)z * h * w;
      float acc = 0.0f, norm_y = 0.0f, norm_x = 0.0f;
      float wx[8];
      for (int j = 0; j < taps; ++j) {
        wx[j] = sofima::weight(method, dx, qx, sx0 + j);
        norm_x += wx[j];
      }
      for (int i = 0; i < taps; ++i) {
        const int s = sy0 + i;
        const float wy = sofima::weight(method, dy, qy, s);
        norm_y += wy;
        const int row = y + s;
        float inner = 0.0f;
        if (row >= 0 && row < h) {
          const float* r = src + (int64_t)row * w;
          for (int j = 0; j < taps; ++j) {
            const int col = x + sx0 + j;
            const float v = (col >= 0 && col < w) ? __ldg(r + col) : 0.0f;
            inner += wx[j] * v;
          }
        }
        acc += wy * inner;
      }
      result = method == kLanczos ? acc / fmaxf(norm_y * norm_x, 1e-12f) : acc;
    }
    out[(int64_t)z * plane + p] = result;
  }
}

}  // namespace

extern "C" {

// img: [z, h, w]; coords: [z, 2, oy, ox] (y, x); out: [z, oy, ox].
// method: 0 nearest, 1 linear, 2 cubic, 3 lanczos. Returns cudaGetLastError().
int warp_gather_launch(const float* img, const float* coords, float* out,
                       int nz, int h, int w, int oy, int ox, int method,
                       void* stream) {
  static const int kTaps[4] = {2, 2, 4, 8};
  static const int kLeft[4] = {0, 0, 1, 3};
  if (method < 0 || method > 3 || nz > 65535) return (int)cudaErrorInvalidValue;
  const int64_t plane = (int64_t)oy * ox;
  int64_t blocks = (plane + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  if (blocks < 1) blocks = 1;
  warp_gather_kernel<<<dim3((unsigned)blocks, nz), kThreads, 0,
                       (cudaStream_t)stream>>>(img, coords, out, h, w, oy, ox,
                                               method, kTaps[method],
                                               kLeft[method]);
  return (int)cudaGetLastError();
}

}  // extern "C"
