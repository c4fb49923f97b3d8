// K4, the section render: resample [z, h, w] images at dense (y, x)
// coordinates with nearest, linear, cubic or normalized Lanczos4 weights.
// Also serves the library API's renders: `warp.warp_subvolume` (the
// reference's K4p) and 2d `warp.ndimage_warp` (K12), under their own
// launch counters.
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
// What bounds it on the H100: bilinear, memory (16 B per pixel: 8 of
// coordinates, 4 of image, 4 of output; 0.48 ms at 10k^2) and the latency
// of two dependent reads (coordinates, then taps); Lanczos, the issue rate
// of its per-pixel work (16 weights, 64 taps), which a fast kernel has to
// keep in registers and feed from shared memory. The design:
//  * one instantiation per method: the tap count and offset are
//    compile-time, every tap loop unrolls and the weights stay in
//    registers;
//  * 2-D tiles: each warp owns a 32 x 6 (cubic: 32 x 8) tile, one column
//    per lane and a pixel per row, whose coordinate reads are all in
//    flight at once; two warps side by side a block; 32-bit in-plane
//    indices, a 64-bit base per plane and per source row;
//  * shared-memory staging per warp tile, with no block barrier: the warp
//    reduces the bounds of its pixels' first taps; if its source window
//    (their extent plus taps - 1) holds at most kWinFloats floats, the
//    warp copies it in (coalesced, eight reads in flight per lane, 0
//    outside the image) and gathers from there; otherwise (a field that
//    tears or scatters) the tile gathers from global memory through L1,
//    with per-tap bounds checks. Both branches read the same values and
//    sum them in the same order, so they agree bit for bit;
//  * Lanczos weights from one sinpif and one sincospif per axis: with
//    t0 = d - s0 (s0 the first tap), sin(pi d) (-1)^s = sin(pi t0) (-1)^j
//    and sin(pi t / 4) = sin(pi t0 / 4) cos(pi j / 4) - cos(pi t0 / 4)
//    sin(pi j / 4) for tap j, and each tap divides with __fdividef (two
//    instructions, 2 ulp). This changes the weights in their last bits
//    against the range-reduced planes of sofima_tpu commit 78165d3 (the
//    plain version's); renders move by ~1e-4 gray.
// Coordinates are read as scalars: a warp's 32 neighbouring columns are
// one 128-byte line, and the gather wants lanes on neighbouring columns.
//
// Numerics otherwise unchanged: |t| < 1e-6 -> 1 and |t| >= 4 -> 0 for
// Lanczos, taps outside the image read 0 but count in the norm, the norm
// sum(w_y) * sum(w_x) clamped at 1e-12, row sums in the reference's
// order; NaN coordinates, and coordinates 1e8 or more away, render 0.
// Nearest, linear and cubic weights are sofima::poly_weights, evaluated
// from f = d - floor(d) (last-bit differences from the plain version's
// per-tap t = d - s).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "warp_weights.cuh"

namespace {

using sofima::kCubic;
using sofima::kLanczos;
using sofima::kLinear;
using sofima::kNearest;

constexpr int kWarps = 2;            // warp tiles per block, side by side
constexpr int kThreads = 32 * kWarps;
constexpr int kWinFloats = 1024;      // staged window per warp, at most
constexpr int kStageUnroll = 8;      // window reads in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// Taps per axis, the offset of the first (nearest scans floor(d) and
// floor(d) + 1; exactly one has weight 1), and the rows of a warp tile
// (32 columns; 8 rows for cubic and 6 for the rest, each the faster
// on the H100 at 10k^2).
template <int M>
struct Taps {
  static constexpr int kTaps = M == kCubic ? 4 : (M == kLanczos ? 8 : 2);
  static constexpr int kLeft = M == kCubic ? 1 : (M == kLanczos ? 3 : 0);
  static constexpr int kRows = M == kCubic ? 8 : 6;
};

// Weights of the taps at integer shifts s0 .. s0 + kTaps - 1 from offset d
// (s0 = floor(d) - kLeft).
template <int M>
__device__ __forceinline__ void axis_weights(float d, int s0, float* w) {
  constexpr int T = Taps<M>::kTaps;
  if constexpr (M == kLanczos) {
    // t_j = d - (s0 + j) = t0 - j, t0 in [3, 4].
    const float t0 = d - (float)s0;
    float s4, c4;
    sincospif(0.25f * t0, &s4, &c4);
    const float a = 4.0f * sinpif(t0);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float t = t0 - (float)j;
      const float at = fabsf(t);
      const float sp = __fsub_rn(__fmul_rn(s4, sofima::kCos8[j]),
                                 __fmul_rn(c4, sofima::kSin8[j]));
      const float x2 = fmaxf((sofima::kPi * t) * (sofima::kPi * t), 1e-12f);
      const float wv =
          at < 1e-6f ? 1.0f : __fdividef(((j & 1) ? -a : a) * sp, x2);
      w[j] = at < 4.0f ? wv : 0.0f;
    }
  } else {
    sofima::poly_weights<M>(d, w);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
warp_gather_kernel(const float* __restrict__ img,
                   const float* __restrict__ coords, float* __restrict__ out,
                   int h, int w, int oy, int ox, int* __restrict__ stats) {
  constexpr int T = Taps<M>::kTaps, kL = Taps<M>::kLeft;
  constexpr int R = Taps<M>::kRows;
  __shared__ float swin[kWarps][kWinFloats];
  __shared__ int scount[kWarps][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = (blockIdx.x * kWarps + warp) * 32 + lane;
  const int y0 = blockIdx.y * R;
  const int plane = oy * ox;
  const float* cyp = coords + (size_t)blockIdx.z * 2 * plane;
  const float* cxp = cyp + plane;
  const float* src = img + (size_t)blockIdx.z * h * w;
  float* dst = out + (size_t)blockIdx.z * plane;
  float* win = swin[warp];

  // Each pixel's offsets (all R coordinate reads in flight), then the
  // bounds of the tile's first taps. A pixel has taps if it lies in the
  // output and both offsets are under 1e8 (not NaN).
  float dy[R], dx[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int y = y0 + k;
    dy[k] = dx[k] = NAN;
    if (x < ox && y < oy) {
      dy[k] = __ldg(cyp + y * ox + x) - (float)y;
      dx[k] = __ldg(cxp + y * ox + x) - (float)x;
    }
  }
  int rmin = INT32_MAX, rmax = INT32_MIN, cmin = INT32_MAX, cmax = INT32_MIN;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (fabsf(dy[k]) < 1e8f && fabsf(dx[k]) < 1e8f) {
      const int ry = y0 + k + (int)floorf(dy[k]) - kL;
      const int rx = x + (int)floorf(dx[k]) - kL;
      rmin = min(rmin, ry);
      rmax = max(rmax, ry);
      cmin = min(cmin, rx);
      cmax = max(cmax, rx);
    }
  }
  rmin = __reduce_min_sync(kFull, rmin);
  rmax = __reduce_max_sync(kFull, rmax);
  cmin = __reduce_min_sync(kFull, cmin);
  cmax = __reduce_max_sync(kFull, cmax);
  const bool any = rmin <= rmax;  // some pixel of the tile has taps
  const int rows = any ? rmax - rmin + T : 0;
  const int cols = any ? cmax - cmin + T : 0;
  const bool staged = any && rows <= kWinFloats && cols <= kWinFloats &&
                      rows * cols <= kWinFloats;
  if (staged) {
    // Window element e = r cols + c, kStageUnroll reads per lane at once.
    const int total = rows * cols;
    int r = lane / cols, c = lane - r * cols;
    for (int base = 0; base < total; base += 32 * kStageUnroll) {
      float v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int row = rmin + r, col = cmin + c;
        v[u] = (base + 32 * u + lane < total && row >= 0 && row < h &&
                col >= 0 && col < w)
                   ? __ldg(src + (ptrdiff_t)row * w + col)
                   : 0.0f;
        c += 32;
        while (c >= cols) {
          c -= cols;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (base + 32 * u + lane < total) win[base + 32 * u + lane] = v[u];
    }
    __syncwarp();
  }

  // The pixels in turn. The offsets shift through registers, so the
  // cubic and Lanczos bodies need not be unrolled R times.
  constexpr int kUnroll = T >= 4 ? 1 : R;
#pragma unroll (kUnroll)
  for (int k = 0; k < R; ++k) {
    const float py = dy[0], px = dx[0];
#pragma unroll
    for (int q = 0; q + 1 < R; ++q) {
      dy[q] = dy[q + 1];
      dx[q] = dx[q + 1];
    }
    const int y = y0 + k;
    if (x >= ox || y >= oy) continue;
    float result = 0.0f;
    if (fabsf(py) < 1e8f && fabsf(px) < 1e8f) {
      const int ry = y + (int)floorf(py) - kL;
      const int rx = x + (int)floorf(px) - kL;
      float wy[T], wx[T];
      axis_weights<M>(px, rx - x, wx);
      axis_weights<M>(py, ry - y, wy);
      float acc = 0.0f, norm_y = 0.0f, norm_x = 0.0f;
#pragma unroll
      for (int j = 0; j < T; ++j) norm_x += wx[j];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        norm_y += wy[i];
        float inner = 0.0f;
        if (staged) {
          const float* rp = win + (ry + i - rmin) * cols + (rx - cmin);
#pragma unroll
          for (int j = 0; j < T; ++j) inner += wx[j] * rp[j];
        } else {
          const int row = ry + i;
          if (row >= 0 && row < h) {
            const float* rp = src + (ptrdiff_t)row * w;
#pragma unroll
            for (int j = 0; j < T; ++j) {
              const int col = rx + j;
              const float v = (col >= 0 && col < w) ? __ldg(rp + col) : 0.0f;
              inner += wx[j] * v;
            }
          }
        }
        acc += wy[i] * inner;
      }
      result = M == kLanczos ? acc / fmaxf(norm_y * norm_x, 1e-12f) : acc;
    }
    dst[y * ox + x] = result;
  }

  // Tiles that staged, and tiles with taps (only when asked).
  if (stats != nullptr) {
    if (lane == 0) {
      scount[warp][0] = staged;
      scount[warp][1] = any;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int a = 0, b = 0;
      for (int i = 0; i < kWarps; ++i) {
        a += scount[i][0];
        b += scount[i][1];
      }
      atomicAdd(stats, a);
      atomicAdd(stats + 1, b);
    }
  }
}

template <int M>
void launch(const float* img, const float* coords, float* out, int nz, int h,
            int w, int oy, int ox, int* stats, cudaStream_t stream) {
  const dim3 grid((ox + 32 * kWarps - 1) / (32 * kWarps),
                  (oy + Taps<M>::kRows - 1) / Taps<M>::kRows, nz);
  warp_gather_kernel<M><<<grid, kThreads, 0, stream>>>(img, coords, out, h, w,
                                                       oy, ox, stats);
}

}  // namespace

extern "C" {

// img: [z, h, w]; coords: [z, 2, oy, ox] (y, x); out: [z, oy, ox].
// method: 0 nearest, 1 linear, 2 cubic, 3 lanczos. `stats` (may be NULL):
// two ints that gain the number of warp tiles that gathered from their
// staged window and the number with any tap. Planes of fewer than 2^31
// pixels. Returns cudaGetLastError().
int warp_gather_launch(const float* img, const float* coords, float* out,
                       int nz, int h, int w, int oy, int ox, int method,
                       int* stats, void* stream) {
  if (method < 0 || method > 3 || nz > 65535 || nz < 0 ||
      (int64_t)oy * ox >= INT32_MAX || (int64_t)h * w >= INT32_MAX ||
      oy / 6 >= 65535)
    return (int)cudaErrorInvalidValue;
  if (nz == 0 || oy == 0 || ox == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (method) {
    case kNearest:
      launch<kNearest>(img, coords, out, nz, h, w, oy, ox, stats, st);
      break;
    case kLinear:
      launch<kLinear>(img, coords, out, nz, h, w, oy, ox, stats, st);
      break;
    case kCubic:
      launch<kCubic>(img, coords, out, nz, h, w, oy, ox, stats, st);
      break;
    default:
      launch<kLanczos>(img, coords, out, nz, h, w, oy, ox, stats, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
