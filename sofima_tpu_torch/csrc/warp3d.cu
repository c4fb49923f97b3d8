// K13, the volume render: resample a [d, h, w] volume at dense (z, y, x)
// source coordinates with nearest, linear, cubic or raw Lanczos4 weights.
//
// Replaces sofima_tpu/ops/pallas_warp.py `_warp3d_kernel` (entry
// pallas_shift_warp_3d), which sweeps a static integer-shift lattice over
// a DMA'd halo window because the TPU has no cheap gather. Its contract
// is kept exactly, including two rules of that lattice:
//   * the static displacement bounds: per axis only the shifts
//     s in [lo - left, hi + taps - 1 - left] exist, so a tap whose integer
//     shift falls outside that range adds nothing, even where the voxel's
//     other taps do (s0 / s1 below, per axis);
//   * no normalisation: the sum is w_z w_y w_x v with the raw weights of
//     shift_warp.make_weight_fn (the 2d render divides Lanczos by its tap
//     sums; the 3d one does not).
// Taps outside the volume read 0; NaN coordinates give 0. The sum runs
// over z outermost and x innermost, in increasing shift, as the
// reference accumulates it.
//
// What bounds it on the H100: trilinear, memory (16 B per voxel: 12 of
// coordinates, 4 of output; 0.28 ms at path (a)'s 128 x 640^2) and the
// latency of two dependent reads (coordinates, then taps); Lanczos, the
// issue rate and latency of its per-voxel work: 512 taps (a shared-memory
// read and a multiply-add each, in the reference's order, so 64 chains
// of 8 dependent multiply-adds) and 24 weights (~1.1 ms of f32
// operations for 52 M voxels; ~3.6 ms of shared-memory reads at 128 B
// per clock per SM, a rate that does not bind: reading each row once for
// two z-neighbours halved the reads and ran slower, with more registers).
// The design follows K4's (warp.cu):
//  * one instantiation per method: tap counts and offsets are
//    compile-time, the tap loops unroll and the weights stay in
//    registers (the Lanczos z-tap loop stays rolled, each z weight
//    computed as its plane comes, and each voxel's coordinates are read
//    again for its sum, for code size and registers: Lanczos runs at 64
//    registers, four blocks per SM);
//  * a 3-D grid of block tiles, 32 x-columns x 8 y-rows (one warp each)
//    x 4 z-planes (each thread's four voxels, their coordinate reads all
//    in flight), so a thread knows its (z, y, x) without division;
//  * the block reduces the extent of its voxels' taps (only taps that
//    can add something: a voxel without a live tap on some axis reads
//    nothing); if that brick holds at most kWin floats the block copies
//    it into shared memory (coalesced, four reads in flight per thread,
//    0 outside the volume) and gathers from there; otherwise (a field
//    that tears or scatters) it gathers from global memory with per-tap
//    bounds and shift checks. A voxel whose x taps are not all live takes
//    the checked gather too. Every branch reads the same values and sums
//    them in the same order, so they agree bit for bit;
//  * nearest, linear and cubic weights from f = d - floor(d)
//    (sofima::poly_weights, last-bit differences from the plain version's
//    per-tap t = d - s); Lanczos sin(pi d) from one sinpif per axis and
//    one __fdividef per tap. The quarter-angle planes sin(pi d8 / 4),
//    cos(pi d8 / 4) stay the plain version's sinf / cosf, and each tap's
//    sin(pi t / 4) its op-by-op difference of products: near an integer
//    displacement that difference cancels to ~pi t / 4, and the raw
//    weights (no norm to divide the error out) carry any change of its
//    rounding straight into the render (a few gray levels at |t| ~ 1e-5).

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

constexpr int kWarps = 8;            // y-rows of a block tile, a warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kTz = 4;               // z-planes of a block tile
constexpr int kStageUnroll = 4;      // window reads in flight per thread
constexpr unsigned kFull = 0xffffffffu;

// Taps per axis, the offset of the first (nearest scans floor(d) and
// floor(d) + 1; exactly one has weight 1), and the staged window's
// budget in floats (a block tile with a smooth field needs ~2 000
// trilinear, ~4 000 cubic, ~7 700 Lanczos).
template <int M>
struct Taps {
  static constexpr int kTaps = M == kCubic ? 4 : (M == kLanczos ? 8 : 2);
  static constexpr int kLeft = M == kCubic ? 1 : (M == kLanczos ? 3 : 0);
  static constexpr int kWin =
      M == kLanczos ? 10240 : (M == kCubic ? 6144 : 4096);
};

struct Axis {
  int n;       // volume extent
  int origin;  // volume coordinate of output index 0
  int s0, s1;  // the static shift range
};

// One axis of one voxel: the position of its first tap and the range
// [lo, hi] of its taps whose shift lies in [s0, s1] (empty: lo > hi).
struct Span {
  int pos, lo, hi;
};

template <int M>
__device__ __forceinline__ Span axis_span(float d, int o, const Axis& A) {
  constexpr int T = Taps<M>::kTaps;
  const int base = (int)floorf(d) - Taps<M>::kLeft;
  return Span{o + A.origin + base, max(0, A.s0 - base),
              min(T - 1, A.s1 - base)};
}

// Raw Lanczos4 weights from offset d: the planes once per axis, then the
// weight of tap j (shift base + j) on demand. trig: cos(pi m / 4) |
// sin(pi m / 4) in shared memory (a runtime index per thread).
struct Lanczos {
  float d, a4, s4, c4;
  int base;
};

__device__ __forceinline__ Lanczos lanczos_planes(float d) {
  Lanczos q;
  q.d = d;
  q.base = (int)floorf(d) - 3;
  const float k_int = rintf(d);
  const float parity = 1.0f - 2.0f * (k_int - 2.0f * floorf(k_int / 2.0f));
  // 4 sin(pi d) (-1)^s = +-a4; the sign is exact, so the product rounds
  // as the plain version's (4 sign) sin_pd sin_pt4.
  q.a4 = 4.0f * (parity * sinpif(d - k_int));
  const float d8 = d - 8.0f * rintf(d / 8.0f);
  q.s4 = sinf(sofima::kPi * d8 / 4.0f);
  q.c4 = cosf(sofima::kPi * d8 / 4.0f);
  return q;
}

__device__ __forceinline__ float lanczos_weight(const Lanczos& q, int j,
                                                const float* trig) {
  const int s = q.base + j;
  const float t = q.d - (float)s;
  const float at = fabsf(t);
  const int m = s & 7;
  const float sp = __fsub_rn(__fmul_rn(q.s4, trig[m]),
                             __fmul_rn(q.c4, trig[8 + m]));
  const float x2 = fmaxf((sofima::kPi * t) * (sofima::kPi * t), 1e-12f);
  const float wv =
      at < 1e-6f ? 1.0f : __fdividef(((s & 1) ? -q.a4 : q.a4) * sp, x2);
  return at < 4.0f ? wv : 0.0f;
}

__device__ __forceinline__ void lanczos_weights(float d, const float* trig,
                                                float* w) {
  const Lanczos q = lanczos_planes(d);
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = lanczos_weight(q, j, trig);
}

// Does a voxel at these offsets have taps? Within the widest shift range
// (bound; NaN fails) and a live tap on every axis.
template <int M>
__device__ __forceinline__ bool active(float dz, float dy, float dx, int z,
                                       int y, int x, const Axis& az,
                                       const Axis& ay, const Axis& ax,
                                       float bound, Span& sz, Span& sy,
                                       Span& sx) {
  if (!(fabsf(dz) < bound && fabsf(dy) < bound && fabsf(dx) < bound))
    return false;
  sz = axis_span<M>(dz, z, az);
  sy = axis_span<M>(dy, y, ay);
  sx = axis_span<M>(dx, x, ax);
  return sz.lo <= sz.hi && sy.lo <= sy.hi && sx.lo <= sx.hi;
}

// The sum of one voxel (nearest, linear, cubic). kStaged: from the
// window (z0, y0, x0 its origin, ny, nx its extents), every x tap live;
// else from global memory with per-tap bounds and shift checks. Both read
// the same values (0 outside the volume) and add them in the same order.
template <int M, bool kStaged>
__device__ __forceinline__ float voxel_sum(
    const float* __restrict__ vol, const float* win, const Span& sz,
    const Span& sy, const Span& sx, const float* wz, const float* wy,
    const float* wx, int d, int h, int w, int z0, int y0, int x0, int ny,
    int nx) {
  constexpr int T = Taps<M>::kTaps;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    if (i < sz.lo || i > sz.hi) continue;
    const int gz = sz.pos + i;
    const bool zin = gz >= 0 && gz < d;
    float acc_y = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      if (j < sy.lo || j > sy.hi) continue;
      const int gy = sy.pos + j;
      float acc_x = 0.0f;
      if (kStaged) {
        const float* rp =
            win + ((gz - z0) * ny + (gy - y0)) * nx + (sx.pos - x0);
#pragma unroll
        for (int k = 0; k < T; ++k) acc_x += wx[k] * rp[k];
      } else {
        const bool yin = zin && gy >= 0 && gy < h;
        const float* rp = yin ? vol + ((size_t)gz * h + gy) * w : vol;
#pragma unroll
        for (int k = 0; k < T; ++k) {
          const int gx = sx.pos + k;
          const bool in = yin && k >= sx.lo && k <= sx.hi && gx >= 0 && gx < w;
          acc_x += wx[k] * (in ? __ldg(rp + gx) : 0.0f);
        }
      }
      acc_y += wy[j] * acc_x;
    }
    acc += wz[i] * acc_y;
  }
  return acc;
}

// The Lanczos sum of one voxel: z-taps in a rolled loop (code size and
// registers), each z weight computed as its plane comes. kStaged: from
// the window, every x tap live; else from global memory with per-tap
// checks. Both read the same values and add them in the same order.
template <bool kStaged>
__device__ __forceinline__ float lanczos_sum(
    const float* __restrict__ vol, const float* win, const float* trig,
    const Lanczos& qz, const Span& sz, const Span& sy, const Span& sx,
    const float* wy, const float* wx, int d, int h, int w, int z0, int y0,
    int x0, int ny, int nx) {
  float acc = 0.0f;
#pragma unroll 1
  for (int i = sz.lo; i <= sz.hi; ++i) {
    const int gz = sz.pos + i;
    const bool zin = gz >= 0 && gz < d;
    float acc_y = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < sy.lo || j > sy.hi) continue;
      const int gy = sy.pos + j;
      float acc_x = 0.0f;
      if (kStaged) {
        const float* rp =
            win + ((gz - z0) * ny + (gy - y0)) * nx + (sx.pos - x0);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc_x += wx[k] * rp[k];
      } else {
        const bool yin = zin && gy >= 0 && gy < h;
        const float* rp = yin ? vol + ((size_t)gz * h + gy) * w : vol;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int gx = sx.pos + k;
          const bool in = yin && k >= sx.lo && k <= sx.hi && gx >= 0 && gx < w;
          acc_x += wx[k] * (in ? __ldg(rp + gx) : 0.0f);
        }
      }
      acc_y += wy[j] * acc_x;
    }
    acc += lanczos_weight(qz, i, trig) * acc_y;
  }
  return acc;
}

// Lanczos: at most 64 registers, four blocks per SM (the fastest of
// 80, 85 and 64 on the H100; a few spills).
template <int M>
__global__ void __launch_bounds__(kThreads, M == kLanczos ? 4 : 1)
warp3d_kernel(const float* __restrict__ vol, const float* __restrict__ coords,
              float* __restrict__ out, int oz, int oy, int ox, Axis az,
              Axis ay, Axis ax, float bound, int* __restrict__ stats) {
  constexpr int T = Taps<M>::kTaps, W = Taps<M>::kWin;
  __shared__ float win[W];
  __shared__ float trig[16];
  __shared__ int red[kWarps][6];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = blockIdx.x * 32 + lane, y = blockIdx.y * kWarps + warp;
  const int zt = blockIdx.z * kTz;
  const size_t n = (size_t)oz * oy * ox;
  if (M == kLanczos && threadIdx.x < 16)
    trig[threadIdx.x] = threadIdx.x < 8 ? sofima::kCos8[threadIdx.x]
                                        : sofima::kSin8[threadIdx.x - 8];

  // Each voxel's offsets (all coordinate reads in flight), then the
  // extent of the tile's live taps.
  float dz[kTz], dy[kTz], dx[kTz];
#pragma unroll
  for (int k = 0; k < kTz; ++k) {
    const int z = zt + k;
    dz[k] = dy[k] = dx[k] = NAN;
    if (x < ox && y < oy && z < oz) {
      const size_t p = ((size_t)z * oy + y) * ox + x;
      dz[k] = __ldg(coords + p) - (float)(z + az.origin);
      dy[k] = __ldg(coords + n + p) - (float)(y + ay.origin);
      dx[k] = __ldg(coords + 2 * n + p) - (float)(x + ax.origin);
    }
  }
  int box[6] = {INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN, INT32_MAX,
              INT32_MIN};
#pragma unroll
  for (int k = 0; k < kTz; ++k) {
    Span sz, sy, sx;
    if (active<M>(dz[k], dy[k], dx[k], zt + k, y, x, az, ay, ax, bound, sz,
                  sy, sx)) {
      box[0] = min(box[0], sz.pos);
      box[1] = max(box[1], sz.pos);
      box[2] = min(box[2], sy.pos);
      box[3] = max(box[3], sy.pos);
      box[4] = min(box[4], sx.pos);
      box[5] = max(box[5], sx.pos);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; a += 2) {
    box[a] = __reduce_min_sync(kFull, box[a]);
    box[a + 1] = __reduce_max_sync(kFull, box[a + 1]);
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) red[warp][a] = box[a];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 6; a += 2) {
    const int lo = lane < kWarps ? red[lane][a] : INT32_MAX;
    const int hi = lane < kWarps ? red[lane][a + 1] : INT32_MIN;
    box[a] = __reduce_min_sync(kFull, lo);
    box[a + 1] = __reduce_max_sync(kFull, hi);
  }
  const bool any = box[0] <= box[1];  // some voxel of the tile has taps
  const int nz = any ? box[1] - box[0] + T : 0;
  const int ny = any ? box[3] - box[2] + T : 0;
  const int nx = any ? box[5] - box[4] + T : 0;
  const bool staged = any && nz <= W && ny <= W && nx <= W &&
                      (long long)nz * ny * nx <= W;
  const int d = az.n, h = ay.n, w = ax.n;
  if (staged) {
    // Window element e = (zz ny + yy) nx + xx, kStageUnroll reads per
    // thread at once; each step of kThreads elements moves (yy, xx) by
    // (qy, qx) with carries.
    const int total = nz * ny * nx;
    const int qy = kThreads / nx, qx = kThreads - qy * nx;
    const int e0 = threadIdx.x;
    int zz = e0 / (ny * nx), yy = (e0 - zz * ny * nx) / nx;
    int xx = e0 - (zz * ny + yy) * nx;
    for (int base = 0; base < total; base += kThreads * kStageUnroll) {
      float v[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int gz = box[0] + zz, gy = box[2] + yy, gx = box[4] + xx;
        v[u] = (base + kThreads * u + e0 < total && gz >= 0 && gz < d &&
                gy >= 0 && gy < h && gx >= 0 && gx < w)
                   ? __ldg(vol + ((size_t)gz * h + gy) * w + gx)
                   : 0.0f;
        xx += qx;
        yy += qy;
        if (xx >= nx) {
          xx -= nx;
          ++yy;
        }
        while (yy >= ny) {
          yy -= ny;
          ++zz;
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u)
        if (base + kThreads * u + e0 < total)
          win[base + kThreads * u + e0] = v[u];
    }
  }
  __syncthreads();

  const size_t plane_out = (size_t)oy * ox;
  const size_t col = (size_t)y * ox + x;
  if constexpr (M == kLanczos) {
    // The voxels in turn, their coordinates read again (L1 hits) rather
    // than held through the long tap loops (registers).
#pragma unroll 1
    for (int k = 0; k < kTz; ++k) {
      const int z = zt + k;
      if (x >= ox || y >= oy || z >= oz) continue;
      const size_t p = z * plane_out + col;
      const float vz = __ldg(coords + p) - (float)(z + az.origin);
      const float vy = __ldg(coords + n + p) - (float)(y + ay.origin);
      const float vx = __ldg(coords + 2 * n + p) - (float)(x + ax.origin);
      float result = 0.0f;
      Span sz, sy, sx;
      if (active<M>(vz, vy, vx, z, y, x, az, ay, ax, bound, sz, sy, sx)) {
        float wy[8], wx[8];
        lanczos_weights(vy, trig, wy);
        lanczos_weights(vx, trig, wx);
        const Lanczos qz = lanczos_planes(vz);
        if (staged && sx.lo == 0 && sx.hi == 7)
          result = lanczos_sum<true>(vol, win, trig, qz, sz, sy, sx, wy, wx,
                                     d, h, w, box[0], box[2], box[4], ny, nx);
        else
          result = lanczos_sum<false>(vol, win, trig, qz, sz, sy, sx, wy, wx,
                                      d, h, w, box[0], box[2], box[4], ny,
                                      nx);
      }
      out[p] = result;
    }
  } else {
    // The voxels in turn; the offsets shift through registers, so the
    // cubic body need not be unrolled kTz times.
    constexpr int kUnroll = T >= 4 ? 1 : kTz;
#pragma unroll (kUnroll)
    for (int k = 0; k < kTz; ++k) {
      const float vz = dz[0], vy = dy[0], vx = dx[0];
#pragma unroll
      for (int q = 0; q + 1 < kTz; ++q) {
        dz[q] = dz[q + 1];
        dy[q] = dy[q + 1];
        dx[q] = dx[q + 1];
      }
      const int z = zt + k;
      if (x >= ox || y >= oy || z >= oz) continue;
      float result = 0.0f;
      Span sz, sy, sx;
      if (active<M>(vz, vy, vx, z, y, x, az, ay, ax, bound, sz, sy, sx)) {
        float wz[T], wy[T], wx[T];
        sofima::poly_weights<M>(vz, wz);
        sofima::poly_weights<M>(vy, wy);
        sofima::poly_weights<M>(vx, wx);
        if (staged && sx.lo == 0 && sx.hi == T - 1)
          result = voxel_sum<M, true>(vol, win, sz, sy, sx, wz, wy, wx, d, h,
                                      w, box[0], box[2], box[4], ny, nx);
        else
          result = voxel_sum<M, false>(vol, win, sz, sy, sx, wz, wy, wx, d,
                                       h, w, box[0], box[2], box[4], ny, nx);
      }
      out[z * plane_out + col] = result;
    }
  }

  // Block tiles that staged, and tiles with taps (only when asked).
  if (stats != nullptr && threadIdx.x == 0) {
    atomicAdd(stats, (int)staged);
    atomicAdd(stats + 1, (int)any);
  }
}

template <int M>
void launch(const float* vol, const float* coords, float* out, int oz, int oy,
            int ox, Axis az, Axis ay, Axis ax, float bound, int* stats,
            cudaStream_t stream) {
  const dim3 grid((ox + 31) / 32, (oy + kWarps - 1) / kWarps,
                  (oz + kTz - 1) / kTz);
  warp3d_kernel<M><<<grid, kThreads, 0, stream>>>(vol, coords, out, oz, oy,
                                                  ox, az, ay, ax, bound,
                                                  stats);
}

}  // namespace

extern "C" {

// vol: [d, h, w]; coords: [3, oz, oy, ox] (z, y, x source positions);
// out: [oz, oy, ox]. origin_*: volume coordinate of output voxel 0;
// s0_* / s1_*: inclusive shift range per axis (displacement bounds
// widened by the kernel support). method: 0 nearest, 1 linear, 2 cubic,
// 3 lanczos. `stats` (may be NULL): two ints that gain the number of
// block tiles that gathered from their staged window and the number with
// any tap. Returns cudaGetLastError().
int warp_gather_3d_launch(const float* vol, const float* coords, float* out,
                          int d, int h, int w, int oz, int oy, int ox,
                          int origin_z, int origin_y, int origin_x, int s0_z,
                          int s1_z, int s0_y, int s1_y, int s0_x, int s1_x,
                          int method, int* stats, void* stream) {
  if (method < 0 || method > 3 || oz < 0 || oy < 0 || ox < 0 ||
      (oz + kTz - 1) / kTz > 65535 || (oy + kWarps - 1) / kWarps > 65535)
    return (int)cudaErrorInvalidValue;
  if (oz == 0 || oy == 0 || ox == 0) return 0;
  // No tap lies further than the widest shift range plus the support.
  int span = 0;
  const int lims[6] = {s0_z, s1_z, s0_y, s1_y, s0_x, s1_x};
  for (int i = 0; i < 6; ++i) {
    const int a = lims[i] < 0 ? -lims[i] : lims[i];
    if (a > span) span = a;
  }
  const float bound = (float)(span + 16);
  const Axis az = {d, origin_z, s0_z, s1_z};
  const Axis ay = {h, origin_y, s0_y, s1_y};
  const Axis ax = {w, origin_x, s0_x, s1_x};
  cudaStream_t st = (cudaStream_t)stream;
  switch (method) {
    case kNearest:
      launch<kNearest>(vol, coords, out, oz, oy, ox, az, ay, ax, bound, stats,
                       st);
      break;
    case kLinear:
      launch<kLinear>(vol, coords, out, oz, oy, ox, az, ay, ax, bound, stats,
                      st);
      break;
    case kCubic:
      launch<kCubic>(vol, coords, out, oz, oy, ox, az, ay, ax, bound, stats,
                     st);
      break;
    default:
      launch<kLanczos>(vol, coords, out, oz, oy, ox, az, ay, ax, bound, stats,
                       st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
