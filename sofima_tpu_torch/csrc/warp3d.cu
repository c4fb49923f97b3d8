// Volume render: resample a [d, h, w] volume at dense (z, y, x) source
// coordinates with nearest, linear, cubic or raw Lanczos4 weights, one
// thread per output voxel gathering its taps straight from device memory.
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
// What bounds it on the H100: memory traffic. Each output voxel reads
// 12 B of coordinates and writes 4 B; the volume itself is read once at
// the least. The tap reads (8 trilinear, 512 Lanczos) hit L1/L2 because
// neighbouring threads take neighbouring x. Staging a halo brick in
// shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_weights.cuh"

namespace {

using sofima::kLanczos;
using sofima::Planes;

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;

struct Axis {
  int n;       // volume extent
  int origin;  // volume coordinate of output index 0
  int s0, s1;  // the static shift range
};

// The weights and source indices of one axis' taps: weight 0 where the
// shift leaves [s0, s1], index -1 where the tap adds nothing.
__device__ __forceinline__ void axis_taps(int method, int taps, int left,
                                          float c, int o, const Axis& A,
                                          float* w, int* src) {
  const float d = c - (float)(o + A.origin);
  const Planes q = method == kLanczos ? sofima::lanczos_planes(d) : Planes{};
  const int base = (int)floorf(d) - left;
  for (int t = 0; t < taps; ++t) {
    const int s = base + t;
    const bool live = s >= A.s0 && s <= A.s1;
    w[t] = live ? sofima::weight(method, d, q, s) : 0.0f;
    const int p = o + A.origin + s;
    src[t] = (live && p >= 0 && p < A.n) ? p : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
warp3d_kernel(const float* __restrict__ vol, const float* __restrict__ coords,
              float* __restrict__ out, int oz, int oy, int ox, Axis az,
              Axis ay, Axis ax, int method, int taps, int left, float bound) {
  const int64_t n = (int64_t)oz * oy * ox;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int x = (int)(p % ox);
    const int y = (int)((p / ox) % oy);
    const int z = (int)(p / ((int64_t)ox * oy));
    const float cz = __ldg(coords + p);
    const float cy = __ldg(coords + n + p);
    const float cx = __ldg(coords + 2 * n + p);
    float result = 0.0f;
    // A NaN coordinate, or one beyond every shift range, has no tap.
    if (fabsf(cz - (float)(z + az.origin)) < bound &&
        fabsf(cy - (float)(y + ay.origin)) < bound &&
        fabsf(cx - (float)(x + ax.origin)) < bound) {
      float wz[kMaxTaps], wy[kMaxTaps], wx[kMaxTaps];
      int iz[kMaxTaps], iy[kMaxTaps], ix[kMaxTaps];
      axis_taps(method, taps, left, cz, z, az, wz, iz);
      axis_taps(method, taps, left, cy, y, ay, wy, iy);
      axis_taps(method, taps, left, cx, x, ax, wx, ix);
      float acc = 0.0f;
      for (int i = 0; i < taps; ++i) {
        float acc_y = 0.0f;
        if (iz[i] >= 0) {
          const float* plane = vol + (int64_t)iz[i] * ay.n * ax.n;
          for (int j = 0; j < taps; ++j) {
            float acc_x = 0.0f;
            if (iy[j] >= 0) {
              const float* row = plane + (int64_t)iy[j] * ax.n;
              for (int k = 0; k < taps; ++k)
                acc_x += wx[k] * (ix[k] >= 0 ? __ldg(row + ix[k]) : 0.0f);
            }
            acc_y += wy[j] * acc_x;
          }
        }
        acc += wz[i] * acc_y;
      }
      result = acc;
    }
    out[p] = result;
  }
}

}  // namespace

extern "C" {

// vol: [d, h, w]; coords: [3, oz, oy, ox] (z, y, x source positions);
// out: [oz, oy, ox]. origin_*: volume coordinate of output voxel 0;
// s0_* / s1_*: inclusive shift range per axis (displacement bounds
// widened by the kernel support). method: 0 nearest, 1 linear, 2 cubic,
// 3 lanczos. Returns cudaGetLastError().
int warp_gather_3d_launch(const float* vol, const float* coords, float* out,
                          int d, int h, int w, int oz, int oy, int ox,
                          int origin_z, int origin_y, int origin_x, int s0_z,
                          int s1_z, int s0_y, int s1_y, int s0_x, int s1_x,
                          int method, void* stream) {
  static const int kTaps[4] = {2, 2, 4, 8};
  static const int kLeft[4] = {0, 0, 1, 3};
  if (method < 0 || method > 3) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)oz * oy * ox;
  if (n == 0) return 0;
  // No tap lies further than the widest shift range plus the support.
  int span = 0;
  const int lims[6] = {s0_z, s1_z, s0_y, s1_y, s0_x, s1_x};
  for (int i = 0; i < 6; ++i) {
    const int a = lims[i] < 0 ? -lims[i] : lims[i];
    if (a > span) span = a;
  }
  const float bound = (float)(span + 16);
  Axis az = {d, origin_z, s0_z, s1_z};
  Axis ay = {h, origin_y, s0_y, s1_y};
  Axis ax = {w, origin_x, s0_x, s1_x};
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  warp3d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      vol, coords, out, oz, oy, ox, az, ay, ax, method, kTaps[method],
      kLeft[method], bound);
  return (int)cudaGetLastError();
}

}  // extern "C"
