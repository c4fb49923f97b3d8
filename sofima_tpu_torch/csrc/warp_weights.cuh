// Interpolation weights shared by the render kernels (warp.cu, K4, and
// warp3d.cu, K13): nearest, linear and cubic (a = -0.75) from the
// fractional part of the offset, and the Lanczos4 constants, with the
// reference's numerics (sofima_tpu/ops/shift_warp.py `_kernel_weight` /
// `make_weight_fn`).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sofima {

constexpr float kPi = 3.14159265358979323846f;

enum Method { kNearest = 0, kLinear = 1, kCubic = 2, kLanczos = 3 };

// cos(pi m / 4), sin(pi m / 4) for m = s mod 8 (float64 values rounded to
// float32, as the reference takes them from numpy); one copy per
// translation unit.
static __constant__ float kCos8[8] = {1.0f, 0.7071067690849304f, 6.123234262925839e-17f,
                               -0.7071067690849304f, -1.0f, -0.7071067690849304f,
                               -1.8369701465288538e-16f, 0.7071067690849304f};
static __constant__ float kSin8[8] = {0.0f, 0.7071067690849304f, 1.0f, 0.7071067690849304f,
                               1.2246468525851679e-16f, -0.7071067690849304f, -1.0f,
                               -0.7071067690849304f};

// Nearest, linear or cubic weights of the taps at integer shifts
// floor(d) - left + j, j < 2 (nearest, linear) or 4 (cubic, left = 1).
// The taps sit at t = f + left - j from d, f = d - floor(d) in [0, 1), so
// each tap's branch of the reference's kernel is known: nearest takes the
// tap with |t| < 1/2, linear 1 - |t|, cubic the near polynomial for the
// two inner taps and the far one for the outer two (both are 0 at |t| = 1
// and the far one at |t| = 2, where the reference switches). Last-bit
// differences from the reference's per-tap t = d - s.
template <int M>
__device__ __forceinline__ void poly_weights(float d, float* w) {
  static_assert(M != kLanczos, "Lanczos weights live with their kernels");
  const float f = d - floorf(d);
  if constexpr (M == kNearest) {
    w[0] = f < 0.5f ? 1.0f : 0.0f;
    w[1] = 1.0f - w[0];
  } else if constexpr (M == kLinear) {
    w[0] = 1.0f - f;
    w[1] = f;
  } else {
    constexpr float a = -0.75f;
    auto near = [](float x) {
      return (a + 2.0f) * (x * x * x) - (a + 3.0f) * (x * x) + 1.0f;
    };
    auto far = [](float x) {
      return a * (x * x * x) - 5.0f * a * (x * x) + 8.0f * a * x - 4.0f * a;
    };
    w[0] = far(1.0f + f);
    w[1] = near(f);
    w[2] = near(1.0f - f);
    w[3] = far(2.0f - f);
  }
}

}  // namespace sofima
