// Interpolation weights shared by the render kernels (warp.cu, K4, and
// warp3d.cu, K13): nearest, linear, cubic (a = -0.75) and Lanczos4, with
// the reference's numerics (sofima_tpu/ops/shift_warp.py
// `_kernel_weight` / `make_weight_fn`): the range-reduced sin(pi d) and
// quarter-angle planes of sofima_tpu commit 78165d3, |t| < 1e-6 -> 1 and
// |t| >= 4 -> 0 for Lanczos.

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

struct Planes {
  float sin_pd, sin_pd4, cos_pd4;
};

__device__ __forceinline__ Planes lanczos_planes(float d) {
  Planes q;
  const float k_int = rintf(d);
  const float m2 = k_int - 2.0f * floorf(k_int / 2.0f);
  const float parity = 1.0f - 2.0f * m2;
  q.sin_pd = parity * sinf(kPi * (d - k_int));
  const float d8 = d - 8.0f * rintf(d / 8.0f);
  q.sin_pd4 = sinf(kPi * d8 / 4.0f);
  q.cos_pd4 = cosf(kPi * d8 / 4.0f);
  return q;
}

__device__ __forceinline__ float weight(int method, float d, const Planes& q,
                                        int s) {
  const float t = d - (float)s;
  const float at = fabsf(t);
  switch (method) {
    case kNearest:
      return (t >= -0.5f && t < 0.5f) ? 1.0f : 0.0f;
    case kLinear:
      return fmaxf(0.0f, 1.0f - at);
    case kCubic: {
      const float a = -0.75f;
      const float near = (a + 2.0f) * (at * at * at) - (a + 3.0f) * (at * at) + 1.0f;
      const float far = a * (at * at * at) - 5.0f * a * (at * at) + 8.0f * a * at - 4.0f * a;
      return at <= 1.0f ? near : (at < 2.0f ? far : 0.0f);
    }
    default: {
      const int m = ((s % 8) + 8) % 8;
      const float sign = (s & 1) ? -1.0f : 1.0f;
      // Rounded op by op (no fused multiply-add), as the plain version
      // computes it: near integer t this difference cancels to ~pi t / 4,
      // and the raw (unnormalized) 3d weights show the rounding directly.
      const float sin_pt4 = __fsub_rn(__fmul_rn(q.sin_pd4, kCos8[m]),
                                      __fmul_rn(q.cos_pd4, kSin8[m]));
      const float x2 = fmaxf((kPi * t) * (kPi * t), 1e-12f);
      const float w = at < 1e-6f ? 1.0f : 4.0f * sign * q.sin_pd * sin_pt4 / x2;
      return at < 4.0f ? w : 0.0f;
    }
  }
}

}  // namespace sofima
