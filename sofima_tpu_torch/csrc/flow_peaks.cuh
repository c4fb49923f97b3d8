// The peak chain of the flow kernels, shared by K1/K2 (flow_peaks.cu), K5
// (masked_flow.cu) and K6 (patch_corr.cu): deterministic block reductions,
// the top-2 merge and `peak_chain`, which turns one centered correlation
// surface into the (x, y, sharpness, ratio) row of
// flow_field._batched_peaks.
//
// Numerics follow the reference exactly where it matters: a local max over
// the clipped (2 min_y + 1) x (2 min_x + 1) window, threshold_rel * max,
// first peak at the smallest linear index, sharpness over the clamped
// (2 rad_y + 1) x (2 rad_x + 1) window, ratio 0 without a second peak, and
// a NaN row without a peak (or with a NaN anywhere on the surface). Both
// windows take a radius per axis, as flow_field._batched_peaks takes an int
// or a per-axis sequence for min_distance and peak_radius.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Block-wide reductions. Every thread returns the same value, summed in
// the same order in every block (deterministic).
template <typename Op>
__device__ float block_reduce(float v, float* red, Op op, float init) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : init;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Add { __device__ float operator()(float a, float b) const { return a + b; } };
struct Max { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct Min { __device__ float operator()(float a, float b) const { return fminf(a, b); } };

// Best candidate (value, smallest linear index on ties) and the best value
// among all other candidates.
struct Top2 {
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_first = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
  Top2 r;
  r.v1 = a_first ? a.v1 : b.v1;
  r.i1 = a_first ? a.i1 : b.i1;
  r.v2 = fmaxf(fmaxf(a.v2, b.v2), a_first ? b.v1 : a.v1);
  return r;
}

__device__ Top2 block_top2(Top2 t, float* redf, int* redi, float* redf2) {
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(kFull, t.v1, o);
    u.i1 = __shfl_xor_sync(kFull, t.i1, o);
    u.v2 = __shfl_xor_sync(kFull, t.v2, o);
    t = merge(t, u);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { redf[wid] = t.v1; redi[wid] = t.i1; redf2[wid] = t.v2; }
  __syncthreads();
  if (lane < (int)(blockDim.x >> 5)) {
    t.v1 = redf[lane]; t.i1 = redi[lane]; t.v2 = redf2[lane];
  } else {
    t.v1 = -INFINITY; t.i1 = INT32_MAX; t.v2 = -INFINITY;
  }
  for (int o = 16; o > 0; o >>= 1) {
    Top2 u;
    u.v1 = __shfl_xor_sync(kFull, t.v1, o);
    u.i1 = __shfl_xor_sync(kFull, t.i1, o);
    u.v2 = __shfl_xor_sync(kFull, t.v2, o);
    t = merge(t, u);
  }
  return t;
}

// Writes the (x, y, sharpness, ratio) row of patch `pidx` into the four
// `plane`-strided channels of `out`.
__device__ __forceinline__ void write_row(float* __restrict__ out,
                                          int64_t plane, int64_t pidx,
                                          float x, float y, float sharp,
                                          float ratio) {
  out[pidx] = x;
  out[plane + pidx] = y;
  out[2 * plane + pidx] = sharp;
  out[3 * plane + pidx] = ratio;
}

// Peak statistics of the [n1, n2] surface `corr` whose zero shift sits at
// (n1/2, n2/2). Every thread of the block calls it; thread 0 writes.
// The threshold is tested before the local-max window, so a value at or
// below it (or NaN) costs one read instead of the whole window.
__device__ void peak_chain(const float* corr, int n1, int n2, int min_y,
                           int min_x, float threshold_rel, int rad_y,
                           int rad_x, float* __restrict__ out, int64_t plane,
                           int64_t pidx, float* redf, int* redi,
                           float* redf2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int area = n1 * n2;
  float lmax = -INFINITY, lnan = 0.0f;
  for (int e = tid; e < area; e += nt) {
    const float v = corr[e];
    if (isnan(v)) lnan = 1.0f;
    lmax = fmaxf(lmax, v);
  }
  const float gmax = block_reduce(lmax, redf, Max(), -INFINITY);
  const float any_nan = block_reduce(lnan, redf, Max(), 0.0f);
  const float thr = threshold_rel * gmax;
  Top2 t;
  t.v1 = -INFINITY; t.i1 = INT32_MAX; t.v2 = -INFINITY;
  for (int e = tid; e < area; e += nt) {
    const int r = e / n2, c = e - r * n2;
    const float v = corr[e];
    if (!(v > thr)) continue;
    float m = -INFINITY;
    for (int dy = -min_y; dy <= min_y; ++dy) {
      const int rr = r + dy;
      if (rr < 0 || rr >= n1) continue;
      for (int dx = -min_x; dx <= min_x; ++dx) {
        const int cc = c + dx;
        if (cc < 0 || cc >= n2) continue;
        m = fmaxf(m, corr[rr * n2 + cc]);
      }
    }
    if (v == m) {
      Top2 u;
      u.v1 = v; u.i1 = e; u.v2 = -INFINITY;
      t = merge(t, u);
    }
  }
  t = block_top2(t, redf, redi, redf2);
  const bool no_peak = any_nan != 0.0f || t.v1 == -INFINITY;
  const int size_y = 2 * rad_y + 1, size_x = 2 * rad_x + 1;
  int py = 0, px = 0, wy0 = 0, wx0 = 0;
  if (!no_peak) {
    py = t.i1 / n2;
    px = t.i1 - py * n2;
    wy0 = min(max(py - rad_y, 0), n1 - size_y);
    wx0 = min(max(px - rad_x, 0), n2 - size_x);
  }
  float lmin = INFINITY;
  if (!no_peak) {
    for (int e = tid; e < size_y * size_x; e += nt) {
      const int yy = wy0 + e / size_x, xx = wx0 + e % size_x;
      if (yy >= 0 && yy < n1 && xx >= 0 && xx < n2)
        lmin = fminf(lmin, corr[yy * n2 + xx]);
    }
  }
  const float wmin = block_reduce(lmin, redf, Min(), INFINITY);
  if (tid == 0) {
    if (no_peak) {
      write_row(out, plane, pidx, NAN, NAN, NAN, NAN);
    } else {
      write_row(out, plane, pidx, (float)(px - n2 / 2), (float)(py - n1 / 2),
                t.v1 / wmin, (t.v2 == -INFINITY) ? 0.0f : t.v1 / t.v2);
    }
  }
}

}  // namespace
