// The stack path's invert layer: the 2d map inversion with the
// `shift_bound` sampling contract (map_utils._invert_section) and the hole
// fill with nearest-valid extrapolation (ops/fill.fill_invalid, dim 2), on
// any leading batch of sections.
//
// Replaces no TPU kernel: the reference runs both as XLA programs of small
// ops (sofima_tpu/map_utils.py `_invert_section`, sofima_tpu/ops/fill.py
// `fill_invalid`), which the port first ran as plain torch: ~6 450 launches
// a call at 250^2 nodes, a few us of work each, so the host set the pace.
//
// What bounds it on the H100: nothing of the card. A 250^2 section is 0.5 MB
// of map and 1.5 MB of fill fields; the bound is ~1 us of memory time. What
// costs is the number of launches and the serial chains inside them. So:
//  * `invert_kernel`: one thread per (section, query node) runs every
//    iteration in registers: the damped fixed point, the residual gate, the
//    re-seed, the Newton steps with the 2x2 Cramer solve, the trust region
//    and the final NaN. It reads the offset field d = abs - (grid + src) *
//    stride and its Jacobian (torch.gradient's rule: one-sided at the
//    border, central inside) straight from the map through L1, at each tap.
//  * the fill, one launch per stage (`fill_invalid_launch` issues them all):
//    `prep_kernel` builds up to six multigrid levels from 64 x 64 tiles of
//    the level below (the valid-weighted pair sums are local to a tile) and
//    each mask's row and column extents (the span hull); `jfa_kernel` runs
//    one jump-flooding pass of the hull's seeds; `coarse_kernel` solves
//    every level of at most kCoarseNodes nodes in one block's shared
//    memory (downsample, mean fill, upsample and Jacobi sweeps);
//    `level_kernel` upsamples a finer level and runs up to kHalo Jacobi
//    sweeps on 32 x 32 tiles with a kHalo-node halo in shared memory, so
//    that one launch does all 16 sweeps; the last jump-flooding pass also
//    writes the output (the hull and valid selects, the nearest gather and
//    the all-invalid passthrough).
// The host (ops/cuda_invert.py `fill_plan`) lays out the levels, the
// launches and the scratch; this file only walks that table.
//
// Numerics: every operation is the plain version's, in its order, each
// rounded once (the __f*_rn intrinsics keep nvcc from contracting a
// multiply and an add), with its true divisions: the inversion matches the
// plain version on the CPU bit for bit; the fill's mean of the coarsest
// level sums in another order (f32 noise). Jump flooding keeps the
// reference's offset order and strict `<`, with its float32 distances.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp: a NaN stays NaN.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------- invert

constexpr int kInvertThreads = 128;

struct InvertArgs {
  const float* abs_map;  // [B, 2, g0, g1], channels (x, y)
  const float* query;    // [B or 1, 2, oy, ox]
  float* out;            // [B, 2, oy, ox]
  int64_t q_bstride;     // 0 (one query grid for all) or 2 * oy * ox
  int64_t n;             // B * oy * ox
  int g0, g1, oy, ox;
  float src_y, src_x, stride_y, stride_x;
  int num_iters, newton_iters;
  float thr;             // tol * max stride
  float lim;             // trust region, 8 * max stride
  float bnd1;            // shift_bound + 1
  int org_y, org_x;
};

// d (channel c) at grid node (y, x) of map m.
__device__ __forceinline__ float d_at(const InvertArgs& a, const float* m,
                                      int c, int y, int x) {
  const float v = __ldg(m + ((int64_t)c * a.g0 + y) * a.g1 + x);
  return c == 0 ? fsub(v, fmul(fadd((float)x, a.src_x), a.stride_x))
                : fsub(v, fmul(fadd((float)y, a.src_y), a.stride_y));
}

// Jacobian plane k at node (y, x): d(dx)/dx, d(dx)/dy, d(dy)/dx, d(dy)/dy.
__device__ float jac_at(const InvertArgs& a, const float* m, int k, int y,
                        int x) {
  const int c = k >> 1;
  float g;
  if ((k & 1) == 0) {  // along x
    if (x == 0) {
      g = fsub(d_at(a, m, c, y, 1), d_at(a, m, c, y, 0));
    } else if (x == a.g1 - 1) {
      g = fsub(d_at(a, m, c, y, x), d_at(a, m, c, y, x - 1));
    } else {
      g = fdiv(fsub(d_at(a, m, c, y, x + 1), d_at(a, m, c, y, x - 1)), 2.f);
    }
    return fdiv(g, a.stride_x);
  }
  if (y == 0) {
    g = fsub(d_at(a, m, c, 1, x), d_at(a, m, c, 0, x));
  } else if (y == a.g0 - 1) {
    g = fsub(d_at(a, m, c, y, x), d_at(a, m, c, y - 1, x));
  } else {
    g = fdiv(fsub(d_at(a, m, c, y + 1, x), d_at(a, m, c, y - 1, x)), 2.f);
  }
  return fdiv(g, a.stride_y);
}

// d sampled at p under the shift_bound contract: NaN if p is more than
// shift_bound + 1 nodes from its own query (qy, qx), or if a tap of
// positive weight lies off the grid or on a NaN node.
__device__ void sample_d(const InvertArgs& a, const float* m, int qy, int qx,
                         float px, float py, float& s0, float& s1) {
  const float iy = fsub(fdiv(py, a.stride_y), a.src_y);
  const float ix = fsub(fdiv(px, a.stride_x), a.src_x);
  const float dy = fsub(fsub(iy, (float)qy), (float)a.org_y);
  const float dx = fsub(fsub(ix, (float)qx), (float)a.org_x);
  if (!(fabsf(dy) <= a.bnd1) || !(fabsf(dx) <= a.bnd1)) {
    s0 = s1 = NAN;
    return;
  }
  const float ty0 = floorf(dy), tx0 = floorf(dx);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float ty = i ? fadd(ty0, 1.f) : ty0;
    const float wy = fmaxf(fsub(1.f, fabsf(fsub(dy, ty))), 0.f);
    const int gy = qy + a.org_y + (int)ty;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float tx = j ? fadd(tx0, 1.f) : tx0;
      const float w = fmul(wy, fmaxf(fsub(1.f, fabsf(fsub(dx, tx))), 0.f));
      if (w > 0.f) {
        const int gx = qx + a.org_x + (int)tx;
        float v0 = NAN, v1 = NAN;
        if (gy >= 0 && gy < a.g0 && gx >= 0 && gx < a.g1) {
          v0 = d_at(a, m, 0, gy, gx);
          v1 = d_at(a, m, 1, gy, gx);
        }
        acc0 = fadd(acc0, fmul(w, v0));
        acc1 = fadd(acc1, fmul(w, v1));
      }
    }
  }
  s0 = acc0;
  s1 = acc1;
}

__device__ bool residual_ok(const InvertArgs& a, const float* m, int qy,
                            int qx, float px, float py, float q0, float q1) {
  float s0, s1;
  sample_d(a, m, qy, qx, px, py, s0, s1);
  return fabsf(fsub(fadd(px, s0), q0)) <= a.thr &&
         fabsf(fsub(fadd(py, s1), q1)) <= a.thr;
}

// The four Jacobian planes sampled linearly at grid index (iy, ix), edge
// indices clamped (interp's 'nearest' mode); zero-weight taps add 0.
__device__ void sample_jac(const InvertArgs& a, const float* m, float iy,
                           float ix, float* jac) {
  if (isnan(iy) || isnan(ix)) {
    for (int k = 0; k < 4; ++k) jac[k] = NAN;
    return;
  }
  const float by = floorf(iy), bx = floorf(ix);
  const float fy = fsub(iy, by), fx = fsub(ix, bx);
  const float wy[2] = {fsub(1.f, fy), fy};
  const float wx[2] = {fsub(1.f, fx), fx};
  const int yb = (int)clampf(by, -2.f, (float)a.g0 + 1.f);
  const int xb = (int)clampf(bx, -2.f, (float)a.g1 + 1.f);
  const int ys[2] = {clampi(yb, 0, a.g0 - 1), clampi(yb + 1, 0, a.g0 - 1)};
  const int xs[2] = {clampi(xb, 0, a.g1 - 1), clampi(xb + 1, 0, a.g1 - 1)};
  for (int k = 0; k < 4; ++k) {
    float acc = 0.f;
    for (int t = 0; t < 4; ++t) {
      const float w = fmul(wy[t >> 1], wx[t & 1]);
      const float c = w == 0.f ? 0.f
                               : fmul(w, jac_at(a, m, k, ys[t >> 1], xs[t & 1]));
      acc = t == 0 ? c : fadd(acc, c);
    }
    jac[k] = acc;
  }
}

__global__ void __launch_bounds__(kInvertThreads)
invert_kernel(const InvertArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kInvertThreads + threadIdx.x;
  if (i >= a.n) return;
  const int64_t plane = (int64_t)a.oy * a.ox;
  const int64_t b = i / plane;
  const int node = (int)(i - b * plane);
  const int qy = node / a.ox, qx = node - qy * a.ox;
  const float* m = a.abs_map + b * 2 * (int64_t)a.g0 * a.g1;
  const float* q = a.query + b * a.q_bstride + node;
  const float q0 = __ldg(q), q1 = __ldg(q + plane);
  float* o = a.out + b * 2 * plane + node;

  float p0 = q0, p1 = q1, s0, s1;
  for (int it = 0; it < a.num_iters; ++it) {
    sample_d(a, m, qy, qx, p0, p1, s0, s1);
    p0 = fadd(p0, fmul(0.6f, fsub(q0, fadd(p0, s0))));
    p1 = fadd(p1, fmul(0.6f, fsub(q1, fadd(p1, s1))));
  }
  if (residual_ok(a, m, qy, qx, p0, p1, q0, q1)) {
    o[0] = p0;
    o[plane] = p1;
    return;
  }
  if (a.newton_iters <= 0) {
    o[0] = o[plane] = NAN;
    return;
  }
  // Re-seeded at the query: damped Newton with the sampled Jacobian.
  p0 = q0;
  p1 = q1;
  for (int it = 0; it < a.newton_iters; ++it) {
    sample_d(a, m, qy, qx, p0, p1, s0, s1);
    const float r0 = fsub(q0, fadd(p0, s0));
    const float r1 = fsub(q1, fadd(p1, s1));
    float jac[4];
    sample_jac(a, m, fsub(fdiv(p1, a.stride_y), a.src_y),
               fsub(fdiv(p0, a.stride_x), a.src_x), jac);
    const float ja = fadd(1.f, jac[0]), je = fadd(1.f, jac[3]);
    const float det = fsub(fmul(ja, je), fmul(jac[1], jac[2]));
    const bool safe = fabsf(det) > 0.005f;
    float st0, st1;
    if (safe) {
      const float inv_det = fdiv(1.f, det);
      st0 = fmul(fsub(fmul(je, r0), fmul(jac[1], r1)), inv_det);
      st1 = fmul(fadd(fmul(-jac[2], r0), fmul(ja, r1)), inv_det);
    } else {
      st0 = fmul(0.6f, r0);
      st1 = fmul(0.6f, r1);
    }
    p0 = fadd(p0, clampf(st0, -a.lim, a.lim));
    p1 = fadd(p1, clampf(st1, -a.lim, a.lim));
  }
  const bool ok = residual_ok(a, m, qy, qx, p0, p1, q0, q1);
  o[0] = ok ? p0 : NAN;
  o[plane] = ok ? p1 : NAN;
}

// ------------------------------------------------------------------ fill

constexpr int kMaxLevels = 32;
constexpr int kDownTile = 64;        // level-a nodes a side of a prep tile
constexpr int kDownLevels = 6;       // levels one prep launch builds
constexpr int kCoarseNodes = 4096;   // levels at most this large: coarse_kernel
constexpr int kPrepThreads = 256;
constexpr int kCoarseThreads = 1024;
constexpr int kTile = 32;            // level_kernel: interior nodes a side
constexpr int kHalo = 16;            // and its halo: sweeps a launch
constexpr int kRegion = kTile + 2 * kHalo;
// level_kernel's shared memory: two sweep buffers and the values (floats)
// and keep flags (bytes) of a tile with its halo.
constexpr int kLevelSmem = 13 * kRegion * kRegion;
constexpr int kSmemMax = 232448;     // shared memory a block may take (H100)
constexpr int kLevelThreads = 512;
constexpr int kJfaThreads = 256;

enum Mode { kFill = 0, kFillExtrapolate = 1, kNearest = 2 };

struct Level {
  int h, w;
  int64_t v, wt, f;  // float offsets of the level's values, weights and
                     // filled values ([F, h, w] each) in the scratch
};

struct FillArgs {
  const float* values;  // [F, g0, g1]: F = L * C fields
  const uint8_t* valid;  // [L, g0, g1]
  float* out;            // [F, g0, g1]
  float* fs;             // float scratch
  int32_t* is;           // int scratch
  int F, C, L, mode, iters, n_levels, coarse;
  int64_t rowlo, rowhi, collo, colhi, anyv;  // int offsets: hull extents
  Level lv[kMaxLevels];
};

__device__ __forceinline__ bool hull_at(const FillArgs& A, int m, int y,
                                        int x) {
  const int g0 = A.lv[0].h, g1 = A.lv[0].w;
  const int32_t* is = A.is;
  return is[A.rowlo + (int64_t)m * g0 + y] <= x &&
         x <= is[A.rowhi + (int64_t)m * g0 + y] &&
         is[A.collo + (int64_t)m * g1 + x] <= y &&
         y <= is[A.colhi + (int64_t)m * g1 + x];
}

// Level-0 weight and value of field f at flat node i: the plain version's
// where(valid, values, 0) and valid as 0 / 1.
__device__ __forceinline__ void level0(const FillArgs& A, int f, int64_t i,
                                       float& v, float& w) {
  const int64_t hw = (int64_t)A.lv[0].h * A.lv[0].w;
  const bool ok = A.valid[(int64_t)(f / A.C) * hw + i] != 0;
  v = ok ? A.values[(int64_t)f * hw + i] : 0.f;
  w = ok ? 1.f : 0.f;
}

// One valid-weighted 2x2 average: pair sums along y, then along x.
__device__ __forceinline__ void down4(float vw00, float vw10, float vw01,
                                      float vw11, float w00, float w10,
                                      float w01, float w11, float& v,
                                      float& w) {
  const float sv = fadd(fadd(vw00, vw10), fadd(vw01, vw11));
  const float sw = fadd(fadd(w00, w10), fadd(w01, w11));
  v = fdiv(sv, fmaxf(sw, 1e-12f));
  w = fminf(sw, 1.f);
}

// The row (x) and column (y) extents of mask m's valid nodes, and whether
// it has any: one warp a line.
__device__ void hull_role(const FillArgs& A, int m) {
  const int g0 = A.lv[0].h, g1 = A.lv[0].w;
  const uint8_t* valid = A.valid + (int64_t)m * g0 * g1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int any = 0;
  for (int line = warp; line < g0 + g1; line += kPrepThreads / 32) {
    const bool row = line < g0;
    const int n = row ? g1 : g0;
    int lo = INT32_MAX, hi = -1;
    for (int t = lane; t < n; t += 32) {
      const int64_t idx = row ? (int64_t)line * g1 + t
                              : (int64_t)t * g1 + (line - g0);
      if (valid[idx]) {
        lo = min(lo, t);
        hi = max(hi, t);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      if (row) {
        A.is[A.rowlo + (int64_t)m * g0 + line] = lo;
        A.is[A.rowhi + (int64_t)m * g0 + line] = hi;
      } else {
        A.is[A.collo + (int64_t)m * g1 + line - g0] = lo;
        A.is[A.colhi + (int64_t)m * g1 + line - g0] = hi;
      }
    }
    any |= hi >= 0;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) A.is[A.anyv + m] = any;
}

// Blocks [0, n_down): levels a + 1 .. b of one field from a 64 x 64 tile of
// level a (level-k node (Y, X) averages level-a nodes [Y, Y + 1) * 2^(k-a),
// so a tile's tree is its own; nodes past the level's edge weigh 0, as the
// plain version's zero padding). Blocks after: hull_role, one a mask.
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const FillArgs A, int a, int b, int n_down) {
  if ((int)blockIdx.x >= n_down) {
    hull_role(A, blockIdx.x - n_down);
    return;
  }
  __shared__ float svw[kDownTile * kDownTile];
  __shared__ float sw[kDownTile * kDownTile];
  const Level& la = A.lv[a];
  const int tx_n = (la.w + kDownTile - 1) / kDownTile;
  const int ty_n = (la.h + kDownTile - 1) / kDownTile;
  const int f = blockIdx.x / (tx_n * ty_n);
  const int r = blockIdx.x - f * tx_n * ty_n;
  const int ty = r / tx_n, tx = r - ty * tx_n;
  const int64_t hw = (int64_t)la.h * la.w;
  for (int i = threadIdx.x; i < kDownTile * kDownTile; i += kPrepThreads) {
    const int y = ty * kDownTile + i / kDownTile;
    const int x = tx * kDownTile + i % kDownTile;
    float v = 0.f, w = 0.f;
    if (y < la.h && x < la.w) {
      const int64_t n = (int64_t)y * la.w + x;
      if (a == 0) {
        level0(A, f, n, v, w);
      } else {
        v = A.fs[la.v + f * hw + n];
        w = A.fs[la.wt + f * hw + n];
      }
    }
    svw[i] = fmul(v, w);
    sw[i] = w;
  }
  __syncthreads();
  int n = kDownTile;
  for (int k = a + 1; k <= b; ++k) {
    const int src = n;
    n >>= 1;
    const Level& lk = A.lv[k];
    const int64_t hwk = (int64_t)lk.h * lk.w;
    float nvw[kDownTile * kDownTile / 4 / kPrepThreads + 1];
    float nw[kDownTile * kDownTile / 4 / kPrepThreads + 1];
    int cnt = 0;
    for (int i = threadIdx.x; i < n * n; i += kPrepThreads, ++cnt) {
      const int Y = i / n, X = i % n;
      const int c00 = 2 * Y * src + 2 * X;
      float v, w;
      down4(svw[c00], svw[c00 + src], svw[c00 + 1], svw[c00 + src + 1],
            sw[c00], sw[c00 + src], sw[c00 + 1], sw[c00 + src + 1], v, w);
      const int gy = ty * n + Y, gx = tx * n + X;
      if (gy < lk.h && gx < lk.w) {
        A.fs[lk.v + f * hwk + (int64_t)gy * lk.w + gx] = v;
        A.fs[lk.wt + f * hwk + (int64_t)gy * lk.w + gx] = w;
      }
      nvw[cnt] = fmul(v, w);
      nw[cnt] = w;
    }
    __syncthreads();
    cnt = 0;
    for (int i = threadIdx.x; i < n * n; i += kPrepThreads, ++cnt) {
      svw[i] = nvw[cnt];
      sw[i] = nw[cnt];
    }
    __syncthreads();
  }
}

// Linear 2x upsampling of src [hs, ws] at target node (y, x): the plain
// version's corners in its order, (lo, lo), (hi, lo), (lo, hi), (hi, hi).
__device__ __forceinline__ float upsample_at(const float* src, int hs, int ws,
                                             int y, int x) {
  const float cy = fdiv(fsub((float)y, 0.5f), 2.f);
  const float cx = fdiv(fsub((float)x, 0.5f), 2.f);
  const int by = hs == 1 ? 0 : clampi((int)floorf(cy), 0, hs - 2);
  const int bx = ws == 1 ? 0 : clampi((int)floorf(cx), 0, ws - 2);
  const float fy = clampf(fsub(cy, (float)by), 0.f, 1.f);
  const float fx = clampf(fsub(cx, (float)bx), 0.f, 1.f);
  const int sy = hs > 1 ? ws : 0, sx = ws > 1 ? 1 : 0;
  const float* p = src + by * ws + bx;
  float out = fmul(fmul(fsub(1.f, fy), fsub(1.f, fx)), p[0]);
  out = fadd(out, fmul(fmul(fy, fsub(1.f, fx)), p[sy]));
  out = fadd(out, fmul(fmul(fsub(1.f, fy), fx), p[sx]));
  out = fadd(out, fmul(fmul(fy, fx), p[sy + sx]));
  return out;
}

// One Jacobi update of a free node: its four neighbours in the plain
// version's offset order (y + 1, y - 1, x + 1, x - 1), a missing one
// counting as the centre, then / 4.
__device__ __forceinline__ float jacobi_at(float dn, float up, float rt,
                                           float lf) {
  return fdiv(fadd(fadd(fadd(dn, up), rt), lf), 4.f);
}

// One block a field: every level from `coarse` to the last in shared
// memory. Downsample, the coarsest level's weighted mean into its holes,
// then per level upsample, keep the level's own values where it has
// weight, and `iters` Jacobi sweeps; writes the filled level `coarse`.
__global__ void __launch_bounds__(kCoarseThreads)
coarse_kernel(const FillArgs A) {
  extern __shared__ float sm[];
  const int f = blockIdx.x, c = A.coarse, last = A.n_levels - 1;
  float* sv[kMaxLevels];
  float* swt[kMaxLevels];
  float* p = sm;
  for (int k = c; k <= last; ++k) {
    const int hw = A.lv[k].h * A.lv[k].w;
    sv[k] = p;
    swt[k] = p + hw;
    p += 2 * hw;
  }
  const int nc = A.lv[c].h * A.lv[c].w;
  float* buf[2] = {p, p + nc};

  for (int i = threadIdx.x; i < nc; i += kCoarseThreads) {
    if (c == 0) {
      level0(A, f, i, sv[c][i], swt[c][i]);
    } else {
      sv[c][i] = A.fs[A.lv[c].v + (int64_t)f * nc + i];
      swt[c][i] = A.fs[A.lv[c].wt + (int64_t)f * nc + i];
    }
  }
  __syncthreads();
  for (int k = c + 1; k <= last; ++k) {
    const int hs = A.lv[k - 1].h, ws = A.lv[k - 1].w;
    const int h = A.lv[k].h, w = A.lv[k].w;
    for (int i = threadIdx.x; i < h * w; i += kCoarseThreads) {
      const int Y = i / w, X = i % w;
      float vw[4], ww[4];
      for (int t = 0; t < 4; ++t) {  // (2Y, 2X), (2Y+1, 2X), (2Y, 2X+1), ...
        const int y = 2 * Y + (t & 1), x = 2 * X + (t >> 1);
        const bool in = y < hs && x < ws;
        ww[t] = in ? swt[k - 1][y * ws + x] : 0.f;
        vw[t] = in ? fmul(sv[k - 1][y * ws + x], ww[t]) : 0.f;
      }
      down4(vw[0], vw[1], vw[2], vw[3], ww[0], ww[1], ww[2], ww[3], sv[k][i],
            swt[k][i]);
    }
    __syncthreads();
  }
  {
    const int n = A.lv[last].h * A.lv[last].w;
    float ws = 0.f, vs = 0.f;
    for (int i = 0; i < n; ++i) {
      ws = fadd(ws, swt[last][i]);
      vs = fadd(vs, fmul(sv[last][i], swt[last][i]));
    }
    const float mean = fdiv(vs, fmaxf(ws, 1e-12f));
    for (int i = threadIdx.x; i < n; i += kCoarseThreads)
      buf[0][i] = swt[last][i] > 0.f ? sv[last][i] : mean;
  }
  __syncthreads();
  int cur = 0;
  for (int k = last - 1; k >= c; --k) {
    const int hs = A.lv[k + 1].h, ws = A.lv[k + 1].w;
    const int h = A.lv[k].h, w = A.lv[k].w;
    for (int i = threadIdx.x; i < h * w; i += kCoarseThreads) {
      buf[cur ^ 1][i] = swt[k][i] > 0.f
                            ? sv[k][i]
                            : upsample_at(buf[cur], hs, ws, i / w, i % w);
    }
    __syncthreads();
    cur ^= 1;
    for (int s = 0; s < A.iters; ++s) {
      const float* u = buf[cur];
      for (int i = threadIdx.x; i < h * w; i += kCoarseThreads) {
        const int y = i / w, x = i % w;
        const float v = u[i];
        buf[cur ^ 1][i] =
            swt[k][i] > 0.f
                ? sv[k][i]
                : jacobi_at(y + 1 < h ? u[i + w] : v, y > 0 ? u[i - w] : v,
                            x + 1 < w ? u[i + 1] : v, x > 0 ? u[i - 1] : v);
      }
      __syncthreads();
      cur ^= 1;
    }
  }
  for (int i = threadIdx.x; i < nc; i += kCoarseThreads)
    A.fs[A.lv[c].f + (int64_t)f * nc + i] = buf[cur][i];
}

// Level k on 32 x 32 tiles: each block loads its tile with a kHalo-node
// halo, runs `sweeps` (<= kHalo) Jacobi sweeps there (a halo node's error
// moves one node a sweep and never reaches the tile), and writes the tile.
// `prev` null: start from the upsampled level k + 1; else from prev.
__global__ void __launch_bounds__(kLevelThreads)
level_kernel(const FillArgs A, int k, int sweeps, const float* prev,
             float* dst) {
  extern __shared__ float sm[];
  float* buf[2] = {sm, sm + kRegion * kRegion};
  float* orig = sm + 2 * kRegion * kRegion;
  uint8_t* keep = (uint8_t*)(sm + 3 * kRegion * kRegion);
  const Level& lk = A.lv[k];
  const int h = lk.h, w = lk.w;
  const int64_t hw = (int64_t)h * w;
  const int tx_n = (w + kTile - 1) / kTile, ty_n = (h + kTile - 1) / kTile;
  const int f = blockIdx.x / (tx_n * ty_n);
  const int r = blockIdx.x - f * tx_n * ty_n;
  const int y0 = (r / tx_n) * kTile - kHalo, x0 = (r % tx_n) * kTile - kHalo;
  const Level& ls = A.lv[k + 1];
  const float* src = A.fs + ls.f + f * (int64_t)ls.h * ls.w;

  for (int i = threadIdx.x; i < kRegion * kRegion; i += kLevelThreads) {
    const int y = y0 + i / kRegion, x = x0 + i % kRegion;
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    const int64_t n = (int64_t)y * w + x;
    float v, wt;
    if (k == 0) {
      level0(A, f, n, v, wt);
    } else {
      v = A.fs[lk.v + f * hw + n];
      wt = A.fs[lk.wt + f * hw + n];
    }
    orig[i] = v;
    keep[i] = wt > 0.f;
    if (prev != nullptr) {
      buf[0][i] = prev[f * hw + n];
    } else {
      buf[0][i] = wt > 0.f ? v : upsample_at(src, ls.h, ls.w, y, x);
    }
  }
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < sweeps; ++s) {
    const float* u = buf[cur];
    for (int i = threadIdx.x; i < kRegion * kRegion; i += kLevelThreads) {
      const int ry = i / kRegion, rx = i % kRegion;
      const int y = y0 + ry, x = x0 + rx;
      if (y < 0 || y >= h || x < 0 || x >= w) continue;
      const float v = u[i];
      buf[cur ^ 1][i] =
          keep[i] ? orig[i]
                  : jacobi_at(y + 1 < h && ry + 1 < kRegion ? u[i + kRegion] : v,
                              y > 0 && ry > 0 ? u[i - kRegion] : v,
                              x + 1 < w && rx + 1 < kRegion ? u[i + 1] : v,
                              x > 0 && rx > 0 ? u[i - 1] : v);
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = threadIdx.x; i < kTile * kTile; i += kLevelThreads) {
    const int ry = kHalo + i / kTile, rx = kHalo + i % kTile;
    const int y = y0 + ry, x = x0 + rx;
    if (y < h && x < w) dst[f * hw + (int64_t)y * w + x] = buf[cur][ry * kRegion + rx];
  }
}

// A field's value in the input of the nearest fill at flat node n: the
// interpolated field inside the hull (its own values where valid), NaN
// outside; in kNearest mode the values themselves.
__device__ __forceinline__ float fill_value(const FillArgs& A, int f, int m,
                                            int y, int x) {
  const int g1 = A.lv[0].w;
  const int64_t hw = (int64_t)A.lv[0].h * g1, n = (int64_t)y * g1 + x;
  const float val = A.values[f * hw + n];
  if (A.mode == kNearest) return val;
  if (!hull_at(A, m, y, x)) return NAN;
  return A.valid[m * hw + n] ? val : A.fs[A.lv[0].f + f * hw + n];
}

// One jump-flooding pass with step `step` (0: none) over [L, g0, g1]
// nodes. `in` null: the seeds are the mask's own nodes (hull or valid);
// `seeds_out` null: the last pass, which writes the output of each field.
__global__ void __launch_bounds__(kJfaThreads)
jfa_kernel(const FillArgs A, int step, const int32_t* in, int32_t* seeds_out) {
  const int g0 = A.lv[0].h, g1 = A.lv[0].w;
  const int64_t hw = (int64_t)g0 * g1;
  const int64_t i = (int64_t)blockIdx.x * kJfaThreads + threadIdx.x;
  if (i >= (int64_t)A.L * hw) return;
  const int m = (int)(i / hw);
  const int node = (int)(i - m * hw);
  const int y = node / g1, x = node - y * g1;

  auto seed_of = [&](int yy, int xx) -> int32_t {
    if (in != nullptr) return in[m * hw + (int64_t)yy * g1 + xx];
    const bool ok = A.valid[m * hw + (int64_t)yy * g1 + xx] != 0;
    const bool seed = A.mode == kNearest ? ok : (ok || hull_at(A, m, yy, xx));
    return seed ? yy * g1 + xx : -1;
  };
  auto dist2 = [&](int32_t s) -> float {
    if (s < 0) return 1e12f;
    const int sy = s / g1, sx = s - (s / g1) * g1;
    const float dy = fsub((float)sy, (float)y), dx = fsub((float)sx, (float)x);
    return fadd(fmul(dy, dy), fmul(dx, dx));
  };

  int32_t best = -1;
  if (A.mode != kFill) {
    best = seed_of(y, x);
    float best_d2 = dist2(best);
    for (int t = 0; step > 0 && t < 9; ++t) {
      if (t == 4) continue;
      const int yy = y - (t / 3 - 1) * step, xx = x - (t % 3 - 1) * step;
      if (yy < 0 || yy >= g0 || xx < 0 || xx >= g1) continue;
      const int32_t cand = seed_of(yy, xx);
      const float d2 = dist2(cand);
      if (d2 < best_d2) {
        best = cand;
        best_d2 = d2;
      }
    }
  }
  if (seeds_out != nullptr) {
    seeds_out[i] = best;
    return;
  }
  const bool ok = A.valid[i] != 0;
  const bool any = A.mode == kNearest || A.is[A.anyv + m] != 0;
  const bool seeded = A.mode == kNearest ? ok : (ok || hull_at(A, m, y, x));
  for (int ch = 0; ch < A.C; ++ch) {
    const int f = m * A.C + ch;
    const float val = A.values[f * hw + node];
    float o;
    if (!any) {
      o = val;
    } else if (A.mode == kFill) {
      o = ok ? val : (hull_at(A, m, y, x) ? A.fs[A.lv[0].f + f * hw + node] : NAN);
    } else {
      const float own = fill_value(A, f, m, y, x);
      o = best < 0 || seeded ? own : fill_value(A, f, m, best / g1, best % g1);
    }
    A.out[f * hw + node] = o;
  }
}

int blocks_of(int64_t n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// abs_map [B, 2, g0, g1], query [B or 1, 2, oy, ox] (q_bstride 0 for one),
// out [B, 2, oy, ox]: all float32, contiguous, on one card.
int invert_section_launch(const float* abs_map, const float* query,
                          float* out, int64_t q_bstride, int64_t nb, int g0,
                          int g1, int oy, int ox, float src_y, float src_x,
                          float stride_y, float stride_x, int num_iters,
                          int newton_iters, float thr, float lim, float bnd1,
                          int org_y, int org_x, void* stream) {
  const int64_t n = nb * oy * ox;
  if (n <= 0) return 0;
  const InvertArgs a = {abs_map, query, out, q_bstride, n, g0, g1, oy, ox,
                        src_y, src_x, stride_y, stride_x, num_iters,
                        newton_iters, thr, lim, bnd1, org_y, org_x};
  invert_kernel<<<blocks_of(n, kInvertThreads), kInvertThreads, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The fill's launch table (ops/cuda_invert.py `_fill_table`), int64:
//   [0] levels  [1] coarse  [2] iters  [3] mode  [4] launches
//   [5] coarse smem bytes  [6] level smem bytes
//   [7 .. 11] int offsets: rowlo, rowhi, collo, colhi, any
//   [12 .. 16] the constants the host laid it out with: kTile, kHalo,
//     kCoarseNodes, kDownTile, kDownLevels (a table that differs from
//     this file's is refused)
//   then 5 a level: h, w, and the float offsets of v, w, filled;
//   then 5 a launch: kind, and its arguments:
//     0 prep (a, b, down blocks, masks), 1 jump flooding (step, in, out
//     int offsets; -1 none), 2 coarse, 3 level (k, sweeps, prev, dst float
//     offsets; -1 prev: upsample).
int fill_invalid_launch(const float* values, const uint8_t* valid,
                        float* out, float* fs, int32_t* is,
                        const int64_t* table, int F, int C, int L,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  FillArgs A;
  A.values = values;
  A.valid = valid;
  A.out = out;
  A.fs = fs;
  A.is = is;
  A.F = F;
  A.C = C;
  A.L = L;
  A.n_levels = (int)table[0];
  A.coarse = (int)table[1];
  A.iters = (int)table[2];
  A.mode = (int)table[3];
  const int launches = (int)table[4];
  const int coarse_smem = (int)table[5], level_smem = (int)table[6];
  A.rowlo = table[7];
  A.rowhi = table[8];
  A.collo = table[9];
  A.colhi = table[10];
  A.anyv = table[11];
  if (A.n_levels > kMaxLevels || table[12] != kTile || table[13] != kHalo ||
      table[14] != kCoarseNodes || table[15] != kDownTile ||
      table[16] != kDownLevels || level_smem != kLevelSmem ||
      coarse_smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int64_t* t = table + 17;
  for (int k = 0; k < A.n_levels; ++k, t += 5)
    A.lv[k] = {(int)t[0], (int)t[1], t[2], t[3], t[4]};
  // The shared-memory opt-in, once per device and at the bound every table
  // keeps to, so that threads filling grids of other shapes never lower
  // it under another's launch (a racing second call only sets it again).
  static unsigned long long opted = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (coarse_smem > optin) return (int)cudaErrorInvalidValue;
  if (dev >= 64 || !(opted >> dev & 1)) {
    err = cudaFuncSetAttribute(
        coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin < kSmemMax ? optin : kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kLevelSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted |= 1ull << dev;
  }
  const int64_t nodes = (int64_t)L * A.lv[0].h * A.lv[0].w;
  for (int l = 0; l < launches; ++l, t += 5) {
    switch (t[0]) {
      case 0:
        if (t[2] - t[1] > kDownLevels) return (int)cudaErrorInvalidValue;
        prep_kernel<<<(int)(t[3] + t[4]), kPrepThreads, 0, s>>>(
            A, (int)t[1], (int)t[2], (int)t[3]);
        break;
      case 1:
        jfa_kernel<<<blocks_of(nodes, kJfaThreads), kJfaThreads, 0, s>>>(
            A, (int)t[1], t[2] < 0 ? nullptr : is + t[2],
            t[3] < 0 ? nullptr : is + t[3]);
        break;
      case 2:
        coarse_kernel<<<F, kCoarseThreads, coarse_smem, s>>>(A);
        break;
      case 3: {
        const Level& lk = A.lv[t[1]];
        const int tiles = ((lk.h + kTile - 1) / kTile) * ((lk.w + kTile - 1) / kTile);
        level_kernel<<<tiles * F, kLevelThreads, kLevelSmem, s>>>(
            A, (int)t[1], (int)t[2], t[3] < 0 ? nullptr : fs + t[3], fs + t[4]);
        break;
      }
      default:
        return (int)cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
