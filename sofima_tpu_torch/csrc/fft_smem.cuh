// Shared-memory mixed-radix FFT for batches of small 2d transforms, and the
// circular cross-correlation of two real patches built on it.
//
// Replaces the dense O(p^3) DFT that the correlation kernels ported from
// sofima_tpu/ops/pallas_flow.py compute per patch pair (the TPU feeds its
// matrix unit DFT matrices; an SM has no such unit for f32). Its users:
// K7 (corr_fft.cu, the reference's `_corr_kernel`), K5's fully valid
// pairs (masked_flow.cu), K1 / K2 up to p = 168 (flow_peaks.cu) and K6
// where the pair fits in shared memory (patch_corr.cu, e.g. 160 x 80);
// K5's other pairs and larger K1 / K2 / K6 patches still run DFT bodies.
// Its functions have internal linkage: each translation unit that
// includes it keeps its own copy.
//
// What bounds it on the H100: at p = 160 a pair's packed complex array is
// 200 KB, so one block per SM holds it and every transform stage is a
// read and a write of it in shared memory (128 B per clock per SM). The
// arithmetic is ~5 N log2 N per complex 2d transform, about 22x less than
// the dense DFT's at p = 160. The design keeps the stage count and the
// shared-memory traffic per stage low:
//  * n = r_1 ... r_S with radices 8, 4, 2 (the powers of 2 first), 5 and
//    3, each a butterfly in registers; any other prime factor r <= 2048
//    takes a generic radix-r stage (O(r) per output) in the same pass;
//  * in-place Cooley-Tukey stages, so no ping-pong buffer: a butterfly
//    reads r values and writes them back to the same words. The forward
//    transforms are decimation in time (twiddle, then butterfly) and read
//    their input in digit-reversed order, which the patch load scatters
//    it into; the inverse transforms are decimation in frequency and
//    leave digit-reversed output, which the surface store gathers back.
//    No permutation pass;
//  * twiddles w_L^{jt} computed on the host in float64 and rounded to
//    f32, stored per stage as [t][j], so neighbouring threads (neighbouring
//    j) read neighbouring words;
//  * row passes (element stride 1) give neighbouring butterflies of one
//    transform to neighbouring threads, column passes neighbouring
//    transforms: both read consecutive words, free of bank conflicts.
//
// Two real patches make one complex signal z = a + i b: one complex 2d FFT
// gives both spectra, A = (Z[k] + conj Z[-k]) / 2 and B = (Z[k] -
// conj Z[-k]) / 2i. The cross power A conj(B) is formed on the half
// spectrum only (p1 x (p2/2 + 1)), inverted along the columns, and its
// rows are packed two by two (Y = H[2j] + i H[2j+1], completed by
// Hermitian symmetry), so one complex row inverse gives two real rows.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fftsm {

// Axis lengths up to 2048 have at most 11 stages.
constexpr int kMaxStages = 12;
constexpr int kMaxLength = 2048;
// Outputs per thread in one chunk of a generic radix-r stage (r <= 4 x the
// block's threads).
constexpr int kGenericOut = 4;

// One axis: DIF stage s splits sub-transforms of length L[s] with radix
// r[s] and stride m[s] = L[s] / r[s]; its twiddles w_L^{jt} (t = 1..r-1,
// j < m) sit at tw[toff[s] + (t - 1) m + j].
struct Axis {
  int n, nst;
  int r[kMaxStages], m[kMaxStages], L[kMaxStages], toff[kMaxStages];
};

// Host side: an Axis from its radices in DIF order (the wrapper's
// `_fft_axis_np` builds the tables from the same radices). False if they
// do not multiply to n.
inline bool make_axis(Axis* a, int n, int nst, const int* radices) {
  if (n < 1 || n > kMaxLength || nst < 0 || nst > kMaxStages) return false;
  a->n = n;
  a->nst = nst;
  int L = n, off = 0;
  for (int s = 0; s < nst; ++s) {
    const int r = radices[s];
    if (r < 2 || L % r) return false;
    a->r[s] = r;
    a->L[s] = L;
    a->m[s] = L / r;
    a->toff[s] = off;
    off += (r - 1) * (L / r);
    L /= r;
  }
  return L == 1;
}

__device__ __forceinline__ float2 c_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 c_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 c_scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
// a w (forward) or a conj(w) (inverse).
template <bool kInv>
__device__ __forceinline__ float2 c_mul(float2 a, float2 w) {
  return kInv ? make_float2(a.x * w.x + a.y * w.y, a.y * w.x - a.x * w.y)
              : make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a (-i) (forward) or a (+i) (inverse).
template <bool kInv>
__device__ __forceinline__ float2 c_rot(float2 a) {
  return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// In-register DFT of r points, sign -1 (forward) or +1 (inverse).
template <int R, bool kInv>
struct Bfly;

template <bool kInv>
struct Bfly<2, kInv> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = v[0];
    v[0] = c_add(a, v[1]);
    v[1] = c_sub(a, v[1]);
  }
};

template <bool kInv>
struct Bfly<3, kInv> {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr float kS = 0.86602540378443865f;  // sin(2 pi / 3)
    const float2 t = c_add(v[1], v[2]);
    const float2 s = c_scale(c_rot<kInv>(c_sub(v[1], v[2])), kS);
    const float2 base = make_float2(v[0].x - 0.5f * t.x, v[0].y - 0.5f * t.y);
    v[0] = c_add(v[0], t);
    v[1] = c_add(base, s);
    v[2] = c_sub(base, s);
  }
};

template <bool kInv>
struct Bfly<4, kInv> {
  static __device__ __forceinline__ void run(float2* v) {
    const float2 a = c_add(v[0], v[2]), b = c_sub(v[0], v[2]);
    const float2 c = c_add(v[1], v[3]), d = c_rot<kInv>(c_sub(v[1], v[3]));
    v[0] = c_add(a, c);
    v[2] = c_sub(a, c);
    v[1] = c_add(b, d);
    v[3] = c_sub(b, d);
  }
};

template <bool kInv>
struct Bfly<5, kInv> {
  static __device__ __forceinline__ void run(float2* v) {
    // cos and sin of 2 pi / 5 and 4 pi / 5.
    constexpr float c1 = 0.30901699437494742f, c2 = -0.80901699437494742f;
    constexpr float s1 = 0.95105651629515357f, s2 = 0.58778525229247314f;
    const float2 t1 = c_add(v[1], v[4]), t2 = c_add(v[2], v[3]);
    const float2 u1 = c_sub(v[1], v[4]), u2 = c_sub(v[2], v[3]);
    const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x,
                                  v[0].y + c1 * t1.y + c2 * t2.y);
    const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x,
                                  v[0].y + c2 * t1.y + c1 * t2.y);
    const float2 b1 = c_rot<kInv>(make_float2(s1 * u1.x + s2 * u2.x,
                                              s1 * u1.y + s2 * u2.y));
    const float2 b2 = c_rot<kInv>(make_float2(s2 * u1.x - s1 * u2.x,
                                              s2 * u1.y - s1 * u2.y));
    v[0] = c_add(v[0], c_add(t1, t2));
    v[1] = c_add(a1, b1);
    v[4] = c_sub(a1, b1);
    v[2] = c_add(a2, b2);
    v[3] = c_sub(a2, b2);
  }
};

template <bool kInv>
struct Bfly<8, kInv> {
  static __device__ __forceinline__ void run(float2* v) {
    constexpr float h = 0.70710678118654752f;
    float2 e[4] = {v[0], v[2], v[4], v[6]};
    float2 o[4] = {v[1], v[3], v[5], v[7]};
    Bfly<4, kInv>::run(e);
    Bfly<4, kInv>::run(o);
    // o[k] *= w8^k, w8 = e^{-i pi / 4} (forward) or its conjugate.
    o[1] = kInv ? make_float2(h * (o[1].x - o[1].y), h * (o[1].x + o[1].y))
                : make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
    o[2] = c_rot<kInv>(o[2]);
    o[3] = kInv ? make_float2(-h * (o[3].x + o[3].y), h * (o[3].x - o[3].y))
                : make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = c_add(e[k], o[k]);
      v[k + 4] = c_sub(e[k], o[k]);
    }
  }
};

// floor(a / d) for 0 <= a < 2^22 from inv = 1 / d rounded: the float
// quotient is within one of the true one, and one correction fixes it.
__device__ __forceinline__ int fast_div(int a, int d, float inv) {
  const int q = __float2int_rz(__int2float_rn(a) * inv);
  const int r = a - q * d;
  return q + (r >= d) - (r < 0);
}

// Transform t and butterfly beta of work item `item` in a pass over `count`
// transforms of nb butterflies each.
__device__ __forceinline__ void split_item(int item, int count, int nb, int es,
                                           int& t, int& beta) {
  if (es == 1) {
    t = fast_div(item, nb, __frcp_rn((float)nb));
    beta = item - t * nb;
  } else {
    beta = fast_div(item, count, __frcp_rn((float)count));
    t = item - beta * count;
  }
}

// Stage s of `count` transforms of length ax.n, element i of transform t
// at d[t * ts + i * es]: DIT (twiddle, then butterfly) or DIF (butterfly,
// then twiddle), forward or inverse. Butterflies touch disjoint words, so
// a stage needs no barrier inside.
template <int R, bool kDit, bool kInv>
__device__ void stage(float2* d, int count, int es, int ts, const Axis& ax,
                      int s, const float2* __restrict__ tw) {
  const int m = ax.m[s], L = ax.L[s], off = ax.toff[s];
  const int nb = ax.n / R;
  const int total = nb * count;
  const int step = m * es;
  const float inv_m = __frcp_rn((float)m);
  for (int item = threadIdx.x; item < total; item += blockDim.x) {
    int t, beta;
    split_item(item, count, nb, es, t, beta);
    const int blk = fast_div(beta, m, inv_m), j = beta - blk * m;
    float2* p = d + t * ts + (blk * L + j) * es;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) v[q] = p[q * step];
    if (kDit) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[q] = c_mul<kInv>(v[q], tw[off + (q - 1) * m + j]);
    }
    Bfly<R, kInv>::run(v);
    if (!kDit) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[q] = c_mul<kInv>(v[q], tw[off + (q - 1) * m + j]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) p[q * step] = v[q];
  }
}

// A stage of any radix r <= kGenericOut * blockDim.x: each output is a
// sum of r terms (w_r^q = root[q n / r]), computed into registers for a
// chunk of whole butterflies, then written back after a barrier.
template <bool kDit, bool kInv>
__device__ void stage_generic(float2* d, int count, int es, int ts,
                              const Axis& ax, int s,
                              const float2* __restrict__ tw,
                              const float2* __restrict__ root) {
  const int R = ax.r[s], m = ax.m[s], L = ax.L[s], off = ax.toff[s];
  const int nb = ax.n / R, rstep = ax.n / R;
  const int total = nb * count;
  const int step = m * es;
  const int per = (kGenericOut * (int)blockDim.x) / R;  // butterflies/chunk
  for (int b0 = 0; b0 < total; b0 += per) {
    float2 res[kGenericOut];
    int addr[kGenericOut];
#pragma unroll
    for (int g = 0; g < kGenericOut; ++g) {
      const int o = g * blockDim.x + threadIdx.x;
      const int bb = b0 + o / R;
      addr[g] = -1;
      res[g] = make_float2(0.0f, 0.0f);
      if (o < per * R && bb < total) {
        const int q = o - (o / R) * R;
        int t, beta;
        split_item(bb, count, nb, es, t, beta);
        const int blk = beta / m, j = beta - blk * m;
        const int base = t * ts + (blk * L + j) * es;
        float2 acc = make_float2(0.0f, 0.0f);
        for (int u = 0; u < R; ++u) {
          float2 v = d[base + u * step];
          if (kDit && u > 0) v = c_mul<kInv>(v, tw[off + (u - 1) * m + j]);
          acc = c_add(acc, c_mul<kInv>(v, root[((u * q) % R) * rstep]));
        }
        if (!kDit && q > 0) acc = c_mul<kInv>(acc, tw[off + (q - 1) * m + j]);
        res[g] = acc;
        addr[g] = base + q * step;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kGenericOut; ++g)
      if (addr[g] >= 0) d[addr[g]] = res[g];
    __syncthreads();
  }
}

// All stages of `count` transforms (see `stage`): DIT runs them from the
// last to the first and reads digit-reversed input; DIF runs them in order
// and leaves digit-reversed output. Ends with a barrier after each stage.
template <bool kDit, bool kInv>
__device__ void fft_pass(float2* d, int count, int es, int ts, const Axis& ax,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ root) {
  for (int i = 0; i < ax.nst; ++i) {
    const int s = kDit ? ax.nst - 1 - i : i;
    switch (ax.r[s]) {
      case 2: stage<2, kDit, kInv>(d, count, es, ts, ax, s, tw); break;
      case 3: stage<3, kDit, kInv>(d, count, es, ts, ax, s, tw); break;
      case 4: stage<4, kDit, kInv>(d, count, es, ts, ax, s, tw); break;
      case 5: stage<5, kDit, kInv>(d, count, es, ts, ax, s, tw); break;
      case 8: stage<8, kDit, kInv>(d, count, es, ts, ax, s, tw); break;
      default:
        stage_generic<kDit, kInv>(d, count, es, ts, ax, s, tw, root);
    }
    __syncthreads();
  }
}

// (A conj B) * 4 * scale from z1 = Z[u, k] and zm = Z[-u, -k], Z = F(a + i b):
// with z2 = conj(zm), A = (z1 + z2) / 2 and B = (z1 - z2) / 2i, so
// A conj(B) = (z1 + z2) i conj(z1 - z2) / 4.
__device__ __forceinline__ float2 cross_power(float2 z1, float2 zm,
                                              float scale) {
  const float2 z2 = make_float2(zm.x, -zm.y);
  const float2 s = c_add(z1, z2), d = c_sub(z1, z2);
  return make_float2((s.x * d.y - s.y * d.x) * scale,
                     (s.x * d.x + s.y * d.y) * scale);
}

// The cross power on the half spectrum k < p2/2 + 1 of Z (natural order,
// row stride p2), in place. A column k < p2/2 reads its mirror -k, which
// lies outside the half and is never written; the self-conjugate columns
// (k = 0, p2/2) pair (u, k) with (-u, k) on one thread.
static __device__ void cross_power_half(float2* Z, int p1, int p2,
                                        float scale) {
  const int h2 = p2 / 2 + 1;
  for (int e = threadIdx.x; e < p1 * h2; e += blockDim.x) {
    const int u = e / h2, k = e - u * h2;
    const int um = u ? p1 - u : 0, km = k ? p2 - k : 0;
    if (km == k) {
      if (u > um) continue;
      const float2 z1 = Z[u * p2 + k], z2 = Z[um * p2 + k];
      Z[u * p2 + k] = cross_power(z1, z2, scale);
      if (um != u) Z[um * p2 + k] = cross_power(z2, z1, scale);
    } else {
      Z[u * p2 + k] = cross_power(Z[u * p2 + k], Z[um * p2 + km], scale);
    }
  }
}

// Two half-spectrum rows h1, h2 (entries k and, by symmetry, p2 - k) as one
// full row Y = H1 + i H2: Y[k] and Y[p2 - k]. The self-conjugate entries
// keep only their real parts, as irfft does.
__device__ __forceinline__ void pack_pair(float2 h1, float2 h2, bool self_conj,
                                          float2& yk, float2& ymk) {
  if (self_conj) {
    yk = make_float2(h1.x, h2.x);
    ymk = yk;
  } else {
    yk = make_float2(h1.x - h2.y, h1.y + h2.x);
    ymk = make_float2(h1.x + h2.y, h2.x - h1.y);
  }
}

// Packs the half-spectrum rows of Z (row stride p2) two by two in place:
// row 2j becomes the full Y of rows 2j and 2j + 1 (0 past the last row).
// Entry p2 - k of row 2j lies outside the half and is read by no one.
static __device__ void pack_rows(float2* Z, int p1, int p2) {
  const int h2 = p2 / 2 + 1, npair = (p1 + 1) / 2;
  for (int e = threadIdx.x; e < npair * h2; e += blockDim.x) {
    const int j = e / h2, k = e - j * h2;
    const float2 h1 = Z[2 * j * p2 + k];
    const float2 hb = 2 * j + 1 < p1 ? Z[(2 * j + 1) * p2 + k]
                                     : make_float2(0.0f, 0.0f);
    const bool sc = k == 0 || 2 * k == p2;
    float2 yk, ymk;
    pack_pair(h1, hb, sc, yk, ymk);
    Z[2 * j * p2 + k] = yk;
    if (!sc) Z[2 * j * p2 + p2 - k] = ymk;
  }
}

// Circular cross-correlation of the pair held as Z = a' + i b' at the
// digit-reversed positions (inv1[y], inv2[x]), row stride p2, in place:
// forward rows and columns (DIT), the cross power scaled by `scale`
// (1 / (4 p1 p2) for irfft2's normalization), the column inverse on the
// half spectrum and the packed row inverse (DIF). The surface value of
// unshifted (y, x) is then `surface_at(Z, p2, inv1[y], inv2[x])`.
// `a1` is the column axis (length p1), `a2` the row axis (p2).
static __device__ void corr_surface(float2* Z, const Axis& a1,
                                    const Axis& a2, const float2* tw1,
                                    const float2* root1, const float2* tw2,
                                    const float2* root2, float scale) {
  const int p1 = a1.n, p2 = a2.n;
  fft_pass<true, false>(Z, p1, 1, p2, a2, tw2, root2);
  fft_pass<true, false>(Z, p2, p2, 1, a1, tw1, root1);
  cross_power_half(Z, p1, p2, scale);
  __syncthreads();
  fft_pass<false, true>(Z, p2 / 2 + 1, p2, 1, a1, tw1, root1);
  pack_rows(Z, p1, p2);
  __syncthreads();
  fft_pass<false, true>(Z, (p1 + 1) / 2, 1, 2 * p2, a2, tw2, root2);
}

// Row position P's real row lives in packed row P & ~1: its real part for
// even P, its imaginary part for odd P.
__device__ __forceinline__ float surface_at(const float2* Z, int p2, int P,
                                            int Q) {
  const float2 v = Z[(P & ~1) * p2 + Q];
  return (P & 1) ? v.y : v.x;
}

}  // namespace fftsm
