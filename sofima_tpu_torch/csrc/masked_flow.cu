// K5: dense-grid masked flow peaks. Circular Padfield NCC of every patch
// pair under its valid-pixel masks, then the top-2 peak statistics.
//
// Replaces (sofima_tpu/ops/pallas_flow.py) dense_flow_peaks_pallas with
// `pre_valid` / `post_valid`: the body _grid_kernel_masked, with
// _masked_row_subgrouped (the six-term chain) and _ncc_full_valid_grouped
// (the closed form of a fully valid pair). What it computes is
// flow_field._masked_xcorr_circular per patch pair:
//
//   pz, cz  = the mean-removed patches, zero where invalid; va, vb masks
//   overlap = max(rint(va * vb), eps)          (* = circular correlation)
//   num     = pz * cz - (pz * vb)(va * cz) / overlap
//   var_p   = max(pz^2 * vb - (pz * vb)^2 / overlap, 0), var_c alike
//   denom   = sqrt(var_p var_c)
//   ncc     = denom > tol ? num / denom : 0, clipped to [-1, 1], and 0
//             where overlap < 0.3 p^2 (the grid kernel's fixed cut)
//
// The wrapper (ops/cuda_flow.py masked_dense_flow_peaks) classifies the
// grid on the device from exact valid-pixel counts and makes three lists:
//   * dead   (either patch without a valid pixel): the NaN rows the output
//            starts with, no launch;
//   * pure   (both fully valid): masked_pure_kernel, the closed form on
//            K7's shared-memory FFT (fft_smem.cuh): the overlap is p^2 at
//            every shift and the masked sums are the patch moments, so the
//            NCC is (xcorr - s1 s3 / p^2) / sqrt(var_p var_c), 3 real
//            transforms' worth of one complex 2d FFT pair;
//   * impure: masked_flow_kernel, the six forward half spectra (pz, cz,
//            va, vb, pz^2, cz^2) and six inverse surfaces (12 dense O(p^3)
//            DFTs), walking its list. Pure pairs the FFT route does not
//            serve (p > 160) join this list, and the kernel gives them
//            the same closed form on 3 dense DFTs.
// The tolerance is per patch, tol = 1e3 eps max|denom| over the patch's
// own surface (a constant denom for a pure pair). The reference shares it
// per TPU subgroup (grid kernel) or per dispatch batch (strip path); the
// three rules part only where a near-flat patch sits beside a textured
// one, and only the per-patch rule is independent of batching and layout.
// Means: with `subtract_mean`, each patch's mean over its valid pixels.
// No atomics, reductions in a fixed order: a second call repeats the
// first bit for bit.
//
// What bounds each route on the H100: operations.
//  * Pure: one block of 1024 threads per pair at a time (a persistent
//    grid), the pair's packed complex array (200 KB at p = 160) and the
//    FFT tables in shared memory, one block per SM. The two patches are
//    read straight from the images at their grid offsets (16-byte loads
//    where aligned), scattered into the transform's digit-reversed order,
//    summed on the way; the means come off in shared memory while the
//    four moments are taken. After the transform the NCC of each
//    centred position goes to registers (25 per thread at p = 160),
//    then over the first p^2 floats of the buffer, where the peak chain
//    (flow_peaks.cuh) reads it. Served for p^2 <= 25 x 1024 (p <= 160;
//    larger pure pairs take the dense route's closed form).
//  * Impure: 12 real 2d DFTs of O(p^3) multiply-adds each (plain FMA
//    loops, f32); the four p^2 input planes are read from L2/HBM a few
//    times each. Memory: a half spectrum S = 2 p (p/2 + 1) floats, a
//    surface P = p^2. The chain is sequenced so that at most 5 S + 3 P
//    floats are live: the mask spectra first, then one spectrum, one
//    product and one inverse at a time, each inverse's epilogue folding
//    its surface into the ones the numerator and denominators still need
//    (products are formed on the fly inside the column inverse). At p =
//    80 (the fine masked pass) that is 208 KB of shared memory, one block
//    per SM. At p = 160 (the coarse masked pass, bench.py's dense masked
//    grid) it is 826 KB, so each block of a persistent grid (4 per SM, at
//    most one per impure pair) works on its own slice of global scratch:
//    528 x 826 KB = 436 MB live, 9x the 50 MB L2, so that pass streams
//    its intermediates through HBM.

#include "fft_smem.cuh"
#include "flow_peaks.cuh"

namespace {

// The pure route's block, and the surface values each of its threads
// holds while the centred NCC is written over the transform's buffer
// (p^2 <= kHold kFftThreads: p <= 160).
constexpr int kFftThreads = 1024;
constexpr int kHold = 25;

enum PlaneKind { kPz = 0, kCz, kVa, kVb, kPz2, kCz2 };

struct Pair {
  const float* pre;
  const float* post;
  const float* vpre;
  const float* vpost;
  int w, y0, x0, p;
  float ma, mb;
};

// One pixel of a chain input plane (the dense grid keeps every patch
// inside the image, so no bounds checks).
__device__ __forceinline__ float plane_value(const Pair& q, int kind, int e) {
  const int yy = e / q.p, xx = e - yy * q.p;
  const int64_t o = (int64_t)(q.y0 + yy) * q.w + (q.x0 + xx);
  switch (kind) {
    case kVa: return __ldg(q.vpre + o) > 0.0f ? 1.0f : 0.0f;
    case kVb: return __ldg(q.vpost + o) > 0.0f ? 1.0f : 0.0f;
    case kPz:
    case kPz2: {
      const float v = __ldg(q.vpre + o) > 0.0f ? __ldg(q.pre + o) - q.ma : 0.0f;
      return kind == kPz ? v : v * v;
    }
    default: {
      const float v = __ldg(q.vpost + o) > 0.0f ? __ldg(q.post + o) - q.mb : 0.0f;
      return kind == kCz ? v : v * v;
    }
  }
}

// Half-spectrum 2d DFT of one plane into F (2 p hh floats: real, then
// imaginary parts). The plane is staged in F itself; T is the row spectrum.
__device__ void forward(const Pair& q, int kind, float* F, float* T,
                        const float* __restrict__ ctab,
                        const float* __restrict__ stab) {
  const int p = q.p, hh = p / 2 + 1, n = p * hh;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < p * p; e += nt) F[e] = plane_value(q, kind, e);
  __syncthreads();
  // Rows: X[y, k] = sum_x x[y, x] e^{-2 pi i xk/p}.
  for (int e = tid; e < n; e += nt) {
    const int y = e / hh, k = e - y * hh;
    const float* row = F + y * p;
    float re = 0.0f, im = 0.0f;
    for (int x = 0; x < p; ++x) {
      const float c = __ldg(ctab + x * p + k), s = __ldg(stab + x * p + k);
      const float v = row[x];
      re = fmaf(v, c, re);
      im = fmaf(-v, s, im);
    }
    T[e] = re;
    T[n + e] = im;
  }
  __syncthreads();
  // Columns: F[u, k] = sum_y e^{-2 pi i uy/p} X[y, k].
  for (int e = tid; e < n; e += nt) {
    const int u = e / hh, k = e - u * hh;
    const float* cu = ctab + u * p;
    const float* su = stab + u * p;
    float re = 0.0f, im = 0.0f;
    for (int y = 0; y < p; ++y) {
      const float c = __ldg(cu + y), s = __ldg(su + y);
      const float xr = T[y * hh + k], xi = T[n + y * hh + k];
      re += c * xr + s * xi;
      im += c * xi - s * xr;
    }
    F[e] = re;
    F[n + e] = im;
  }
  __syncthreads();
}

// The real surface irfft2(F1 conj(F2)) in centered layout (output (r, c)
// holds circular shift ((r - p/2) mod p, (c - p/2) mod p)), handed element
// by element to `epi(e, value)`. G (2 p hh floats) is scratch.
template <typename Epi>
__device__ void inverse_product(const float* F1, const float* F2, float* G,
                                int p, const float* __restrict__ ctab,
                                const float* __restrict__ stab, Epi epi) {
  const int hh = p / 2 + 1, n = p * hh;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int e = tid; e < n; e += nt) {
    const int r = e / hh, k = e - r * hh;
    const int yr = (r - p / 2 + p) % p;
    float g_r = 0.0f, g_i = 0.0f;
    for (int u = 0; u < p; ++u) {
      const int o = u * hh + k;
      const float ar = F1[o], ai = F1[n + o], br = F2[o], bi = F2[n + o];
      const float xr = ar * br + ai * bi;
      const float xi = ai * br - ar * bi;
      const float c = __ldg(ctab + u * p + yr), s = __ldg(stab + u * p + yr);
      g_r += c * xr - s * xi;
      g_i += c * xi + s * xr;
    }
    G[e] = g_r / (float)p;
    G[n + e] = g_i / (float)p;
  }
  __syncthreads();
  for (int e = tid; e < p * p; e += nt) {
    const int r = e / p, c = e - r * p;
    const int xc = (c - p / 2 + p) % p;
    float acc = 0.0f;
    for (int k = 0; k < hh; ++k) {
      const float alpha = (k == 0 || 2 * k == p) ? 1.0f : 2.0f;
      const float cs = __ldg(ctab + k * p + xc), sn = __ldg(stab + k * p + xc);
      acc += G[r * hh + k] * (alpha * cs) - G[n + r * hh + k] * (alpha * sn);
    }
    epi(e, acc / (float)p);
  }
  __syncthreads();
}

__device__ __forceinline__ float clip1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

// The dense-DFT body of the listed pairs (list[k] = gi gx + gj).
// ctab[j * p + k] = cos(2 pi jk / p), stab[j * p + k] = sin(2 pi jk / p).
__global__ void __launch_bounds__(kThreads)
masked_flow_kernel(const float* __restrict__ pre,
                   const float* __restrict__ post,
                   const float* __restrict__ vpre,
                   const float* __restrict__ vpost, int w,
                   const int* __restrict__ list, int n, int gx, int p, int sy,
                   int sx, const float* __restrict__ ctab,
                   const float* __restrict__ stab, int subtract_mean,
                   float mean_value, float cut, int min_y, int min_x,
                   float threshold_rel, int rad_y, int rad_x,
                   float* __restrict__ scratch, int64_t per_block,
                   int64_t plane, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t S = 2LL * p * (p / 2 + 1), P = (int64_t)p * p;
  float* base = scratch ? scratch + (int64_t)blockIdx.x * per_block : smem;
  float* T = base;       // row spectra / column-inverse scratch
  float* A = T + S;      // F(va), or F(pz) for a pure pair
  float* B = A + S;      // F(vb), then F(cz)
  float* C = B + S;      // F(pz), then F(cz^2)
  float* D = C + S;      // F(pz^2), then sum_c, then the NCC surface
  float* O = D + S;      // overlap
  float* SP = O + P;     // sum_p, then the numerator
  float* VP = SP + P;    // var_p, then denom
  float* SC = D;
  float* corr = D;
  const float area = (float)P;
  const float eps = 1.1920928955078125e-07f;  // float32 machine epsilon

  for (int k = blockIdx.x; k < n; k += gridDim.x) {
    const int pidx = list[k];
    const int gi = pidx / gx, gj = pidx - gi * gx;
    Pair q{pre, post, vpre, vpost, w, gi * sy, gj * sx, p, 0.0f, 0.0f};

    // 1. Exact valid-pixel counts and masked sums.
    float na = 0.0f, nb = 0.0f, sa = 0.0f, sb = 0.0f;
    for (int e = tid; e < p * p; e += nt) {
      const float a = plane_value(q, kVa, e), b = plane_value(q, kVb, e);
      const int yy = e / p, xx = e - yy * p;
      const int64_t o = (int64_t)(q.y0 + yy) * w + (q.x0 + xx);
      na += a;
      nb += b;
      sa += a > 0.0f ? __ldg(pre + o) : 0.0f;
      sb += b > 0.0f ? __ldg(post + o) : 0.0f;
    }
    na = block_reduce(na, redf, Add(), 0.0f);
    nb = block_reduce(nb, redf, Add(), 0.0f);
    sa = block_reduce(sa, redf, Add(), 0.0f);
    sb = block_reduce(sb, redf, Add(), 0.0f);
    if (na == 0.0f || nb == 0.0f) {  // dead: every overlap is zero
      if (tid == 0) write_row(out, plane, pidx, NAN, NAN, NAN, NAN);
      __syncthreads();
      continue;
    }
    q.ma = subtract_mean ? sa / fmaxf(na, 1.0f) : mean_value;
    q.mb = subtract_mean ? sb / fmaxf(nb, 1.0f) : mean_value;

    if (na == area && nb == area) {
      // 2a. Pure (listed here where the FFT route does not serve p): the
      // overlap is p^2 at every shift and the masked sums are the patch
      // moments, so the NCC is an affine rescale of the plain
      // cross-correlation.
      float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
      for (int e = tid; e < p * p; e += nt) {
        const float a = plane_value(q, kPz, e), b = plane_value(q, kCz, e);
        s1 += a;
        s2 += a * a;
        s3 += b;
        s4 += b * b;
      }
      s1 = block_reduce(s1, redf, Add(), 0.0f);
      s2 = block_reduce(s2, redf, Add(), 0.0f);
      s3 = block_reduce(s3, redf, Add(), 0.0f);
      s4 = block_reduce(s4, redf, Add(), 0.0f);
      const float var_p = fmaxf(s2 - s1 * s1 / area, 0.0f);
      const float var_c = fmaxf(s4 - s3 * s3 / area, 0.0f);
      const float denom = sqrtf(var_p * var_c);
      const float tol = 1e3f * eps * denom;
      const float numc = s1 * s3 / area;
      forward(q, kPz, A, T, ctab, stab);
      forward(q, kCz, B, T, ctab, stab);
      inverse_product(A, B, T, p, ctab, stab, [&](int e, float x) {
        corr[e] = denom > tol ? clip1((x - numc) / denom) : 0.0f;
      });
    } else {
      // 2b. Impure: the six-term chain, sequenced (see the header note).
      forward(q, kVa, A, T, ctab, stab);
      forward(q, kVb, B, T, ctab, stab);
      inverse_product(A, B, T, p, ctab, stab, [&](int e, float x) {
        O[e] = fmaxf(rintf(x), eps);
      });
      forward(q, kPz, C, T, ctab, stab);
      inverse_product(C, B, T, p, ctab, stab, [&](int e, float x) {
        SP[e] = x;
      });
      forward(q, kPz2, D, T, ctab, stab);
      inverse_product(D, B, T, p, ctab, stab, [&](int e, float x) {
        const float inv = 1.0f / O[e];
        VP[e] = fmaxf(x - SP[e] * SP[e] * inv, 0.0f);
      });
      forward(q, kCz, B, T, ctab, stab);
      inverse_product(A, B, T, p, ctab, stab, [&](int e, float x) {
        SC[e] = x;
      });
      inverse_product(C, B, T, p, ctab, stab, [&](int e, float x) {
        const float inv = 1.0f / O[e];
        SP[e] = x - SP[e] * SC[e] * inv;
      });
      forward(q, kCz2, C, T, ctab, stab);
      inverse_product(A, C, T, p, ctab, stab, [&](int e, float x) {
        const float inv = 1.0f / O[e];
        const float var_c = fmaxf(x - SC[e] * SC[e] * inv, 0.0f);
        VP[e] = sqrtf(VP[e] * var_c);
      });
      float lmax = 0.0f;
      for (int e = tid; e < p * p; e += nt) lmax = fmaxf(lmax, fabsf(VP[e]));
      const float tol = 1e3f * eps * block_reduce(lmax, redf, Max(), 0.0f);
      for (int e = tid; e < p * p; e += nt) {
        const float d = VP[e];
        const float v = d > tol ? clip1(SP[e] / d) : 0.0f;
        corr[e] = O[e] < cut ? 0.0f : v;
      }
      __syncthreads();
    }

    // 3. Peak chain on the centered [p, p] surface (flow_peaks.cuh).
    peak_chain(corr, p, p, min_y, min_x, threshold_rel, rad_y, rad_x, out,
               plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

// The pure route: one block of kFftThreads per pair at a time (a
// persistent grid over list), the pair's packed complex array and one
// axis's FFT tables in dynamic shared memory: Z [p p] | tw | root | inv |
// src (fftsm, K7's tables for p x p; both axes share them).
__global__ void __launch_bounds__(kFftThreads, 1)
masked_pure_kernel(const float* __restrict__ pre,
                   const float* __restrict__ post, int w,
                   const int* __restrict__ list, int n, int gx, int sy, int sx,
                   fftsm::Axis axis, const float2* __restrict__ tabs,
                   const int* __restrict__ idx, int subtract_mean,
                   float mean_value, float scale, int min_y, int min_x,
                   float threshold_rel, int rad_y, int rad_x, int64_t plane,
                   float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ fftsm::Axis ax;
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int p = axis.n, area = p * p;
  float2* Z = reinterpret_cast<float2*>(smem4);
  float2* tw = Z + area;
  float2* root = tw + p;
  int* inv = reinterpret_cast<int*>(root + p);
  int* src = inv + p;
  if (tid == 0) ax = axis;
  for (int e = tid; e < 2 * p; e += nt) {
    tw[e] = tabs[e];
    inv[e] = idx[e];
  }
  __syncthreads();
  const float areaf = (float)area;
  const float inv_p = __frcp_rn((float)p);
  const float eps = 1.1920928955078125e-07f;  // float32 machine epsilon
  const bool vec = (p & 3) == 0 && (w & 3) == 0 && (sx & 3) == 0 &&
                   ((uintptr_t)pre & 15) == 0 && ((uintptr_t)post & 15) == 0;

  for (int k = blockIdx.x; k < n; k += gridDim.x) {
    const int pidx = list[k];
    const int gi = pidx / gx, gj = pidx - gi * gx;
    const float* ga = pre + (int64_t)gi * sy * w + (int64_t)gj * sx;
    const float* gb = post + (int64_t)gi * sy * w + (int64_t)gj * sx;
    // 1. The two patches from the images, scattered into digit-reversed
    // order along both axes as Z = a + i b, summed on the way.
    float sa = 0.0f, sb = 0.0f;
    if (vec) {
      for (int e4 = tid; e4 < area / 4; e4 += nt) {
        const int y = fftsm::fast_div(4 * e4, p, inv_p), x = 4 * e4 - y * p;
        const int64_t o = (int64_t)y * w + x;
        const float4 a = __ldg(reinterpret_cast<const float4*>(ga + o));
        const float4 b = __ldg(reinterpret_cast<const float4*>(gb + o));
        sa += (a.x + a.y) + (a.z + a.w);
        sb += (b.x + b.y) + (b.z + b.w);
        float2* zr = Z + inv[y] * p;
        zr[inv[x]] = make_float2(a.x, b.x);
        zr[inv[x + 1]] = make_float2(a.y, b.y);
        zr[inv[x + 2]] = make_float2(a.z, b.z);
        zr[inv[x + 3]] = make_float2(a.w, b.w);
      }
    } else {
      for (int e = tid; e < area; e += nt) {
        const int y = fftsm::fast_div(e, p, inv_p), x = e - y * p;
        const int64_t o = (int64_t)y * w + x;
        const float a = __ldg(ga + o), b = __ldg(gb + o);
        sa += a;
        sb += b;
        Z[inv[y] * p + inv[x]] = make_float2(a, b);
      }
    }
    // 2. Means (a pure patch's mean over its valid pixels is its mean),
    // then the four moments of the mean-removed patches, in a fixed
    // order (the block reductions' barriers also publish Z).
    float2 mu = make_float2(mean_value, mean_value);
    if (subtract_mean) {
      sa = block_reduce(sa, redf, Add(), 0.0f);
      sb = block_reduce(sb, redf, Add(), 0.0f);
      mu = make_float2(sa / areaf, sb / areaf);
    }
    __syncthreads();
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
    for (int e = tid; e < area; e += nt) {
      const float2 z = make_float2(Z[e].x - mu.x, Z[e].y - mu.y);
      Z[e] = z;
      s1 += z.x;
      s2 += z.x * z.x;
      s3 += z.y;
      s4 += z.y * z.y;
    }
    s1 = block_reduce(s1, redf, Add(), 0.0f);
    s2 = block_reduce(s2, redf, Add(), 0.0f);
    s3 = block_reduce(s3, redf, Add(), 0.0f);
    s4 = block_reduce(s4, redf, Add(), 0.0f);
    // The overlap is p^2 at every shift and the masked sums are the
    // moments, so the NCC is an affine rescale of the plain correlation.
    const float var_p = fmaxf(s2 - s1 * s1 / areaf, 0.0f);
    const float var_c = fmaxf(s4 - s3 * s3 / areaf, 0.0f);
    const float denom = sqrtf(var_p * var_c);
    const float tol = 1e3f * eps * denom;
    const float numc = s1 * s3 / areaf;
    // 3. The circular correlation (K7's transform).
    fftsm::corr_surface(Z, ax, ax, tw, root, tw, root, scale);
    // 4. The NCC in centred layout (output (r, c) is the surface at
    // ((r - p/2) mod p, (c - p/2) mod p), read at (src[r], src[c])),
    // held in registers, then written over the first p^2 floats of Z.
    float hold[kHold];
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * nt;
      hold[u] = 0.0f;
      if (e < area) {
        const int r = fftsm::fast_div(e, p, inv_p), c = e - r * p;
        const float x = fftsm::surface_at(Z, p, src[r], src[c]);
        hold[u] = denom > tol ? clip1((x - numc) / denom) : 0.0f;
      }
    }
    __syncthreads();
    float* corr = reinterpret_cast<float*>(Z);
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * nt;
      if (e < area) corr[e] = hold[u];
    }
    __syncthreads();
    // 5. Peak chain (flow_peaks.cuh).
    peak_chain(corr, p, p, min_y, min_x, threshold_rel, rad_y, rad_x, out,
               plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of per-block working memory of the dense-DFT route: 5 half
// spectra and 3 surfaces.
int64_t masked_flow_per_block(int p) {
  return 5LL * 2 * p * (p / 2 + 1) + 3LL * p * p;
}

// Dynamic shared memory of the pure route for p x p pairs, or -1 where it
// does not serve p (its surface held in kHold registers per thread).
int64_t masked_pure_smem_bytes(int p) {
  if ((int64_t)p * p > (int64_t)kHold * kFftThreads) return -1;
  return 8LL * p * p + 24LL * p;
}

// The dense-DFT route of K5 on `stream` over the n pairs of `list`.
// `scratch` NULL keeps each block's working set in dynamic shared memory;
// otherwise it is nblocks * per_block floats of global memory. `cut` is
// the overlap below which the NCC is zeroed (0.3 p^2, rounded once to
// float on the host). out: [4, plane]. Returns cudaGetLastError().
int masked_flow_launch(const float* pre, const float* post, const float* vpre,
                       const float* vpost, int w, const int* list, int n,
                       int gx, int p, int sy, int sx, const float* ctab,
                       const float* stab, int subtract_mean, float mean_value,
                       float cut, int min_y, int min_x, float threshold_rel,
                       int rad_y, int rad_x, float* scratch, int nblocks,
                       int64_t plane, float* out, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_block = masked_flow_per_block(p);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)per_block * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        masked_flow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  masked_flow_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      pre, post, vpre, vpost, w, list, n, gx, p, sy, sx, ctab, stab,
      subtract_mean, mean_value, cut, min_y, min_x, threshold_rel,
      rad_y, rad_x, scratch, per_block, plane, out);
  return (int)cudaGetLastError();
}

// The pure route of K5 on `stream` over the n pairs of `list`. radices
// (host memory): nst, r_1..r_nst (DIF order; K7's plan of p); tabs and
// idx: K7's device tables for p x p (only the first axis's are read).
// out: [4, plane]. Returns cudaGetLastError() (or the first failing
// call's error).
int masked_pure_launch(const float* pre, const float* post, int w,
                       const int* list, int n, int gx, int p, int sy, int sx,
                       const int* radices, const float* tabs, const int* idx,
                       int subtract_mean, float mean_value, int min_y,
                       int min_x, float threshold_rel, int rad_y, int rad_x,
                       int64_t plane,
                       float* out, void* stream) {
  fftsm::Axis axis;
  const int64_t bytes = masked_pure_smem_bytes(p);
  if (bytes < 0 || !fftsm::make_axis(&axis, p, radices[0], radices + 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const size_t smem = (size_t)bytes;
  cudaError_t err = cudaFuncSetAttribute(
      masked_pure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, masked_pure_kernel, kFftThreads, smem) != cudaSuccess ||
      occ < 1)
    occ = 1;
  const int grid = (int)(n < (int64_t)sms * occ ? n : (int64_t)sms * occ);
  const float scale = (float)(0.25 / ((double)p * (double)p));
  masked_pure_kernel<<<grid, kFftThreads, smem, (cudaStream_t)stream>>>(
      pre, post, w, list, n, gx, sy, sx, axis,
      reinterpret_cast<const float2*>(tabs), idx, subtract_mean, mean_value,
      scale, min_y, min_x, threshold_rel, rad_y, rad_x, plane, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
