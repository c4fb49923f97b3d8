// K5: dense-grid masked flow peaks. Circular Padfield NCC of every patch
// pair under its valid-pixel masks, then the top-2 peak statistics; one
// thread block per patch pair.
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
// Each block classifies its own pair from exact valid-pixel counts:
//   * dead   (either patch without a valid pixel): a NaN row, no transforms;
//   * pure   (both fully valid): K1's cross power with the closed-form
//            normalisation from the four patch moments (3 transforms);
//   * impure: the six forward half spectra (pz, cz, va, vb, pz^2, cz^2) and
//            six inverse surfaces (12 transforms).
// The tolerance is per patch, tol = 1e3 eps max|denom| over the patch's
// own surface (a constant denom for a pure pair). The reference shares it
// per TPU subgroup (grid kernel) or per dispatch batch (strip path); the
// three rules part only where a near-flat patch sits beside a textured
// one, and only the per-patch rule is independent of batching and layout.
// Means: with `subtract_mean`, each patch's mean over its valid pixels.
//
// What bounds it on the H100: operations. An impure pair costs 12 real 2d
// DFTs of O(p^3) multiply-adds each (plain FMA loops, f32, no tensor cores
// yet); the four p^2 input planes are read from L2/HBM a few times each.
// Memory: a half spectrum S = 2 p (p/2 + 1) floats, a surface P = p^2.
// The impure chain is sequenced so that at most 5 S + 3 P floats are live:
// the mask spectra first, then one spectrum, one product and one inverse
// at a time, each inverse's epilogue folding its surface into the ones
// the numerator and denominators still need (products are formed on the
// fly inside the column inverse). At p = 80 (the fine masked pass) that
// is 208 KB of shared memory, one block per SM. At p = 160 (the coarse
// masked pass, bench.py's dense masked grid) it is 826 KB, so each block
// of a persistent grid (4 per SM) works on its own slice of global
// scratch: 528 x 826 KB = 436 MB live, 9x the 50 MB L2, so that pass
// streams its intermediates through HBM. Reductions run in a fixed order:
// a second launch repeats the first bit for bit.

#include "flow_peaks.cuh"

namespace {

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

// ctab[j * p + k] = cos(2 pi jk / p), stab[j * p + k] = sin(2 pi jk / p).
__global__ void __launch_bounds__(kThreads)
masked_flow_kernel(const float* __restrict__ pre,
                   const float* __restrict__ post,
                   const float* __restrict__ vpre,
                   const float* __restrict__ vpost, int w, int gy, int gx,
                   int p, int sy, int sx, const float* __restrict__ ctab,
                   const float* __restrict__ stab, int subtract_mean,
                   float mean_value, float cut, int min_distance,
                   float threshold_rel, int peak_radius,
                   float* __restrict__ scratch, int64_t per_block,
                   float* __restrict__ out) {
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

  const int npatch = gy * gx;
  const int64_t plane = (int64_t)npatch;
  for (int pidx = blockIdx.x; pidx < npatch; pidx += gridDim.x) {
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
      // 2a. Pure: the overlap is p^2 at every shift and the masked sums
      // are the patch moments, so the NCC is an affine rescale of the
      // plain cross-correlation.
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
    peak_chain(corr, p, p, min_distance, threshold_rel, peak_radius, out, plane,
               pidx, redf, redi, redf2);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of per-block working memory: 5 half spectra and 3 surfaces.
int64_t masked_flow_per_block(int p) {
  return 5LL * 2 * p * (p / 2 + 1) + 3LL * p * p;
}

// Launches K5 on `stream`. `scratch` NULL keeps each block's working set
// in dynamic shared memory; otherwise it is nblocks * per_block floats of
// global memory. `cut` is the overlap below which the NCC is zeroed
// (0.3 p^2, rounded once to float on the host). Returns cudaGetLastError().
int masked_flow_launch(const float* pre, const float* post, const float* vpre,
                       const float* vpost, int w, int gy, int gx, int p,
                       int sy, int sx, const float* ctab, const float* stab,
                       int subtract_mean, float mean_value, float cut,
                       int min_distance, float threshold_rel, int peak_radius,
                       float* scratch, int nblocks, float* out, void* stream) {
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
      pre, post, vpre, vpost, w, gy, gx, p, sy, sx, ctab, stab,
      subtract_mean, mean_value, cut, min_distance, threshold_rel,
      peak_radius, scratch, per_block, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
