// K6: peak statistics of the circular cross-correlation of pre-cut patch
// pairs, one thread block per patch pair.
//
// Replaces sofima_tpu/ops/pallas_flow.py `_corr_peaks_kernel`
// (`flow_peaks_pallas`): [n, p1, p2] pairs -> [n, 4] rows (x, y,
// sharpness, ratio), the 2d strip path's kernel. It ends in the peak chain
// of flow_peaks.cuh, shared with K1/K2/K5. (K7, the centred surfaces, runs
// on the shared-memory FFT in corr_fft.cu; moving this body onto it is
// queued.)
//
// The function: per pair, remove each patch's mean (or a constant), form
// irfft2(F(a) conj(F(b))) on the p1 x p2 torus, roll the zero shift to
// the centre, then the peak chain. Patches may be rectangular, so the two
// axes take their own DFT tables: tab2 (length p2) for the half-spectrum
// row transforms, tab1 (length p1) for the full column transforms.
//
// What bounds it on the H100: the transforms' multiply-adds, done here as
// plain f32 FMA loops (~8 p1 p2 (p1 + p2) / 2 per pair against the FFT's
// ~7.5 p1 p2 log2(p1 p2)), out of shared memory where the working set
// fits (p1 = p2 = 32: 20 KB) and otherwise out of a per-block slice of
// global scratch, as K1 does at p = 160 (160 x 80: 261 KB per block; a
// persistent grid of 4 blocks per SM). Each pair's patches are contiguous
// in the batch, so the block reads them coalesced and writes 16 bytes per
// pair. No tensor cores: this first port is simple and exact, as K1's.

#include "flow_peaks.cuh"

namespace {

// tab1c[j * p1 + k] = cos(2 pi jk / p1), tab1s likewise with sin; tab2 the
// same for p2.
__global__ void __launch_bounds__(kThreads)
patch_corr_kernel(const float* __restrict__ pre, const float* __restrict__ post,
                  int n, int p1, int p2, const float* __restrict__ tab1c,
                  const float* __restrict__ tab1s,
                  const float* __restrict__ tab2c,
                  const float* __restrict__ tab2s, int subtract_mean,
                  float mean_value, int min_distance, float threshold_rel,
                  int peak_radius, float* __restrict__ scratch,
                  int64_t per_block, int64_t region0, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];

  const int h2 = p2 / 2 + 1;
  const int area = p1 * p2;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* base = scratch ? scratch + (int64_t)blockIdx.x * per_block : smem;
  // Region 0: the two patches, later the cross power, the column-inverse
  // spectrum and the centred surface.
  float* pa = base;
  float* pb = pa + area;
  float* cr = base;
  float* ci = cr + p1 * h2;
  float* gr = ci + p1 * h2;
  float* gi = gr + p1 * h2;
  float* corr = gi + p1 * h2;
  // Region 1: row spectra of both patches.
  float* ar = base + region0;
  float* ai = ar + p1 * h2;
  float* br = ai + p1 * h2;
  float* bi = br + p1 * h2;

  for (int pidx = blockIdx.x; pidx < n; pidx += gridDim.x) {
    const float* ga = pre + (int64_t)pidx * area;
    const float* gb = post + (int64_t)pidx * area;

    // 1. Patches and their means.
    float sa = 0.0f, sb = 0.0f;
    for (int e = tid; e < area; e += nt) {
      const float a = __ldg(ga + e), b = __ldg(gb + e);
      pa[e] = a;
      pb[e] = b;
      sa += a;
      sb += b;
    }
    float ma = mean_value, mb = mean_value;
    if (subtract_mean) {
      ma = block_reduce(sa, redf, Add(), 0.0f) / (float)area;
      mb = block_reduce(sb, redf, Add(), 0.0f) / (float)area;
    }
    __syncthreads();
    for (int e = tid; e < area; e += nt) {
      pa[e] -= ma;
      pb[e] -= mb;
    }
    __syncthreads();

    // 2. Row half-spectrum DFT: X[y, k] = sum_x x[y, x] e^{-2 pi i xk/p2}.
    for (int e = tid; e < p1 * h2; e += nt) {
      const int y = e / h2, k = e - y * h2;
      const float* ra = pa + y * p2;
      const float* rb = pb + y * p2;
      float a_r = 0.0f, a_i = 0.0f, b_r = 0.0f, b_i = 0.0f;
      for (int x = 0; x < p2; ++x) {
        const float c = __ldg(tab2c + x * p2 + k);
        const float s = __ldg(tab2s + x * p2 + k);
        const float va = ra[x], vb = rb[x];
        a_r = fmaf(va, c, a_r);
        a_i = fmaf(-va, s, a_i);
        b_r = fmaf(vb, c, b_r);
        b_i = fmaf(-vb, s, b_i);
      }
      ar[e] = a_r; ai[e] = a_i; br[e] = b_r; bi[e] = b_i;
    }
    __syncthreads();

    // 3. Column DFT of both spectra and the cross power F(a) conj(F(b)).
    for (int e = tid; e < p1 * h2; e += nt) {
      const int u = e / h2, k = e - u * h2;
      const float* cu = tab1c + u * p1;
      const float* su = tab1s + u * p1;
      float far = 0.0f, fai = 0.0f, fbr = 0.0f, fbi = 0.0f;
      for (int y = 0; y < p1; ++y) {
        const float c = __ldg(cu + y), s = __ldg(su + y);
        const int o = y * h2 + k;
        const float xr = ar[o], xi = ai[o], yr = br[o], yi = bi[o];
        far += c * xr + s * xi;
        fai += c * xi - s * xr;
        fbr += c * yr + s * yi;
        fbi += c * yi - s * yr;
      }
      cr[e] = far * fbr + fai * fbi;
      ci[e] = fai * fbr - far * fbi;
    }
    __syncthreads();

    // 4. Column inverse; output row r is unshifted row (r - p1/2) mod p1.
    for (int e = tid; e < p1 * h2; e += nt) {
      const int r = e / h2, k = e - r * h2;
      const int yr = (r - p1 / 2 + p1) % p1;
      float g_r = 0.0f, g_i = 0.0f;
      for (int u = 0; u < p1; ++u) {
        const float c = __ldg(tab1c + u * p1 + yr);
        const float s = __ldg(tab1s + u * p1 + yr);
        const int o = u * h2 + k;
        const float xr = cr[o], xi = ci[o];
        g_r += c * xr - s * xi;
        g_i += c * xi + s * xr;
      }
      gr[e] = g_r / (float)p1;
      gi[e] = g_i / (float)p1;
    }
    __syncthreads();

    // 5. Hermitian row inverse; output column c is unshifted column
    //    (c - p2/2) mod p2.
    for (int e = tid; e < area; e += nt) {
      const int r = e / p2, c = e - r * p2;
      const int xc = (c - p2 / 2 + p2) % p2;
      float acc = 0.0f;
      for (int k = 0; k < h2; ++k) {
        const float alpha = (k == 0 || 2 * k == p2) ? 1.0f : 2.0f;
        const float cs = __ldg(tab2c + k * p2 + xc);
        const float sn = __ldg(tab2s + k * p2 + xc);
        acc += gr[r * h2 + k] * (alpha * cs) - gi[r * h2 + k] * (alpha * sn);
      }
      corr[e] = acc / (float)p2;
    }
    __syncthreads();

    // 6. The peak chain on the centred surface (flow_peaks.cuh).
    peak_chain(corr, p1, p2, min_distance, threshold_rel, peak_radius, out,
               (int64_t)n, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of per-block working memory, and the offset of region 1.
int64_t patch_corr_region0(int p1, int p2) {
  const int64_t h2 = p2 / 2 + 1;
  const int64_t a = 2LL * p1 * p2;
  const int64_t b = 4LL * p1 * h2 + (int64_t)p1 * p2;
  return a > b ? a : b;
}

int64_t patch_corr_per_block(int p1, int p2) {
  return patch_corr_region0(p1, p2) + 4LL * p1 * (p2 / 2 + 1);
}

// Launches K6 on `stream`; out is [4, n], channel-major. `scratch` NULL
// keeps each block's working set in dynamic shared memory; otherwise it is
// nblocks * per_block floats of global memory. Returns cudaGetLastError().
int patch_corr_launch(const float* pre, const float* post, int n, int p1,
                      int p2, const float* tab1c, const float* tab1s,
                      const float* tab2c, const float* tab2s,
                      int subtract_mean, float mean_value, int min_distance,
                      float threshold_rel, int peak_radius, float* scratch,
                      int nblocks, float* out, void* stream) {
  const int64_t per_block = patch_corr_per_block(p1, p2);
  const int64_t region0 = patch_corr_region0(p1, p2);
  size_t smem = 0;
  auto kernel = patch_corr_kernel;
  if (scratch == nullptr) {
    smem = (size_t)per_block * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      pre, post, n, p1, p2, tab1c, tab1s, tab2c, tab2s, subtract_mean,
      mean_value, min_distance, threshold_rel, peak_radius, scratch, per_block,
      region0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
