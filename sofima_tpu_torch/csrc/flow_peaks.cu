// Dense-grid flow peaks: circular cross-correlation of patch pairs and the
// top-2 peak statistics, one thread block per patch pair.
//
// Replaces (sofima_tpu/ops/pallas_flow.py):
//   * _grid_kernel          (dense_flow_peaks_pallas, the coarse pass), and
//   * _grid_kernel_targeted (dense_flow_peaks_targeted, the fine pass),
// with _corr_peaks_grouped / _block_xdft (the DFT-as-matmul correlation)
// and _peaks_for_group (the peak chain). One entry serves both: the
// targeted pass passes a per-patch (dy, dx) post offset, the dense pass
// passes none; `crop` restricts the peak search to the centered core.
//
// What bounds it on the H100: arithmetic and on-chip bandwidth, not HBM.
// Each patch pair is p^2 pixels read twice from L2/HBM, but the four
// O(p^3) transform stages do ~8 p^3 multiply-adds per pair out of shared
// memory (or global scratch at p = 160) with DFT tables read through
// the read-only cache. The design keeps every intermediate on chip where
// it fits: at the fine pass (p = 80, crop 32) a block holds both
// patches, their row spectra, the cross power and the cropped surface in
// 104 KB of shared memory (two blocks per SM). At the coarse pass
// (p = 160, no crop) that would be 517 KB, so the same code runs on a
// per-block slice of wrapper-allocated global scratch (persistent grid
// of 4 blocks per SM: 528 x 517 KB = 273 MB live, more than 5x the 50 MB
// L2, so the coarse pass streams its intermediates through HBM; sizing
// the grid or staging rows so they fit in L2 is later work). The
// inverse transforms compute only the cropped
// rows and columns. The transforms are plain FMA loops in f32 (no tensor
// cores yet: wgmma and TMA are later work).
//
// Numerics follow the reference exactly where it matters: per-patch mean
// removal (the Pallas kernel's DC-bin zeroing is the same operation in
// exact arithmetic), the zero shift at p/2, and the peak chain of
// flow_peaks.cuh (shared with K5, masked_flow.cu).

#include "flow_peaks.cuh"

namespace {

__device__ __forceinline__ float load_zero(const float* __restrict__ img,
                                           int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w)
             ? __ldg(img + (int64_t)y * w + x) : 0.0f;
}

// ctab[j * p + k] = cos(2 pi jk / p), stab[j * p + k] = sin(2 pi jk / p).
__global__ void __launch_bounds__(kThreads)
flow_peaks_kernel(const float* __restrict__ pre, const float* __restrict__ post,
                  int h, int w, const int* __restrict__ offsets, int gy, int gx,
                  int p, int sy, int sx, const float* __restrict__ ctab,
                  const float* __restrict__ stab, int crop, int subtract_mean,
                  float mean_value, int min_distance, float threshold_rel,
                  int peak_radius, float* __restrict__ scratch,
                  int64_t per_block, int64_t region0, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];

  const int hh = p / 2 + 1;
  const int n1 = crop;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* base = scratch ? scratch + (int64_t)blockIdx.x * per_block : smem;
  // Region 0: the two patches, later reused for the cross power, the
  // column-inverse spectrum and the cropped surface.
  float* pa = base;
  float* pb = pa + p * p;
  float* cr = base;
  float* ci = cr + p * hh;
  float* gr = ci + p * hh;
  float* gi = gr + n1 * hh;
  float* corr = gi + n1 * hh;
  // Region 1: row spectra of both patches.
  float* ar = base + region0;
  float* ai = ar + p * hh;
  float* br = ai + p * hh;
  float* bi = br + p * hh;

  const int npatch = gy * gx;
  const int64_t plane = (int64_t)npatch;
  for (int pidx = blockIdx.x; pidx < npatch; pidx += gridDim.x) {
    const int gi_ = pidx / gx, gj = pidx - gi_ * gx;
    const int y0 = gi_ * sy, x0 = gj * sx;
    int qy0 = y0, qx0 = x0;
    if (offsets) {
      qy0 += offsets[2 * pidx];
      qx0 += offsets[2 * pidx + 1];
    }

    // 1. Patches (zeros outside the image) and their means.
    float sa = 0.0f, sb = 0.0f;
    for (int e = tid; e < p * p; e += nt) {
      const int yy = e / p, xx = e - yy * p;
      const float a = load_zero(pre, h, w, y0 + yy, x0 + xx);
      const float b = load_zero(post, h, w, qy0 + yy, qx0 + xx);
      pa[e] = a;
      pb[e] = b;
      sa += a;
      sb += b;
    }
    float ma = mean_value, mb = mean_value;
    if (subtract_mean) {
      ma = block_reduce(sa, redf, Add(), 0.0f) / (float)(p * p);
      mb = block_reduce(sb, redf, Add(), 0.0f) / (float)(p * p);
    }
    __syncthreads();
    for (int e = tid; e < p * p; e += nt) {
      pa[e] -= ma;
      pb[e] -= mb;
    }
    __syncthreads();

    // 2. Row half-spectrum DFT: X[y, k] = sum_x x[y, x] e^{-2 pi i xk/p}.
    for (int e = tid; e < p * hh; e += nt) {
      const int y = e / hh, k = e - y * hh;
      const float* ra = pa + y * p;
      const float* rb = pb + y * p;
      float a_r = 0.0f, a_i = 0.0f, b_r = 0.0f, b_i = 0.0f;
      for (int x = 0; x < p; ++x) {
        const float c = __ldg(ctab + x * p + k), s = __ldg(stab + x * p + k);
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
    for (int e = tid; e < p * hh; e += nt) {
      const int u = e / hh, k = e - u * hh;
      const float* cu = ctab + u * p;
      const float* su = stab + u * p;
      float far = 0.0f, fai = 0.0f, fbr = 0.0f, fbi = 0.0f;
      for (int y = 0; y < p; ++y) {
        const float c = __ldg(cu + y), s = __ldg(su + y);
        const int o = y * hh + k;
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

    // 4. Column inverse, only the cropped rows of the centered surface:
    //    output row r is unshifted row (r - crop/2) mod p.
    for (int e = tid; e < n1 * hh; e += nt) {
      const int r = e / hh, k = e - r * hh;
      const int yr = (r - n1 / 2 + p) % p;
      float g_r = 0.0f, g_i = 0.0f;
      for (int u = 0; u < p; ++u) {
        const float c = __ldg(ctab + u * p + yr), s = __ldg(stab + u * p + yr);
        const int o = u * hh + k;
        const float xr = cr[o], xi = ci[o];
        g_r += c * xr - s * xi;
        g_i += c * xi + s * xr;
      }
      gr[e] = g_r / (float)p;
      gi[e] = g_i / (float)p;
    }
    __syncthreads();

    // 5. Hermitian row inverse at the cropped columns.
    for (int e = tid; e < n1 * n1; e += nt) {
      const int r = e / n1, c = e - r * n1;
      const int xc = (c - n1 / 2 + p) % p;
      float acc = 0.0f;
      for (int k = 0; k < hh; ++k) {
        const float alpha = (k == 0 || 2 * k == p) ? 1.0f : 2.0f;
        const float cs = __ldg(ctab + k * p + xc), sn = __ldg(stab + k * p + xc);
        acc += gr[r * hh + k] * (alpha * cs) - gi[r * hh + k] * (alpha * sn);
      }
      corr[e] = acc / (float)p;
    }
    __syncthreads();

    // 6. Peak chain on the [crop, crop] surface (flow_peaks.cuh).
    peak_chain(corr, n1, n1, min_distance, threshold_rel, peak_radius, out,
               plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Floats of per-block working memory, and the offset of region 1.
int64_t flow_peaks_region0(int p, int crop) {
  const int64_t hh = p / 2 + 1;
  const int64_t a = 2LL * p * p;
  const int64_t b = 2LL * p * hh + 2LL * crop * hh + (int64_t)crop * crop;
  return a > b ? a : b;
}

int64_t flow_peaks_per_block(int p, int crop) {
  return flow_peaks_region0(p, crop) + 4LL * p * (p / 2 + 1);
}

// Launches the kernel on `stream`. `offsets` may be NULL (dense pass).
// `scratch` NULL keeps each block's working set in dynamic shared memory;
// otherwise it is nblocks * per_block floats of global memory. Returns
// cudaGetLastError().
int flow_peaks_launch(const float* pre, const float* post, int h, int w,
                      const int* offsets, int gy, int gx, int p, int sy, int sx,
                      const float* ctab, const float* stab, int crop,
                      int subtract_mean, float mean_value, int min_distance,
                      float threshold_rel, int peak_radius, float* scratch,
                      int nblocks, float* out, void* stream) {
  const int64_t per_block = flow_peaks_per_block(p, crop);
  const int64_t region0 = flow_peaks_region0(p, crop);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = (size_t)per_block * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flow_peaks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flow_peaks_kernel<<<nblocks, kThreads, smem, (cudaStream_t)stream>>>(
      pre, post, h, w, offsets, gy, gx, p, sy, sx, ctab, stab, crop,
      subtract_mean, mean_value, min_distance, threshold_rel, peak_radius,
      scratch, per_block, region0, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
