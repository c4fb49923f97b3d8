// Dense-grid flow peaks: circular cross-correlation of patch pairs and the
// top-2 peak statistics, one thread block per patch pair at a time.
//
// Replaces (sofima_tpu/ops/pallas_flow.py):
//   * _grid_kernel          (dense_flow_peaks_pallas, the coarse pass), and
//   * _grid_kernel_targeted (dense_flow_peaks_targeted, the fine pass),
// with _corr_peaks_grouped / _block_xdft (the DFT-as-matmul correlation)
// and _peaks_for_group (the peak chain). One entry serves both: the
// targeted pass passes a per-patch (dy, dx) post offset, the dense pass
// passes none; `crop` restricts the peak search to the centered core.
// The contract is flow_peaks_plain's [4, gy, gx] rows: zeros for pixels
// outside the image, each patch's mean (or a given constant) removed,
// the zero shift at p/2, the centred [crop, crop] core, NaN rows where
// there is no peak.
//
// Two routes, chosen per launch by the wrapper (ops/cuda_flow.py):
//  * FFT route (flow_fft_kernel): the pair's packed complex array and one
//    axis's FFT tables in dynamic shared memory, on the mixed-radix FFT
//    of fft_smem.cuh (K7's tables). A persistent grid walks the pairs.
//    Each pair is read straight from the images at its grid offset (the
//    post patch plus its (dy, dx)) and scattered into the transform's
//    digit-reversed order as a + i b, summed on the way; the means come
//    off in shared memory (a pair with a patch that is then 0 everywhere
//    writes the NaN row of its all-zero surface and stops there);
//    fftsm::corr_surface gives the surface; each thread gathers its share
//    of the centred [crop, crop] core into registers (kHold values), then
//    writes it over the transform's buffer, where the peak chain
//    (flow_peaks.cuh) reads it. A pair whose post patch lies wholly
//    inside the image takes unchecked loads (16-byte ones where the pre
//    patch's row and, per pair, the post patch's column are 16-byte
//    aligned); one that hangs off an edge takes checked loads that read
//    zeros there. Served where the packed array fits in shared memory
//    (8 p^2 + 24 p bytes: p <= 168) and crop^2 <= kHold x 1024. The block
//    has 256, 512 or 1024 threads, the fewest that keep about 1024
//    threads on an SM (256 at p = 80: four blocks of 53 KB per SM; 1024
//    at p = 160: one block of 204 KB), more where the core needs them.
//  * Dense route (flow_peaks_kernel): the O(p^3) DFT body of the first
//    port, kept for sizes the FFT route does not serve.
//
// What bounds them on the H100: operations, not HBM. The FFT route does
// ~3 x 2.5 N log2 N flops per pair (N = p^2) against ~8 p^3 for the
// dense route, every stage a read and a write of the packed array in
// shared memory. The dense route streams its intermediates through
// global scratch at p = 160 (517 KB per block).
//
// Numerics follow the reference where it matters: per-patch mean removal
// (the Pallas kernel's DC-bin zeroing is the same operation in exact
// arithmetic), the zero shift at p/2, and the peak chain of
// flow_peaks.cuh (shared with K5, masked_flow.cu, and K6). Reductions run
// in a fixed order and no atomics are used: a second call repeats the
// first bit for bit.

#include "fft_smem.cuh"
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
                  float mean_value, int min_y, int min_x, float threshold_rel,
                  int rad_y, int rad_x, float* __restrict__ scratch,
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
    peak_chain(corr, n1, n1, min_y, min_x, threshold_rel, rad_y, rad_x, out,
               plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

// The FFT route's register hold: crop^2 <= kHold x threads per block.
constexpr int kHold = 25;

// Four pixels of row y, columns x..x+3, of an image: one 16-byte load
// (mode 0, aligned and inside), four loads (mode 1, inside) or four
// checked loads that read 0 outside the image (mode 2).
__device__ __forceinline__ float4 load4(const float* __restrict__ img, int h,
                                        int w, int y, int x, int mode) {
  if (mode == 2)
    return make_float4(load_zero(img, h, w, y, x),
                       load_zero(img, h, w, y, x + 1),
                       load_zero(img, h, w, y, x + 2),
                       load_zero(img, h, w, y, x + 3));
  const float* q = img + (int64_t)y * w + x;
  if (mode == 0) return __ldg(reinterpret_cast<const float4*>(q));
  return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
}

// The FFT route: NT threads per block, a persistent grid over the gy x gx
// pairs, dynamic shared memory Z [p p] | tw | root | inv | src (fftsm,
// K7's tables for p x p; both axes share them).
template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
flow_fft_kernel(const float* __restrict__ pre, const float* __restrict__ post,
                int h, int w, const int* __restrict__ offsets, int gy, int gx,
                int sy, int sx, fftsm::Axis axis,
                const float2* __restrict__ tabs, const int* __restrict__ idx,
                int crop, int subtract_mean, float mean_value, float scale,
                int min_y, int min_x, float threshold_rel, int rad_y, int rad_x,
                float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ fftsm::Axis ax;
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x;
  const int p = axis.n, area = p * p, core = crop * crop;
  const int lo = p / 2 - crop / 2;  // first centred row / column of the core
  float2* Z = reinterpret_cast<float2*>(smem4);
  float2* tw = Z + area;
  float2* root = tw + p;
  int* inv = reinterpret_cast<int*>(root + p);
  int* src = inv + p;
  if (tid == 0) ax = axis;
  for (int e = tid; e < 2 * p; e += NT) {
    tw[e] = tabs[e];
    inv[e] = idx[e];
  }
  __syncthreads();
  const float areaf = (float)area;
  const float inv_p = __frcp_rn((float)p), inv_c = __frcp_rn((float)crop);
  const bool vec = (p & 3) == 0 && (w & 3) == 0 && (sx & 3) == 0 &&
                   ((uintptr_t)pre & 15) == 0 && ((uintptr_t)post & 15) == 0;
  const int npair = gy * gx;
  const int64_t plane = (int64_t)npair;

  for (int pidx = blockIdx.x; pidx < npair; pidx += gridDim.x) {
    const int gi = pidx / gx, gj = pidx - gi * gx;
    const int y0 = gi * sy, x0 = gj * sx;
    int qy0 = y0, qx0 = x0;
    if (offsets) {
      qy0 += offsets[2 * pidx];
      qx0 += offsets[2 * pidx + 1];
    }
    // The pre patch lies inside the image (the grid does); the post patch
    // may hang off an edge on the targeted pass.
    const bool inside = qy0 >= 0 && qx0 >= 0 && qy0 <= h - p && qx0 <= w - p;
    const int mode = !inside ? 2 : (vec && (qx0 & 3) == 0) ? 0 : 1;
    const float* ga = pre + (int64_t)y0 * w + x0;
    // 1. The two patches, scattered into digit-reversed order along both
    // axes as Z = a + i b, summed on the way.
    float sa = 0.0f, sb = 0.0f;
    if (vec) {
      for (int e4 = tid; e4 < area / 4; e4 += NT) {
        const int y = fftsm::fast_div(4 * e4, p, inv_p), x = 4 * e4 - y * p;
        const float4 a =
            __ldg(reinterpret_cast<const float4*>(ga + (int64_t)y * w + x));
        const float4 b = load4(post, h, w, qy0 + y, qx0 + x, mode);
        sa += (a.x + a.y) + (a.z + a.w);
        sb += (b.x + b.y) + (b.z + b.w);
        float2* zr = Z + inv[y] * p;
        zr[inv[x]] = make_float2(a.x, b.x);
        zr[inv[x + 1]] = make_float2(a.y, b.y);
        zr[inv[x + 2]] = make_float2(a.z, b.z);
        zr[inv[x + 3]] = make_float2(a.w, b.w);
      }
    } else {
      for (int e = tid; e < area; e += NT) {
        const int y = fftsm::fast_div(e, p, inv_p), x = e - y * p;
        const float a = __ldg(ga + (int64_t)y * w + x);
        const float b =
            mode == 2 ? load_zero(post, h, w, qy0 + y, qx0 + x)
                      : __ldg(post + (int64_t)(qy0 + y) * w + (qx0 + x));
        sa += a;
        sb += b;
        Z[inv[y] * p + inv[x]] = make_float2(a, b);
      }
    }
    // 2. The means (or the given constant) off every pixel, zeros outside
    // the image included, as the plain version does.
    float2 mu = make_float2(mean_value, mean_value);
    if (subtract_mean) {
      sa = block_reduce(sa, redf, Add(), 0.0f);
      sb = block_reduce(sb, redf, Add(), 0.0f);
      mu = make_float2(sa / areaf, sb / areaf);
    }
    __syncthreads();
    int nz_a = 0, nz_b = 0;
    for (int e = tid; e < area; e += NT) {
      const float2 z = make_float2(Z[e].x - mu.x, Z[e].y - mu.y);
      Z[e] = z;
      nz_a |= z.x != 0.0f;
      nz_b |= z.y != 0.0f;
    }
    // A patch that is 0 everywhere (a post patch wholly off the image, a
    // flat one) gives an all-zero surface, which the plain version
    // computes exactly and the peak chain turns into a NaN row. The
    // packed transform would leave rounding residue there (B = (Z[k] -
    // conj Z[-k]) / 2i is not exactly 0), so such a pair writes its NaN
    // row directly.
    nz_a = __syncthreads_or(nz_a);
    nz_b = __syncthreads_or(nz_b);
    if (!nz_a || !nz_b) {
      if (tid == 0) write_row(out, plane, pidx, NAN, NAN, NAN, NAN);
      continue;
    }
    // 3. The circular correlation (K7's transform).
    fftsm::corr_surface(Z, ax, ax, tw, root, tw, root, scale);
    // 4. The centred [crop, crop] core: core (r, c) is centred (lo + r,
    // lo + c), the surface at unshifted ((r - crop/2) mod p, (c - crop/2)
    // mod p), read at (src[lo + r], src[lo + c]); held in registers, then
    // written over the first crop^2 floats of Z.
    float hold[kHold];
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * NT;
      hold[u] = 0.0f;
      if (e < core) {
        const int r = fftsm::fast_div(e, crop, inv_c), c = e - r * crop;
        hold[u] = fftsm::surface_at(Z, p, src[lo + r], src[lo + c]);
      }
    }
    __syncthreads();
    float* corr = reinterpret_cast<float*>(Z);
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * NT;
      if (e < core) corr[e] = hold[u];
    }
    __syncthreads();
    // 5. Peak chain (flow_peaks.cuh) on the core.
    peak_chain(corr, crop, crop, min_y, min_x, threshold_rel, rad_y, rad_x,
               out, plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

// Opts the NT-thread instantiation in to `smem` bytes of dynamic shared
// memory and sets *occ to its resident blocks per SM (at least 1).
template <int NT>
int fft_occupancy(size_t smem, int* occ) {
  cudaError_t err = cudaFuncSetAttribute(
      flow_fft_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          occ, flow_fft_kernel<NT>, NT, smem) != cudaSuccess ||
      *occ < 1)
    *occ = 1;
  return 0;
}

template <int NT>
int launch_fft(const float* pre, const float* post, int h, int w,
               const int* offsets, int gy, int gx, int sy, int sx,
               const fftsm::Axis& axis, const float* tabs, const int* idx,
               int crop, int subtract_mean, float mean_value, float scale,
               int min_y, int min_x, float threshold_rel, int rad_y, int rad_x,
               float* out, size_t smem, int sms, cudaStream_t stream) {
  int occ = 0;
  const int err = fft_occupancy<NT>(smem, &occ);
  if (err) return err;
  const int64_t npair = (int64_t)gy * gx;
  const int grid = (int)(npair < (int64_t)sms * occ ? npair
                                                     : (int64_t)sms * occ);
  flow_fft_kernel<NT><<<grid, NT, smem, stream>>>(
      pre, post, h, w, offsets, gy, gx, sy, sx, axis,
      reinterpret_cast<const float2*>(tabs), idx, crop, subtract_mean,
      mean_value, scale, min_y, min_x, threshold_rel, rad_y, rad_x, out);
  return (int)cudaGetLastError();
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

// Launches the dense route on `stream`. `offsets` may be NULL (dense pass).
// `scratch` NULL keeps each block's working set in dynamic shared memory;
// otherwise it is nblocks * per_block floats of global memory. Returns
// cudaGetLastError().
int flow_peaks_launch(const float* pre, const float* post, int h, int w,
                      const int* offsets, int gy, int gx, int p, int sy, int sx,
                      const float* ctab, const float* stab, int crop,
                      int subtract_mean, float mean_value, int min_y, int min_x,
                      float threshold_rel, int rad_y, int rad_x, float* scratch,
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
      subtract_mean, mean_value, min_y, min_x, threshold_rel, rad_y, rad_x,
      scratch, per_block, region0, out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the FFT route for p x p pairs and a crop x crop
// core, or -1 where it does not serve them (the core held in kHold
// registers of at most 1024 threads).
int64_t flow_fft_smem_bytes(int p, int crop) {
  if (p < 2 || p > fftsm::kMaxLength || crop < 1 || crop > p ||
      (int64_t)crop * crop > (int64_t)kHold * 1024)
    return -1;
  return 8LL * p * p + 24LL * p;
}

// Threads per block of the FFT route: the fewest of 256, 512 and 1024
// that keep about 1024 threads on an SM at `smem_sm` bytes of shared
// memory per SM (64 registers a thread), and enough to hold the core.
static int flow_fft_threads(int p, int crop, int smem_sm) {
  const int64_t bytes = flow_fft_smem_bytes(p, crop);
  if (bytes < 0) return 0;
  // Each block also takes ~1 KB of static and 1 KB of reserved memory.
  const int64_t fit = (int64_t)smem_sm / (bytes + 2048);
  int nt = fit >= 4 ? 256 : fit >= 2 ? 512 : 1024;
  while ((int64_t)crop * crop > (int64_t)kHold * nt) nt *= 2;
  return nt;
}

// The FFT route's block size and resident blocks per SM on the current
// device for p x p pairs and a crop x crop core. Returns a cudaError_t.
int flow_fft_config(int p, int crop, int* threads, int* blocks_per_sm) {
  const int64_t bytes = flow_fft_smem_bytes(p, crop);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  *threads = flow_fft_threads(p, crop, smem_sm);
  switch (*threads) {
    case 256: return fft_occupancy<256>((size_t)bytes, blocks_per_sm);
    case 512: return fft_occupancy<512>((size_t)bytes, blocks_per_sm);
    default: return fft_occupancy<1024>((size_t)bytes, blocks_per_sm);
  }
}

// The FFT route on `stream` over the gy x gx pairs. radices (host
// memory): nst, r_1..r_nst (DIF order; K7's plan of p); tabs and idx:
// K7's device tables for p x p (only the first axis's are read).
// `offsets` may be NULL (dense pass). out: [4, gy, gx]. Returns
// cudaGetLastError() (or the first failing call's error).
int flow_fft_launch(const float* pre, const float* post, int h, int w,
                    const int* offsets, int gy, int gx, int p, int sy, int sx,
                    const int* radices, const float* tabs, const int* idx,
                    int crop, int subtract_mean, float mean_value,
                    int min_y, int min_x, float threshold_rel, int rad_y,
                    int rad_x, float* out, void* stream) {
  fftsm::Axis axis;
  const int64_t bytes = flow_fft_smem_bytes(p, crop);
  if (bytes < 0 || !fftsm::make_axis(&axis, p, radices[0], radices + 1))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)gy * gx <= 0) return 0;
  int dev = 0, sms = 0, smem_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const float scale = (float)(0.25 / ((double)p * (double)p));
  const size_t smem = (size_t)bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (flow_fft_threads(p, crop, smem_sm)) {
    case 256:
      return launch_fft<256>(pre, post, h, w, offsets, gy, gx, sy, sx, axis,
                             tabs, idx, crop, subtract_mean, mean_value, scale,
                             min_y, min_x, threshold_rel, rad_y, rad_x, out,
                             smem, sms, s);
    case 512:
      return launch_fft<512>(pre, post, h, w, offsets, gy, gx, sy, sx, axis,
                             tabs, idx, crop, subtract_mean, mean_value, scale,
                             min_y, min_x, threshold_rel, rad_y, rad_x, out,
                             smem, sms, s);
    default:
      return launch_fft<1024>(pre, post, h, w, offsets, gy, gx, sy, sx, axis,
                              tabs, idx, crop, subtract_mean, mean_value,
                              scale, min_y, min_x, threshold_rel, rad_y, rad_x,
                              out, smem, sms, s);
  }
}

}  // extern "C"
