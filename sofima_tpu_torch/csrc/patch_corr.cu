// K6: peak statistics of the circular cross-correlation of pre-cut patch
// pairs.
//
// Replaces sofima_tpu/ops/pallas_flow.py `_corr_peaks_kernel`
// (`flow_peaks_pallas`): [n, p1, p2] pairs -> [n, 4] rows (x, y,
// sharpness, ratio), the 2d strip path's kernel. It ends in the peak chain
// of flow_peaks.cuh, shared with K1/K2/K5.
//
// The function: per pair, remove each patch's mean (or a constant), form
// irfft2(F(a) conj(F(b))) on the p1 x p2 torus, roll the zero shift to
// the centre (p1/2, p2/2), then the peak chain; NaN rows where no peak
// passes the threshold. Patches may be rectangular and of any length.
//
// Two routes, chosen per launch by the wrapper (ops/cuda_flow.py), each
// counted under its own launch counter:
//  * FFT route (patch_fft_kernel, 'patch_flow_peaks'): the pairs-in
//    sibling of K1/K2's flow_fft_kernel (flow_peaks.cu) on K7's
//    rectangular plan (corr_fft.cu, fft_smem.cuh). A persistent grid
//    walks the pairs. Each pair is read straight from the batch (16-byte
//    loads where the pair's area is a multiple of 4; a float4 may span
//    two rows) into the transform's digit-reversed order along both axes
//    as Z = a + i b, summed on the way; the means come off in shared
//    memory, and a pair with a patch that is then 0 everywhere writes its
//    NaN row directly (the plain version's surface is exactly 0 there,
//    the packed transform's is not); fftsm::corr_surface gives the
//    surface; each thread gathers its share of the centred p1 x p2
//    surface into registers (kHold values, through K7's `src` tables),
//    then writes it over the transform's buffer, where the peak chain
//    reads it. Served where the packed pair and both axes' tables fit in
//    shared memory (8 p1 p2 + 24 (p1 + p2) bytes) and p1 p2 <= kHold x
//    1024. The block has 256, 512 or 1024 threads, the fewest that keep
//    about 1024 threads on an SM (160 x 80: two blocks of 512 threads
//    and 106 KB per SM; 160^2: one of 1024 and 206 KB), more where the
//    surface needs them.
//  * Dense route (patch_corr_kernel, 'patch_flow_peaks_dft'): the first
//    port's O(p^3) DFT body, one block per pair at a time, kept for the
//    shapes the FFT route does not serve (e.g. 256^2). Its working set
//    lives in shared memory where it fits (p1 = p2 = 32: 20 KB) and
//    otherwise in a per-block slice of global scratch (a persistent grid
//    of 4 blocks per SM).
//
// What bounds it on the H100: the bytes are 8 per pixel in and 16 per
// pair out (1.888 ms for the strip path's 61 752 pairs of 160 x 80 at
// 3.35 TB/s); the FFT route's ~3 x 2.5 N log2 N flops per pair (N = p1
// p2) and its ~9 read-write sweeps of the packed pair in shared memory
// come next; the dense route does ~8 p1 p2 (p1 + p2) / 2 flops per pair.
// Reductions run in a fixed order and no atomics are used: a second call
// repeats the first bit for bit.

#include "fft_smem.cuh"
#include "flow_peaks.cuh"

namespace {

// The dense route. tab1c[j * p1 + k] = cos(2 pi jk / p1), tab1s likewise
// with sin; tab2 the same for p2.
__global__ void __launch_bounds__(kThreads)
patch_corr_kernel(const float* __restrict__ pre, const float* __restrict__ post,
                  int n, int p1, int p2, const float* __restrict__ tab1c,
                  const float* __restrict__ tab1s,
                  const float* __restrict__ tab2c,
                  const float* __restrict__ tab2s, int subtract_mean,
                  float mean_value, int min_y, int min_x, float threshold_rel,
                  int rad_y, int rad_x, float* __restrict__ scratch,
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
    peak_chain(corr, p1, p2, min_y, min_x, threshold_rel, rad_y, rad_x, out,
               (int64_t)n, pidx, redf, redi, redf2);
    __syncthreads();
  }
}


// The FFT route's register hold: p1 p2 <= kHold x threads per block.
constexpr int kHold = 25;

// The FFT route: NT threads per block, a persistent grid over the n pairs,
// dynamic shared memory Z [p1 p2] | tw1 | root1 | tw2 | root2 | inv1 |
// src1 | inv2 | src2 (K7's tables for p1 x p2; axis 1 the columns, of
// length p1, axis 2 the rows, of length p2).
template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
patch_fft_kernel(const float* __restrict__ pre, const float* __restrict__ post,
                 int n, fftsm::Axis axis1, fftsm::Axis axis2,
                 const float2* __restrict__ tabs, const int* __restrict__ idx,
                 int subtract_mean, float mean_value, float scale,
                 int min_y, int min_x, float threshold_rel, int rad_y,
                 int rad_x, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ fftsm::Axis ax[2];
  __shared__ float redf[32], redf2[32];
  __shared__ int redi[32];
  const int tid = threadIdx.x;
  const int p1 = axis1.n, p2 = axis2.n, area = p1 * p2;
  float2* Z = reinterpret_cast<float2*>(smem4);
  float2* tw1 = Z + area;
  float2* root1 = tw1 + p1;
  float2* tw2 = root1 + p1;
  float2* root2 = tw2 + p2;
  int* inv1 = reinterpret_cast<int*>(root2 + p2);
  int* src1 = inv1 + p1;
  int* inv2 = src1 + p1;
  int* src2 = inv2 + p2;
  if (tid == 0) {
    ax[0] = axis1;
    ax[1] = axis2;
  }
  for (int e = tid; e < 2 * (p1 + p2); e += NT) tw1[e] = tabs[e];
  for (int e = tid; e < 2 * p1; e += NT) inv1[e] = idx[e];
  for (int e = tid; e < 2 * p2; e += NT) inv2[e] = idx[3 * p1 + e];
  __syncthreads();
  const float areaf = (float)area;
  const float inv_p2 = __frcp_rn((float)p2);
  const bool vec = (area & 3) == 0 && ((uintptr_t)pre & 15) == 0 &&
                   ((uintptr_t)post & 15) == 0;
  const int64_t plane = (int64_t)n;

  for (int pidx = blockIdx.x; pidx < n; pidx += gridDim.x) {
    const float* ga = pre + (int64_t)pidx * area;
    const float* gb = post + (int64_t)pidx * area;
    // 1. The two patches, scattered into digit-reversed order along both
    // axes as Z = a + i b, summed on the way.
    float sa = 0.0f, sb = 0.0f;
    if (vec) {
      const float4* a4 = reinterpret_cast<const float4*>(ga);
      const float4* b4 = reinterpret_cast<const float4*>(gb);
      for (int e4 = tid; e4 < area / 4; e4 += NT) {
        const float4 a = __ldg(a4 + e4), b = __ldg(b4 + e4);
        sa += (a.x + a.y) + (a.z + a.w);
        sb += (b.x + b.y) + (b.z + b.w);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
        int y = fftsm::fast_div(4 * e4, p2, inv_p2), x = 4 * e4 - y * p2;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Z[inv1[y] * p2 + inv2[x]] = make_float2(av[c], bv[c]);
          if (++x == p2) {
            x = 0;
            ++y;
          }
        }
      }
    } else {
      for (int e = tid; e < area; e += NT) {
        const int y = fftsm::fast_div(e, p2, inv_p2), x = e - y * p2;
        const float a = __ldg(ga + e), b = __ldg(gb + e);
        sa += a;
        sb += b;
        Z[inv1[y] * p2 + inv2[x]] = make_float2(a, b);
      }
    }
    // 2. The means (or the given constant) off every pixel.
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
    // A patch that is 0 everywhere (a flat one) gives an all-zero surface,
    // which the plain version computes exactly and the peak chain turns
    // into a NaN row; the packed transform would leave rounding residue
    // there, so such a pair writes its NaN row directly.
    nz_a = __syncthreads_or(nz_a);
    nz_b = __syncthreads_or(nz_b);
    if (!nz_a || !nz_b) {
      if (tid == 0) write_row(out, plane, pidx, NAN, NAN, NAN, NAN);
      continue;
    }
    // 3. The circular correlation (K7's transform).
    fftsm::corr_surface(Z, ax[0], ax[1], tw1, root1, tw2, root2, scale);
    // 4. The centred surface: (r, c) is the surface at unshifted ((r -
    // p1/2) mod p1, (c - p2/2) mod p2), read at (src1[r], src2[c]); held
    // in registers, then written over the first p1 p2 floats of Z.
    float hold[kHold];
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * NT;
      hold[u] = 0.0f;
      if (e < area) {
        const int r = fftsm::fast_div(e, p2, inv_p2), c = e - r * p2;
        hold[u] = fftsm::surface_at(Z, p2, src1[r], src2[c]);
      }
    }
    __syncthreads();
    float* corr = reinterpret_cast<float*>(Z);
#pragma unroll
    for (int u = 0; u < kHold; ++u) {
      const int e = tid + u * NT;
      if (e < area) corr[e] = hold[u];
    }
    __syncthreads();
    // 5. Peak chain (flow_peaks.cuh) on the surface.
    peak_chain(corr, p1, p2, min_y, min_x, threshold_rel, rad_y, rad_x, out,
               plane, pidx, redf, redi, redf2);
    __syncthreads();
  }
}

// Opts the NT-thread instantiation in to `smem` bytes of dynamic shared
// memory and sets *occ to its resident blocks per SM (at least 1).
template <int NT>
int fft_occupancy(size_t smem, int* occ) {
  cudaError_t err = cudaFuncSetAttribute(
      patch_fft_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          occ, patch_fft_kernel<NT>, NT, smem) != cudaSuccess ||
      *occ < 1)
    *occ = 1;
  return 0;
}

template <int NT>
int launch_fft(const float* pre, const float* post, int n,
               const fftsm::Axis& ax1, const fftsm::Axis& ax2,
               const float* tabs, const int* idx, int subtract_mean,
               float mean_value, float scale, int min_y, int min_x,
               float threshold_rel, int rad_y, int rad_x, float* out,
               size_t smem, int sms, cudaStream_t stream) {
  int occ = 0;
  const int err = fft_occupancy<NT>(smem, &occ);
  if (err) return err;
  const int grid = n < sms * occ ? n : sms * occ;
  patch_fft_kernel<NT><<<grid, NT, smem, stream>>>(
      pre, post, n, ax1, ax2, reinterpret_cast<const float2*>(tabs), idx,
      subtract_mean, mean_value, scale, min_y, min_x, threshold_rel,
      rad_y, rad_x, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dense route's floats of per-block working memory, and the offset of
// region 1.
int64_t patch_corr_region0(int p1, int p2) {
  const int64_t h2 = p2 / 2 + 1;
  const int64_t a = 2LL * p1 * p2;
  const int64_t b = 4LL * p1 * h2 + (int64_t)p1 * p2;
  return a > b ? a : b;
}

int64_t patch_corr_per_block(int p1, int p2) {
  return patch_corr_region0(p1, p2) + 4LL * p1 * (p2 / 2 + 1);
}

// Launches K6's dense route on `stream`; out is [4, n], channel-major.
// `scratch` NULL keeps each block's working set in dynamic shared memory;
// otherwise it is nblocks * per_block floats of global memory. Returns
// cudaGetLastError().
int patch_corr_launch(const float* pre, const float* post, int n, int p1,
                      int p2, const float* tab1c, const float* tab1s,
                      const float* tab2c, const float* tab2s,
                      int subtract_mean, float mean_value, int min_y, int min_x,
                      float threshold_rel, int rad_y, int rad_x, float* scratch,
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
      mean_value, min_y, min_x, threshold_rel, rad_y, rad_x, scratch, per_block,
      region0, out);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the FFT route for p1 x p2 pairs, or -1 where it
// does not serve them (an axis over fftsm::kMaxLength, or a surface larger
// than kHold registers of 1024 threads hold).
int64_t patch_fft_smem_bytes(int p1, int p2) {
  if (p1 < 2 || p2 < 2 || p1 > fftsm::kMaxLength || p2 > fftsm::kMaxLength ||
      (int64_t)p1 * p2 > (int64_t)kHold * 1024)
    return -1;
  return 8LL * p1 * p2 + 24LL * (p1 + p2);
}

// Threads per block of the FFT route: the fewest of 256, 512 and 1024
// that keep about 1024 threads on an SM at `smem_sm` bytes of shared
// memory per SM (64 registers a thread), and enough to hold the surface.
static int patch_fft_threads(int p1, int p2, int smem_sm) {
  const int64_t bytes = patch_fft_smem_bytes(p1, p2);
  if (bytes < 0) return 0;
  // Each block also takes ~1 KB of static and 1 KB of reserved memory.
  const int64_t fit = (int64_t)smem_sm / (bytes + 2048);
  int nt = fit >= 4 ? 256 : fit >= 2 ? 512 : 1024;
  while ((int64_t)p1 * p2 > (int64_t)kHold * nt) nt *= 2;
  return nt;
}

// The FFT route's block size and resident blocks per SM on the current
// device for p1 x p2 pairs. Returns a cudaError_t.
int patch_fft_config(int p1, int p2, int* threads, int* blocks_per_sm) {
  const int64_t bytes = patch_fft_smem_bytes(p1, p2);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  *threads = patch_fft_threads(p1, p2, smem_sm);
  switch (*threads) {
    case 256: return fft_occupancy<256>((size_t)bytes, blocks_per_sm);
    case 512: return fft_occupancy<512>((size_t)bytes, blocks_per_sm);
    default: return fft_occupancy<1024>((size_t)bytes, blocks_per_sm);
  }
}

// The FFT route on `stream` over n pairs. radices (host memory): nst1,
// r_1..r_nst1, nst2, r_1..r_nst2 (DIF order, column axis first; K7's
// plans); tabs and idx: K7's device tables for p1 x p2. out: [4, n],
// channel-major. Returns cudaGetLastError() (or the first failing call's
// error).
int patch_fft_launch(const float* pre, const float* post, int n, int p1,
                     int p2, const int* radices, const float* tabs,
                     const int* idx, int subtract_mean, float mean_value,
                     int min_y, int min_x, float threshold_rel, int rad_y,
                     int rad_x,
                     float* out, void* stream) {
  fftsm::Axis ax1, ax2;
  const int64_t bytes = patch_fft_smem_bytes(p1, p2);
  const int* r2 = radices + 1 + radices[0];
  if (bytes < 0 || !fftsm::make_axis(&ax1, p1, radices[0], radices + 1) ||
      !fftsm::make_axis(&ax2, p2, r2[0], r2 + 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  int dev = 0, sms = 0, smem_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  const float scale = (float)(0.25 / ((double)p1 * (double)p2));
  const size_t smem = (size_t)bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (patch_fft_threads(p1, p2, smem_sm)) {
    case 256:
      return launch_fft<256>(pre, post, n, ax1, ax2, tabs, idx, subtract_mean,
                             mean_value, scale, min_y, min_x, threshold_rel,
                             rad_y, rad_x, out, smem, sms, s);
    case 512:
      return launch_fft<512>(pre, post, n, ax1, ax2, tabs, idx, subtract_mean,
                             mean_value, scale, min_y, min_x, threshold_rel,
                             rad_y, rad_x, out, smem, sms, s);
    default:
      return launch_fft<1024>(pre, post, n, ax1, ax2, tabs, idx,
                              subtract_mean, mean_value, scale, min_y, min_x,
                              threshold_rel, rad_y, rad_x, out, smem, sms, s);
  }
}

}  // extern "C"
