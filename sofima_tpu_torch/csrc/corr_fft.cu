// K7: centred circular cross-correlation surfaces of pre-cut patch pairs on
// the shared-memory FFT of fft_smem.cuh.
//
// Replaces sofima_tpu/ops/pallas_flow.py `_corr_kernel` (entry
// `corr_patches_pallas`): [n, p1, p2] float32 pairs -> [n, p1, p2]
// surfaces irfft2(F(a') conj(F(b'))) on the p1 x p2 torus, a' and b' with
// each patch's mean (or a constant) removed, the zero shift rolled to
// (p1/2, p2/2). Any p1, p2 <= 2048, rectangular and odd included.
//
// What bounds it on the H100: the bytes are 12 per pixel (two patches in,
// one surface out: 0.68 ms for chip_smoke's 7 410 pairs of 160^2); the
// transforms' shared-memory traffic comes next (~9 read-write sweeps of
// the 200 KB pair, at 128 B per clock per SM). Two routes, one wrapper:
//  * shared memory (8 p1 p2 + 24 (p1 + p2) bytes <= 226 KB, e.g. 160^2):
//    a persistent grid, one pair per block at a time, its whole working
//    set in shared memory. The pair is read once with 16-byte loads,
//    scattered into digit-reversed order and summed on the way (the
//    means come off in a shared-memory pass), transformed (fft_smem.cuh
//    `corr_surface`) and written with 16-byte stores through the store's
//    index tables, which also fold in the centring roll (src[c] =
//    inv[(c - p/2) mod p]). With one block per SM the memory phases do
//    not overlap the transforms' ~9 shared-memory sweeps;
//  * global scratch (larger patches, e.g. 256^2): three launches through
//    an [n, p1, p2] complex buffer: forward row FFTs in chunks of rows;
//    the column pass, each block on a group of half-spectrum columns k
//    and their mirrors -k (copies, so the cross power reads them freely),
//    forward, cross power and inverse; then the packed row inverse and
//    the store.
// No atomics: a second launch repeats the first bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

using fftsm::Axis;

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
// Shared-memory budget per block of the global-scratch route (a 2048-long
// column group of one column pair needs 72 KB).
constexpr int kChunkBytes = 96 * 1024;

struct Plan {
  Axis ax[2];  // 0: columns (length p1), 1: rows (length p2)
};

// Sums of a and b over the block; every thread gets them, in a fixed order.
__device__ float2 block_sum2(float a, float b, float2* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = make_float2(a, b);
  __syncthreads();
  float2 v = lane < (int)(blockDim.x >> 5) ? red[lane] : make_float2(0.f, 0.f);
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, o);
    v.y += __shfl_xor_sync(kFull, v.y, o);
  }
  return v;
}

// The pair's means, or the constant.
__device__ float2 pair_means(const float* ga, const float* gb, int area,
                             bool vec, int subtract_mean, float mean_value,
                             float2* red) {
  if (!subtract_mean) return make_float2(mean_value, mean_value);
  float sa = 0.0f, sb = 0.0f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(ga);
    const float4* b4 = reinterpret_cast<const float4*>(gb);
    for (int e = threadIdx.x; e < area / 4; e += blockDim.x) {
      const float4 a = __ldg(a4 + e), b = __ldg(b4 + e);
      sa += (a.x + a.y) + (a.z + a.w);
      sb += (b.x + b.y) + (b.z + b.w);
    }
  } else {
    for (int e = threadIdx.x; e < area; e += blockDim.x) {
      sa += __ldg(ga + e);
      sb += __ldg(gb + e);
    }
  }
  const float2 s = block_sum2(sa, sb, red);
  return make_float2(s.x / (float)area, s.y / (float)area);
}

// Copies an axis's twiddles and roots (each padded to n) into shared memory.
__device__ void copy_tables(float2* dst, const float2* __restrict__ src,
                            int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}
__device__ void copy_ints(int* dst, const int* __restrict__ src, int count) {
  for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// tabs: tw1 | root1 | tw2 | root2 (float2, each padded to its axis length);
// idx: inv1 | src1 | outpos1 | inv2 | src2 | outpos2 (int, one per index).
// Shared memory: Z [p1 p2] | tw1 | root1 | tw2 | root2 | inv1 | src1 |
// inv2 | src2.
__global__ void __launch_bounds__(kThreads, 1)
corr_fft_smem_kernel(const float* __restrict__ pre,
                     const float* __restrict__ post, int n, Plan plan,
                     const float2* __restrict__ tabs,
                     const int* __restrict__ idx, int subtract_mean,
                     float mean_value, float scale, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ Axis ax[2];
  __shared__ float2 red[32];
  if (threadIdx.x == 0) {
    ax[0] = plan.ax[0];
    ax[1] = plan.ax[1];
  }
  const int p1 = plan.ax[0].n, p2 = plan.ax[1].n, area = p1 * p2;
  float2* Z = reinterpret_cast<float2*>(smem4);
  float2* tw1 = Z + area;
  float2* root1 = tw1 + p1;
  float2* tw2 = root1 + p1;
  float2* root2 = tw2 + p2;
  int* inv1 = reinterpret_cast<int*>(root2 + p2);
  int* src1 = inv1 + p1;
  int* inv2 = src1 + p1;
  int* src2 = inv2 + p2;
  copy_tables(tw1, tabs, 2 * (p1 + p2));
  copy_ints(inv1, idx, 2 * p1);
  copy_ints(inv2, idx + 3 * p1, 2 * p2);
  __syncthreads();

  const bool vec = (area & 3) == 0 && ((uintptr_t)pre & 15) == 0 &&
                   ((uintptr_t)post & 15) == 0 && ((uintptr_t)out & 15) == 0;
  for (int pair = blockIdx.x; pair < n; pair += gridDim.x) {
    const float* ga = pre + (int64_t)pair * area;
    const float* gb = post + (int64_t)pair * area;
    // Load, scattered into digit-reversed order along both axes, summing
    // the patches as it goes; then the means come off in place.
    float sa = 0.0f, sb = 0.0f;
    if (vec) {
      const float4* a4 = reinterpret_cast<const float4*>(ga);
      const float4* b4 = reinterpret_cast<const float4*>(gb);
      for (int e4 = threadIdx.x; e4 < area / 4; e4 += blockDim.x) {
        const float4 a = __ldg(a4 + e4), b = __ldg(b4 + e4);
        sa += (a.x + a.y) + (a.z + a.w);
        sb += (b.x + b.y) + (b.z + b.w);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
        int y = (4 * e4) / p2, x = 4 * e4 - y * p2;
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
      for (int e = threadIdx.x; e < area; e += blockDim.x) {
        const int y = e / p2, x = e - y * p2;
        const float a = __ldg(ga + e), b = __ldg(gb + e);
        sa += a;
        sb += b;
        Z[inv1[y] * p2 + inv2[x]] = make_float2(a, b);
      }
    }
    float2 mu = make_float2(mean_value, mean_value);
    if (subtract_mean) {
      const float2 s = block_sum2(sa, sb, red);
      mu = make_float2(s.x / (float)area, s.y / (float)area);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < area; e += blockDim.x)
      Z[e] = make_float2(Z[e].x - mu.x, Z[e].y - mu.y);
    __syncthreads();
    fftsm::corr_surface(Z, ax[0], ax[1], tw1, root1, tw2, root2, scale);
    // Store: output (r, c) is the surface at unshifted ((r - p1/2) mod p1,
    // (c - p2/2) mod p2), read at positions (src1[r], src2[c]).
    float* go = out + (int64_t)pair * area;
    if (vec) {
      float4* o4 = reinterpret_cast<float4*>(go);
      for (int e4 = threadIdx.x; e4 < area / 4; e4 += blockDim.x) {
        float v[4];
        int y = (4 * e4) / p2, x = 4 * e4 - y * p2;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = fftsm::surface_at(Z, p2, src1[y], src2[x]);
          if (++x == p2) {
            x = 0;
            ++y;
          }
        }
        o4[e4] = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int e = threadIdx.x; e < area; e += blockDim.x) {
        const int y = e / p2, x = e - y * p2;
        go[e] = fftsm::surface_at(Z, p2, src1[y], src2[x]);
      }
    }
    __syncthreads();
  }
}

// Global-scratch route, launch 1: forward row FFTs of a' + i b', `rows`
// rows at a time, into G (natural order). Shared memory: Z [rows p2] |
// tw2 | root2 | inv2.
__global__ void __launch_bounds__(kThreads, 1)
corr_fft_rows_kernel(const float* __restrict__ pre,
                     const float* __restrict__ post, int n, Plan plan,
                     const float2* __restrict__ tabs,
                     const int* __restrict__ idx, int subtract_mean,
                     float mean_value, int rows, float2* __restrict__ G) {
  extern __shared__ float4 smem4[];
  __shared__ Axis ax;
  __shared__ float2 red[32];
  if (threadIdx.x == 0) ax = plan.ax[1];
  const int p1 = plan.ax[0].n, p2 = plan.ax[1].n, area = p1 * p2;
  float2* Z = reinterpret_cast<float2*>(smem4);
  float2* tw2 = Z + rows * p2;
  float2* root2 = tw2 + p2;
  int* inv2 = reinterpret_cast<int*>(root2 + p2);
  copy_tables(tw2, tabs + 2 * p1, 2 * p2);
  copy_ints(inv2, idx + 3 * p1, p2);
  __syncthreads();
  const bool vec = (area & 3) == 0 && ((uintptr_t)pre & 15) == 0 &&
                   ((uintptr_t)post & 15) == 0;
  for (int pair = blockIdx.x; pair < n; pair += gridDim.x) {
    const float* ga = pre + (int64_t)pair * area;
    const float* gb = post + (int64_t)pair * area;
    const float2 mu = pair_means(ga, gb, area, vec, subtract_mean, mean_value,
                                 red);
    float2* gp = G + (int64_t)pair * area;
    for (int y0 = 0; y0 < p1; y0 += rows) {
      const int nr = min(rows, p1 - y0);
      for (int e = threadIdx.x; e < nr * p2; e += blockDim.x) {
        const int yy = e / p2, x = e - yy * p2;
        const int g = (y0 + yy) * p2 + x;
        Z[yy * p2 + inv2[x]] =
            make_float2(__ldg(ga + g) - mu.x, __ldg(gb + g) - mu.y);
      }
      __syncthreads();
      fftsm::fft_pass<true, false>(Z, nr, 1, p2, ax, tw2, root2);
      for (int e = threadIdx.x; e < nr * p2; e += blockDim.x)
        gp[y0 * p2 + e] = Z[e];
      __syncthreads();
    }
  }
}

// Launch 2: per (pair, group of K half-spectrum columns k0..k0+K-1), the
// columns and their mirrors -k as 2K columns (row stride 2K, rows loaded
// into digit-reversed positions), forward column FFTs, the cross power
// into the first K, their inverse; G row q then holds unshifted row
// rev1(q). Shared memory: Zc [p1 2K] | tw1 | root1 | inv1.
__global__ void __launch_bounds__(kThreads, 1)
corr_fft_cols_kernel(int n, Plan plan, const float2* __restrict__ tabs,
                     const int* __restrict__ idx, float scale, int K,
                     float2* __restrict__ G) {
  extern __shared__ float4 smem4[];
  __shared__ Axis ax;
  if (threadIdx.x == 0) ax = plan.ax[0];
  const int p1 = plan.ax[0].n, p2 = plan.ax[1].n, area = p1 * p2;
  const int h2 = p2 / 2 + 1, w = 2 * K;
  float2* Zc = reinterpret_cast<float2*>(smem4);
  float2* tw1 = Zc + p1 * w;
  float2* root1 = tw1 + p1;
  int* inv1 = reinterpret_cast<int*>(root1 + p1);
  copy_tables(tw1, tabs, 2 * p1);
  copy_ints(inv1, idx, p1);
  __syncthreads();
  const int ngroups = (h2 + K - 1) / K;
  for (int wk = blockIdx.x; wk < n * ngroups; wk += gridDim.x) {
    const int pair = wk / ngroups, k0 = (wk - pair * ngroups) * K;
    float2* gp = G + (int64_t)pair * area;
    for (int e = threadIdx.x; e < p1 * w; e += blockDim.x) {
      const int y = e / w, c2 = e - y * w;
      const int k = k0 + (c2 < K ? c2 : c2 - K);
      float2 v = make_float2(0.0f, 0.0f);
      if (k < h2) {
        const int col = c2 < K ? k : (k ? p2 - k : 0);
        v = gp[y * p2 + col];
      }
      Zc[inv1[y] * w + c2] = v;
    }
    __syncthreads();
    fftsm::fft_pass<true, false>(Zc, w, w, 1, ax, tw1, root1);
    for (int e = threadIdx.x; e < p1 * K; e += blockDim.x) {
      const int u = e / K, c = e - u * K;
      const int um = u ? p1 - u : 0;
      Zc[u * w + c] = fftsm::cross_power(Zc[u * w + c], Zc[um * w + K + c],
                                         scale);
    }
    __syncthreads();
    fftsm::fft_pass<false, true>(Zc, K, w, 1, ax, tw1, root1);
    for (int e = threadIdx.x; e < p1 * K; e += blockDim.x) {
      const int q = e / K, c = e - q * K;
      if (k0 + c < h2) gp[q * p2 + k0 + c] = Zc[q * w + c];
    }
    __syncthreads();
  }
}

// Launch 3: per (pair, group of J row pairs), the packed rows (positions
// 2j, 2j + 1), their inverse FFTs, and the store: position P's row is
// output row outpos1[P], column c reads position src2[c]. Shared memory:
// Y [J p2] | tw2 | root2 | src2 | outpos1.
__global__ void __launch_bounds__(kThreads, 1)
corr_fft_out_kernel(int n, Plan plan, const float2* __restrict__ tabs,
                    const int* __restrict__ idx, int J,
                    const float2* __restrict__ G, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  __shared__ Axis ax;
  if (threadIdx.x == 0) ax = plan.ax[1];
  const int p1 = plan.ax[0].n, p2 = plan.ax[1].n, area = p1 * p2;
  const int h2 = p2 / 2 + 1, npair = (p1 + 1) / 2;
  float2* Y = reinterpret_cast<float2*>(smem4);
  float2* tw2 = Y + J * p2;
  float2* root2 = tw2 + p2;
  int* src2 = reinterpret_cast<int*>(root2 + p2);
  int* outpos1 = src2 + p2;
  copy_tables(tw2, tabs + 2 * p1, 2 * p2);
  copy_ints(src2, idx + 3 * p1 + p2, p2);
  copy_ints(outpos1, idx + 2 * p1, p1);
  __syncthreads();
  const int ngroups = (npair + J - 1) / J;
  for (int wk = blockIdx.x; wk < n * ngroups; wk += gridDim.x) {
    const int pair = wk / ngroups, j0 = (wk - pair * ngroups) * J;
    const int nj = min(J, npair - j0);
    const float2* gp = G + (int64_t)pair * area;
    for (int e = threadIdx.x; e < nj * h2; e += blockDim.x) {
      const int jj = e / h2, k = e - jj * h2;
      const int P = 2 * (j0 + jj);
      const float2 h1 = gp[P * p2 + k];
      const float2 hb = P + 1 < p1 ? gp[(P + 1) * p2 + k]
                                   : make_float2(0.0f, 0.0f);
      const bool sc = k == 0 || 2 * k == p2;
      float2 yk, ymk;
      fftsm::pack_pair(h1, hb, sc, yk, ymk);
      Y[jj * p2 + k] = yk;
      if (!sc) Y[jj * p2 + p2 - k] = ymk;
    }
    __syncthreads();
    fftsm::fft_pass<false, true>(Y, nj, 1, p2, ax, tw2, root2);
    float* go = out + (int64_t)pair * area;
    for (int e = threadIdx.x; e < nj * 2 * p2; e += blockDim.x) {
      const int jj = e / (2 * p2), rem = e - jj * 2 * p2;
      const int half = rem / p2, c = rem - half * p2;
      const int P = 2 * (j0 + jj) + half;
      if (P < p1) {
        const float2 v = Y[jj * p2 + src2[c]];
        go[outpos1[P] * p2 + c] = half ? v.y : v.x;
      }
    }
    __syncthreads();
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks for `work` items: at most as many as fit on the card at once.
int grid_for(const void* kernel, size_t smem, int work, int sms) {
  int occ = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads,
                                                    smem) != cudaSuccess ||
      occ < 1)
    occ = 1;
  const long long g = (long long)sms * occ;
  return (int)(work < g ? work : g);
}

}  // namespace

extern "C" {

// Dynamic shared memory of the single-launch route for p1 x p2 pairs.
int64_t corr_fft_smem_bytes(int p1, int p2) {
  return 8LL * p1 * p2 + 24LL * (p1 + p2);
}

// K7 on `stream`. radices (host memory): nst1, r_1..r_nst1, nst2, r_1..
// r_nst2 (DIF order, column axis first); tabs and idx: device tables (see
// corr_fft_smem_kernel). scratch NULL: the shared-memory route; otherwise
// n p1 p2 float2 of global memory for the three-launch route. Returns
// cudaGetLastError() (or the first failing call's error).
int corr_fft_launch(const float* pre, const float* post, int n, int p1,
                    int p2, const int* radices, const float* tabs,
                    const int* idx, int subtract_mean, float mean_value,
                    float* scratch, float* out, void* stream) {
  Plan plan;
  if (!fftsm::make_axis(&plan.ax[0], p1, radices[0], radices + 1))
    return (int)cudaErrorInvalidValue;
  const int* r2 = radices + 1 + radices[0];
  if (!fftsm::make_axis(&plan.ax[1], p2, r2[0], r2 + 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const float scale = (float)(0.25 / ((double)p1 * (double)p2));
  const float2* tw = reinterpret_cast<const float2*>(tabs);
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int err;
  if (scratch == nullptr) {
    const size_t smem = (size_t)corr_fft_smem_bytes(p1, p2);
    if ((err = set_smem((const void*)corr_fft_smem_kernel, smem))) return err;
    const int grid = grid_for((const void*)corr_fft_smem_kernel, smem, n, sms);
    corr_fft_smem_kernel<<<grid, kThreads, smem, st>>>(
        pre, post, n, plan, tw, idx, subtract_mean, mean_value, scale, out);
    return (int)cudaGetLastError();
  }
  float2* G = reinterpret_cast<float2*>(scratch);
  const int h2 = p2 / 2 + 1, npair = (p1 + 1) / 2;
  // Launch 1: rows per chunk.
  int rows = (kChunkBytes - 20 * p2) / (8 * p2);
  rows = rows < 1 ? 1 : (rows > p1 ? p1 : rows);
  size_t smem = (size_t)8 * rows * p2 + 20 * (size_t)p2;
  if ((err = set_smem((const void*)corr_fft_rows_kernel, smem))) return err;
  corr_fft_rows_kernel<<<grid_for((const void*)corr_fft_rows_kernel, smem, n,
                                  sms),
                         kThreads, smem, st>>>(pre, post, n, plan, tw, idx,
                                               subtract_mean, mean_value,
                                               rows, G);
  if ((err = (int)cudaGetLastError())) return err;
  // Launch 2: K column pairs per block.
  int K = (kChunkBytes - 20 * p1) / (16 * p1);
  K = K < 1 ? 1 : (K > h2 ? h2 : K);
  smem = (size_t)16 * K * p1 + 20 * (size_t)p1;
  if ((err = set_smem((const void*)corr_fft_cols_kernel, smem))) return err;
  const int work2 = n * ((h2 + K - 1) / K);
  corr_fft_cols_kernel<<<grid_for((const void*)corr_fft_cols_kernel, smem,
                                  work2, sms),
                         kThreads, smem, st>>>(n, plan, tw, idx, scale, K, G);
  if ((err = (int)cudaGetLastError())) return err;
  // Launch 3: J row pairs per block.
  int J = (kChunkBytes - 20 * p2 - 4 * p1) / (8 * p2);
  J = J < 1 ? 1 : (J > npair ? npair : J);
  smem = (size_t)8 * J * p2 + 20 * (size_t)p2 + 4 * (size_t)p1;
  if ((err = set_smem((const void*)corr_fft_out_kernel, smem))) return err;
  const int work3 = n * ((npair + J - 1) / J);
  corr_fft_out_kernel<<<grid_for((const void*)corr_fft_out_kernel, smem,
                                 work3, sms),
                        kThreads, smem, st>>>(n, plan, tw, idx, J, G, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
