// 2d spring-mesh force (K8): every node's 8-neighbour in-plane Hookean
// force, any batch of meshes, as a row-streaming stencil.
//
// Replaces sofima_tpu/ops/pallas_mesh.py `inplane_force_pallas` (body
// `_kernel` with `_force_tile`); its arithmetic and NaN rule are those of
// the function on the port's path, mesh.inplane_force (the XLA stencil):
// see mesh2d.cuh.
//
// What bounds it on the H100: memory traffic. Each node must read its 2
// positions and write its 2 forces, 16 B, so bench.py's 2048^2 mesh
// moves 67 MB, 20 us at 3.35 TB/s; the arithmetic (8 links x ~15 flops
// per node) is 7.5 us at 67 TFLOP/s, but it takes issue slots that the
// loads and stores need too. The TPU kernel DMAs an (8, 128)-aligned halo
// window into VMEM per grid step. Here:
//  * a 2d launch: x tiles of kTile nodes on gridDim.x, bands of rows on
//    gridDim.y, the batch on gridDim.z; int32 offsets inside a mesh and
//    no per-node division;
//  * each thread owns kV consecutive nodes of a row and walks down its
//    band, reading each row once with one 16-byte load per channel
//    (nx a multiple of 4 and aligned pointers; checked scalar loads
//    otherwise), issued two rows ahead; the x halos come from the
//    neighbouring lanes (__shfl_up / __shfl_down, one row ahead, on
//    loads that have arrived), and a warp's two edge lanes load theirs;
//  * each link is evaluated once: a row's E links serve both of their
//    nodes, and its S, SE and SW links (to the next row) are kept in
//    registers for the next row, which takes them negated (a link seen
//    from its other end gives exactly the negated force), so ~4.75 link
//    evaluations a node instead of 8;
//  * each node sums its 8 links in force2d_node's (ey, ex) order, as the
//    per-node evaluation does.
// No atomics: a second launch repeats the first bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh2d.cuh"  // Springs2d
#include "mesh3d.cuh"  // sign0, finite_or_zero

namespace {

constexpr int kV = 4;            // nodes per thread along x (one float4)
using Vec = float4;
constexpr int kThreads = 128;    // threads per block
constexpr int kTile = kV * kThreads;  // nodes per x tile
constexpr int kMinBand = 4;      // fewest rows per band
constexpr unsigned kFull = 0xffffffffu;

// A row of one channel as loaded: the thread's kV columns x0 .. x0 + kV
// - 1 (NaN outside the mesh) and, on a warp's edge lanes, the halo column
// there (x0 - 1 on lane 0, x0 + kV on lane 31).
struct Raw {
  Vec own;
  float edge;
};

// A thread's view of one row, one channel: columns x0 - 1 .. x0 + kV.
struct Row {
  float c[kV + 2];
};

// Issues the loads of row `y` of channel `p`; nothing waits for them here.
template <bool kVec>
__device__ __forceinline__ Raw load_raw(const float* __restrict__ p, int nx,
                                        int y, int x0, int lane) {
  const float* q = p + y * nx;
  Raw r;
  float* f = reinterpret_cast<float*>(&r.own);
  if (kVec && x0 < nx) {
    r.own = __ldg(reinterpret_cast<const Vec*>(q + x0));
  } else {
#pragma unroll
    for (int j = 0; j < kV; ++j) f[j] = x0 + j < nx ? __ldg(q + x0 + j) : NAN;
  }
  const int e = lane == 0 ? x0 - 1 : x0 + kV;
  r.edge = e >= 0 && e < nx && (lane == 0 || lane == 31) ? __ldg(q + e) : NAN;
  return r;
}

// The row's view: its own columns, the halos from the neighbouring lanes
// (__shfl_up / __shfl_down) or, on a warp's edge, from the loaded edge.
// Every lane of the warp must call it.
__device__ __forceinline__ Row view(const Raw& r, int lane) {
  Row v;
  const float* f = reinterpret_cast<const float*>(&r.own);
#pragma unroll
  for (int j = 0; j < kV; ++j) v.c[j + 1] = f[j];
  const float left = __shfl_up_sync(kFull, v.c[kV], 1);
  const float right = __shfl_down_sync(kFull, v.c[1], 1);
  v.c[0] = lane == 0 ? r.edge : left;
  v.c[kV + 1] = lane == 31 ? r.edge : right;
  return v;
}

// The force on the node at (row a, column i) of the thread's view from its
// link to (row b, column k), offset (ex, ey), rest vector (l0x, l0y) of
// length l0 (mesh2d.cuh), each component through nan_to_num(posinf=0,
// neginf=0) as mesh.inplane_force maps it. The same link seen from its
// other end (-d, offset -e) gives exactly the negated force.
__device__ __forceinline__ float2 link(const Row& a0, const Row& a1, int i,
                                       const Row& b0, const Row& b1, int k,
                                       int ex, int ey, float l0x, float l0y,
                                       float l0, float k_eff, bool prefer) {
  const float d0 = b0.c[k] - a0.c[i] + l0x;
  const float d1 = b1.c[k] - a1.c[i] + l0y;
  // 1/|d| as rsqrt: inf at d = 0 and 0 at |d| = inf.
  const float inv_l = rsqrtf(d0 * d0 + d1 * d1);
  float g0, g1;
  if (prefer) {
    const float fac0 = ex != 0 ? (float)ex * sofima::sign0(d0) : 1.0f;
    const float fac1 = ey != 0 ? (float)ey * sofima::sign0(d1) : 1.0f;
    g0 = k_eff * (1.0f - l0 * fac0 * inv_l) * d0;
    g1 = k_eff * (1.0f - l0 * fac1 * inv_l) * d1;
  } else {
    const float coef = k_eff * (1.0f - l0 * inv_l);
    g0 = coef * d0;
    g1 = coef * d1;
  }
  return make_float2(sofima::finite_or_zero(g0), sofima::finite_or_zero(g1));
}

// The links from row `u` to row `v` = u + 1 of the thread's view: SE from
// columns x0 - 1 + i (se[i], i = 0..kV), S from x0 + j (s[j]) and SW from
// x0 + i (sw[i], i = 0..kV).
struct Down {
  float2 se[kV + 1], s[kV], sw[kV + 1];
};

__device__ __forceinline__ void down_links(const Row& u0, const Row& u1,
                                           const Row& v0, const Row& v1,
                                           const sofima::Springs2d& S,
                                           float l0s, float l0d, bool prefer,
                                           Down& d) {
#pragma unroll
  for (int i = 0; i <= kV; ++i) {
    d.se[i] = link(u0, u1, i, v0, v1, i + 1, 1, 1, S.stride_x, S.stride_y, l0d,
                   S.k_diag, prefer);
    d.sw[i] = link(u0, u1, i + 1, v0, v1, i, -1, 1, -S.stride_x, S.stride_y,
                   l0d, S.k_diag, prefer);
  }
#pragma unroll
  for (int j = 0; j < kV; ++j)
    d.s[j] = link(u0, u1, j + 1, v0, v1, j + 1, 0, 1, 0.0f, S.stride_y, l0s,
                  S.k, prefer);
}

// x, out: [2, nb, ny, nx]; channel c of mesh b at x + c * cs + b * ny nx.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
force2d_kernel(const float* __restrict__ x, float* __restrict__ out,
               int64_t nb, int64_t cs, int ny, int nx, int band,
               sofima::Springs2d S, int prefer_flag) {
  const bool prefer = prefer_flag != 0;
  const int lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * kTile + threadIdx.x * kV;
  const int y0 = blockIdx.y * band;
  const int y1 = min(y0 + band, ny);
  // Rest lengths as force2d_node computes them.
  const float l0e = sqrtf(S.stride_x * S.stride_x);
  const float l0s = sqrtf(S.stride_y * S.stride_y);
  const float l0d = sqrtf(S.stride_x * S.stride_x + S.stride_y * S.stride_y);
  // Column conditions of the thread's nodes: a west and an east neighbour.
  bool has_w[kV], has_e[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    has_w[j] = x0 + j > 0;
    has_e[j] = x0 + j + 1 < nx;
  }
  for (int64_t b = blockIdx.z; b < nb; b += gridDim.z) {
    const int64_t base = b * (int64_t)ny * nx;
    const float* p0 = x + base;
    const float* p1 = p0 + cs;
    float* o0 = out + base;
    float* o1 = o0 + cs;
    Row c0 = view(load_raw<kVec>(p0, nx, y0, x0, lane), lane);
    Row c1 = view(load_raw<kVec>(p1, nx, y0, x0, lane), lane);
    Down up, dn;
    if (y0 > 0) {
      const Row u0 = view(load_raw<kVec>(p0, nx, y0 - 1, x0, lane), lane);
      const Row u1 = view(load_raw<kVec>(p1, nx, y0 - 1, x0, lane), lane);
      down_links(u0, u1, c0, c1, S, l0s, l0d, prefer, up);
    }
    // Rows are loaded two ahead and turned into views (shuffles) one
    // ahead, so no row's loads are waited for in the iteration that
    // issues them. Rows past the mesh repeat its last row, unused.
    Raw r0 = load_raw<kVec>(p0, nx, min(y0 + 1, ny - 1), x0, lane);
    Raw r1 = load_raw<kVec>(p1, nx, min(y0 + 1, ny - 1), x0, lane);
    for (int y = y0; y < y1; ++y) {
      const Raw q0 = load_raw<kVec>(p0, nx, min(y + 2, ny - 1), x0, lane);
      const Raw q1 = load_raw<kVec>(p1, nx, min(y + 2, ny - 1), x0, lane);
      alignas(sizeof(Vec)) float acc0[kV], acc1[kV];
      // Links to the row above, in force2d_node's order: (-1, -1), (-1,
      // 0), (-1, 1), each the row above's SE, S or SW link negated.
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        acc0[j] = 0.0f;
        acc1[j] = 0.0f;
        if (y > 0) {
          if (has_w[j]) {
            acc0[j] -= up.se[j].x;
            acc1[j] -= up.se[j].y;
          }
          acc0[j] -= up.s[j].x;
          acc1[j] -= up.s[j].y;
          if (has_e[j]) {
            acc0[j] -= up.sw[j + 1].x;
            acc1[j] -= up.sw[j + 1].y;
          }
        }
      }
      // (0, -1) and (0, 1): the E links of columns x0 - 1 + i.
      float2 e_prev = link(c0, c1, 0, c0, c1, 1, 1, 0, S.stride_x, 0.0f, l0e,
                           S.k, prefer);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float2 e = link(c0, c1, j + 1, c0, c1, j + 2, 1, 0, S.stride_x,
                              0.0f, l0e, S.k, prefer);
        if (has_w[j]) {
          acc0[j] -= e_prev.x;
          acc1[j] -= e_prev.y;
        }
        if (has_e[j]) {
          acc0[j] += e.x;
          acc1[j] += e.y;
        }
        e_prev = e;
      }
      // (1, -1), (1, 0), (1, 1): this row's SW, S and SE links, kept for
      // the next row.
      const Row n0 = view(r0, lane), n1 = view(r1, lane);
      down_links(c0, c1, n0, n1, S, l0s, l0d, prefer, dn);
      if (y + 1 < ny) {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (has_w[j]) {
            acc0[j] += dn.sw[j].x;
            acc1[j] += dn.sw[j].y;
          }
          acc0[j] += dn.s[j].x;
          acc1[j] += dn.s[j].y;
          if (has_e[j]) {
            acc0[j] += dn.se[j + 1].x;
            acc1[j] += dn.se[j + 1].y;
          }
        }
      }
      const int row = y * nx;
      if (kVec) {
        if (x0 < nx) {
          *reinterpret_cast<Vec*>(o0 + row + x0) =
              *reinterpret_cast<const Vec*>(acc0);
          *reinterpret_cast<Vec*>(o1 + row + x0) =
              *reinterpret_cast<const Vec*>(acc1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          if (x0 + j < nx) {
            o0[row + x0 + j] = acc0[j];
            o1[row + x0 + j] = acc1[j];
          }
        }
      }
      up = dn;
      c0 = n0;
      c1 = n1;
      r0 = q0;
      r1 = q1;
    }
  }
}

}  // namespace

extern "C" {

// x, out: [2, nb, ny, nx] contiguous (channels x, y). k_diag = k / sqrt(2)
// from the host. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// mesh of 2^31 nodes or more).
int force2d_launch(const float* x, float* out, int64_t nb, int ny, int nx,
                   float k, float k_diag, float stride_x, float stride_y,
                   int prefer, void* stream) {
  if (nb <= 0 || ny <= 0 || nx <= 0) return 0;
  if ((int64_t)ny * nx > INT32_MAX) return (int)cudaErrorInvalidValue;
  const sofima::Springs2d springs = {k, k_diag, stride_x, stride_y};
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Bands of rows: about 4 blocks per SM in all, so that every block is
  // resident at once (5 fit at 88 registers a thread) and no second wave
  // leaves a tail; each band at least kMinBand rows, since a band re-reads
  // the row above it and re-evaluates its links (16 rows at 2048^2).
  const int tiles = (nx + kTile - 1) / kTile;
  const int64_t meshes = nb < 65535 ? nb : 65535;
  const int64_t want = 4LL * sms / (tiles * meshes);
  const int bands = (int)(want < 1 ? 1 : (want > ny ? ny : want));
  int band = (ny + bands - 1) / bands;
  if (band < kMinBand) band = kMinBand;
  if (band < (ny + 65534) / 65535) band = (ny + 65534) / 65535;
  const dim3 grid(tiles, (ny + band - 1) / band, (unsigned)meshes);
  const int64_t cs = nb * ny * nx;
  const bool vec = (nx & 3) == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    force2d_kernel<true><<<grid, kThreads, 0, s>>>(x, out, nb, cs, ny, nx,
                                                   band, springs, prefer);
  else
    force2d_kernel<false><<<grid, kThreads, 0, s>>>(x, out, nb, cs, ny, nx,
                                                    band, springs, prefer);
  return (int)cudaGetLastError();
}

}  // extern "C"
