// 3d spring-mesh force (K9): every node's Hookean force over its 26
// neighbours (or a given subset of half-links), any batch of meshes, as a
// z-streaming stencil that evaluates each link once.
//
// Replaces sofima_tpu/ops/pallas_mesh.py `elastic_mesh_3d_pallas` (bodies
// `_kernel_3d_loop` and `_kernel_3d_rolls`) and serves its slab variant
// `elastic_mesh_3d_pallas_slab` (`_kernel_3d_slab_win`,
// `_kernel_3d_slab_symloop`, `_kernel_3d_slab`); its arithmetic is that of
// the contract both share, mesh.elastic_mesh_3d (the XLA stencil,
// `_spring_force`): per link, mesh3d.cuh's expressions; a spring to a node
// outside the mesh adds nothing.
//
// What bounds it on the H100: the arithmetic of the springs, more than
// the bytes. Each node must read its 3 positions and write its 3 forces,
// 24 B, so the 4.2 M-node mesh of the mesh3d bench stage moves 100 MB, 30
// us at 3.35 TB/s; its 13 springs a node, evaluated once each, are ~29
// instructions each (nan_to_num a component, rsqrt's denormal scaling),
// ~60 us of issue slots on 132 SMs with the repeated work below; every
// spring from both ends (26 a node, the per-node form) doubles that. At
// 128 registers a thread only 16 warps fit an SM, so part of it is
// latency: the kernel runs at about half the issue rate (PERF.md;
// profile_force3d.py).
// The TPU kernels stage halo windows in VMEM and roll them. Here:
//  * one block of kTY warps owns a tile of kTY rows x kTX = 32 kV columns
//    of one mesh and walks down z. Each warp owns a row, each lane kV
//    consecutive nodes of it (lanes on x: 16-byte loads and stores). kTY
//    is 16 where that grid gives every SM a block (one block of 512
//    threads an SM, 158 KB of shared memory, 128 registers), else 8:
//    twice the blocks, each walking its planes with half the warps, for
//    small batches of small meshes;
//  * three z-planes of the tile and its one-node halo stay in shared
//    memory; the plane after next is fetched with cp.async while a plane
//    is computed, so the loads overlap the arithmetic;
//  * at plane z, each node evaluates its 13 forward half-links (to x + 1
//    in its row, to the next row in its plane, to the 9 nodes of plane
//    z + 1) once, and takes +g; the far end takes -g, the exact negation
//    of what it would compute itself. Far ends in the thread take it in
//    registers, in the neighbouring lanes by shuffles, in another row
//    through shared memory, and in plane z + 1 in the same row in
//    registers carried to the next plane. A plane's forces are written
//    once, when all of its links are in;
//  * a link that crosses the tile's side is evaluated again by the tile
//    on the other side, for its own node: lanes 0 and 31 for the x sides,
//    warp 0 (the row above), warp 1 (the links from the row above into
//    the next plane) and the last warp (from the row below into the next
//    plane) for the y sides. That is the only repeated work, ~14% at
//    kTY = 16 and kV = 4;
//  * the halo is filled with NaN outside the mesh: a spring to such a node
//    is NaN in every component, which nan_to_num maps to 0, as no spring.
// Only the order in which a node's terms are summed differs from the
// per-node evaluation. No atomics: a second launch repeats the first bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh3d.cuh"  // sign0, finite_or_zero

namespace {

constexpr int kV = 4;                  // nodes per lane along x (one float4)
constexpr int kTX = 32 * kV;           // tile columns
constexpr int kPitch = kTX + 8;        // staged row: column x - X0 at 4 + x
constexpr int kSlab = 3 * kTX;         // one row's deliveries, 3 channels
constexpr int kSlots = 13;
constexpr unsigned kFull = 0xffffffffu;

// A tile of kTY rows, one warp each: the block, its staged planes (the
// tile and its one-node halo) and its shared memory.
template <int kTY>
struct Tile {
  static constexpr int kThreads = 32 * kTY;
  static constexpr int kRows = kTY + 2;
  static constexpr int kPlane = 3 * kRows * kPitch;  // floats a plane
  static constexpr int kSmemBytes = 4 * (3 * kPlane + 3 * kTY * kSlab);
};

// The forward half-links, slot by slot: E = (dz, dy, dx) (0, 0, 1) in
// slot 0; (0, 1, dx) in 2 + dx; (1, dy, dx) in 4 + 3 (dy + 1) + dx + 1.
__host__ __device__ constexpr int slot(int dz, int dy, int dx) {
  return dz == 0 ? (dy == 0 ? 0 : 2 + dx) : 4 + 3 * (dy + 1) + dx + 1;
}

struct Links13 {
  float l0v[kSlots][3];  // stride * e (x, y, z)
  float l0[kSlots];      // |l0v|
  float k[kSlots];       // k_eff; 0 where absent
  unsigned mask;         // bit s: slot s is a link of the mesh
};

// A lane's view of one staged row: columns x0 - 1 .. x0 + kV of each
// channel, x0 = kV * lane.
struct Row {
  float v[3][kV + 2];
};

// The force on node a from its spring to node b in slot s, offset (ex, ey,
// ez): mesh3d.cuh's expressions (force3d_node); node b takes exactly its
// negation. A zero component of l0v is not added (the sum differs from
// force3d_node's only in the sign of a zero).
__device__ __forceinline__ float3 spring(float a0, float a1, float a2,
                                         float b0, float b1, float b2,
                                         const Links13& L, int s, int ex,
                                         int ey, int ez, bool prefer) {
  float d0 = b0 - a0, d1 = b1 - a1, d2 = b2 - a2;
  if (ex != 0) d0 += L.l0v[s][0];
  if (ey != 0) d1 += L.l0v[s][1];
  if (ez != 0) d2 += L.l0v[s][2];
  const float dd = d0 * d0 + d1 * d1 + d2 * d2;
  const float l0 = L.l0[s], k = L.k[s];
  // 1/|d| as rsqrt: inf at d = 0 and 0 at |d| = inf, so every degenerate
  // link ends in a non-finite value that finite_or_zero drops.
  const float inv_len = rsqrtf(dd);
  float g0, g1, g2;
  if (prefer) {
    const float f0 = ex != 0 ? (float)ex * sofima::sign0(d0) : 1.0f;
    const float f1 = ey != 0 ? (float)ey * sofima::sign0(d1) : 1.0f;
    const float f2 = ez != 0 ? (float)ez * sofima::sign0(d2) : 1.0f;
    g0 = k * (1.0f - l0 * f0 * inv_len) * d0;
    g1 = k * (1.0f - l0 * f1 * inv_len) * d1;
    g2 = k * (1.0f - l0 * f2 * inv_len) * d2;
  } else {
    const float coef = k * (1.0f - l0 * inv_len);
    g0 = coef * d0;
    g1 = coef * d1;
    g2 = coef * d2;
  }
  return make_float3(sofima::finite_or_zero(g0), sofima::finite_or_zero(g1),
                     sofima::finite_or_zero(g2));
}

// Row `row` (-1 .. kTY, tile-relative) of a staged plane. Every lane of
// the warp must call it.
template <int kTY>
__device__ __forceinline__ void view(const float* plane, int row, int lane,
                                     Row& r) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* p = plane + (c * Tile<kTY>::kRows + row + 1) * kPitch;
    const float4 q = *reinterpret_cast<const float4*>(p + 4 + kV * lane);
    r.v[c][1] = q.x;
    r.v[c][2] = q.y;
    r.v[c][3] = q.z;
    r.v[c][4] = q.w;
    const float left = __shfl_up_sync(kFull, q.w, 1);
    const float right = __shfl_down_sync(kFull, q.x, 1);
    r.v[c][0] = lane == 0 ? p[3] : left;
    r.v[c][kV + 1] = lane == 31 ? p[4 + kTX] : right;
  }
}

__device__ __forceinline__ void add(float (&acc)[kV][3], int j, float3 g) {
  acc[j][0] += g.x;
  acc[j][1] += g.y;
  acc[j][2] += g.z;
}

// Stores t (the force on the far ends) as row `row` of an exchange
// buffer.
__device__ __forceinline__ void deliver(float* buf, int row, int lk,
                                        const float (&t)[kV][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    *reinterpret_cast<float4*>(buf + row * kSlab + c * kTX + lk) =
        make_float4(t[0][c], t[1][c], t[2][c], t[3][c]);
}

// Adds row `row` of an exchange buffer to acc.
__device__ __forceinline__ void take(const float* buf, int row, int lk,
                                     float (&acc)[kV][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float4 q =
        *reinterpret_cast<const float4*>(buf + row * kSlab + c * kTX + lk);
    acc[0][c] += q.x;
    acc[1][c] += q.y;
    acc[2][c] += q.z;
    acc[3][c] += q.w;
  }
}

__device__ __forceinline__ void plus(float (&acc)[kV][3],
                                     const float (&t)[kV][3]) {
#pragma unroll
  for (int j = 0; j < kV; ++j) {
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[j][c] += t[j][c];
  }
}

__device__ __forceinline__ float3 shfl3(float3 g, bool up) {
  return up ? make_float3(__shfl_up_sync(kFull, g.x, 1),
                          __shfl_up_sync(kFull, g.y, 1),
                          __shfl_up_sync(kFull, g.z, 1))
            : make_float3(__shfl_down_sync(kFull, g.x, 1),
                          __shfl_down_sync(kFull, g.y, 1),
                          __shfl_down_sync(kFull, g.z, 1));
}

// The springs (DZ, DY, dx) from the lane's kV nodes of row `a` to row `b`
// (dx = 1 only for the E links, DZ = DY = 0; else dx = -1, 0, 1). Each
// source node takes its springs into `src` (kSrc); t[j] gets the force on
// node j of row b, the negated sum of the springs whose far end it is.
// Far ends in the neighbouring lane come by shuffles; lane 0 evaluates
// the spring from column x0 - 1 of row a (the tile's left halo) and lane
// 31 the one from x0 + kV (its right halo). Every lane must call it.
template <int DZ, int DY, bool kSrc, bool kPrefer, bool kAll>
__device__ __forceinline__ void group(const Row& a, const Row& b,
                                      const Links13& L, int lane,
                                      float (&src)[kV][3],
                                      float (&t)[kV][3]) {
  constexpr bool kEast = DZ == 0 && DY == 0;
  // With every link present, each t[j] is first set by a spring (dx = 0,
  // or for the E links dx = 1 and the edge below), not zeroed.
  constexpr bool kInit = !kAll;
  if (kInit) {
#pragma unroll
    for (int j = 0; j < kV; ++j) t[j][0] = t[j][1] = t[j][2] = 0.0f;
  }
  const auto put = [&](int j, float3 g, bool first) {
    if (first && !kInit) {
      t[j][0] = -g.x;
      t[j][1] = -g.y;
      t[j][2] = -g.z;
    } else {
      t[j][0] -= g.x;
      t[j][1] -= g.y;
      t[j][2] -= g.z;
    }
  };
  float3 up = make_float3(0.0f, 0.0f, 0.0f);  // to the next lane's column 0
  float3 down = up;                            // to the last lane's column 3
  // dx = 0 first: it reaches every column of the lane.
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int dx = kEast ? 1 : (k == 0 ? 0 : (k == 1 ? -1 : 1));
    if (kEast && k > 0) break;
    const int s = slot(DZ, DY, dx);
    if (!kAll && !(L.mask >> s & 1)) continue;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float3 g = spring(a.v[0][j + 1], a.v[1][j + 1], a.v[2][j + 1],
                              b.v[0][j + 1 + dx], b.v[1][j + 1 + dx],
                              b.v[2][j + 1 + dx], L, s, dx, DY, DZ, kPrefer);
      if (kSrc) add(src, j, g);
      const int tj = j + dx;
      if (tj >= 0 && tj < kV)
        put(tj, g, k == 0);
      else if (dx == 1)
        up = g;
      else
        down = g;
    }
  }
  // The links from the halo column into the lane's edge column: lane 0's
  // from x0 - 1 (dx = 1), lane 31's from x0 + kV (dx = -1). Evaluated in
  // every lane, kept in those two.
  const bool lo = lane == 0;
  const int fdx = lo ? 1 : -1;
  const int fs = slot(DZ, DY, fdx);
  float fa[3], fb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    fa[c] = lo ? a.v[c][0] : a.v[c][kV + 1];
    fb[c] = lo ? b.v[c][1] : b.v[c][kV];
  }
  const float3 fix = spring(fa[0], fa[1], fa[2], fb[0], fb[1], fb[2], L, fs,
                            fdx, DY, DZ, kPrefer);
  const bool has_up = kAll || (L.mask >> slot(DZ, DY, 1) & 1);
  const bool has_down = !kEast && (kAll || (L.mask >> slot(DZ, DY, -1) & 1));
  if (has_up) {
    const float3 g = shfl3(up, true);
    put(0, lo ? fix : g, kEast);
  }
  if (has_down) {
    const float3 g = shfl3(down, false);
    put(kV - 1, lane == 31 ? fix : g, false);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Stages plane z of mesh `m` (channel c at m + c cs) for the tile at (Y0,
// X0): rows Y0 - 1 .. Y0 + kTY, columns X0 - 1 .. X0 + kTX, NaN outside
// the mesh. Asynchronous: complete after cp.async.wait_all and a barrier.
template <int kTY>
__device__ __forceinline__ void stage(float* dst, const float* m, int64_t cs,
                                      int z, int ny, int nx, int Y0, int X0,
                                      bool vec) {
  constexpr int kRows = Tile<kTY>::kRows;
  constexpr int kItems = kTX / 4 + 2;  // 16-byte chunks, then the halos
  for (int i = threadIdx.x; i < 3 * kRows * kItems;
       i += Tile<kTY>::kThreads) {
    const int k = i % kItems, rc = i / kItems;
    const int row = rc % kRows, c = rc / kRows;
    const int y = Y0 - 1 + row;
    const bool yin = y >= 0 && y < ny;
    float* d = dst + (c * kRows + row) * kPitch;
    const float* s = m + c * cs + ((int64_t)z * ny + (yin ? y : 0)) * nx;
    if (k < kTX / 4) {
      const int xx = X0 + 4 * k;
      d += 4 + 4 * k;
      if (yin && vec && xx + 3 < nx) {
        cp_async16(d, s + xx);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (yin && xx + e < nx)
            cp_async4(d + e, s + xx + e);
          else
            d[e] = NAN;
        }
      }
    } else {
      const bool left = k == kTX / 4;
      const int xx = left ? X0 - 1 : X0 + kTX;
      d += left ? 3 : 4 + kTX;
      if (yin && xx >= 0 && xx < nx)
        cp_async4(d, s + xx);
      else
        *d = NAN;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// x, out: [3, nb, nz, ny, nx]; channel c of mesh b at x + c cs + b per.
// One block per (tile, mesh); tiles in (y, x) order on blockIdx.x.
// The launch bound keeps 128 registers a thread at any kTY (16 warps an
// SM).
template <int kTY, bool kPrefer, bool kAll>
__global__ void __launch_bounds__(Tile<kTY>::kThreads, 16 / kTY)
force3d_kernel(const float* __restrict__ x, float* __restrict__ out,
               int64_t nb, int64_t cs, int nz, int ny, int nx, int tiles_x,
               bool vec, Links13 L) {
  constexpr int kPlane = Tile<kTY>::kPlane;
  extern __shared__ float4 smem4[];
  float* planes = reinterpret_cast<float*>(smem4);  // [3][kPlane]
  float* sS = planes + 3 * kPlane;  // [kTY][3][kTX]: from the row above
  float* sDp = sS + kTY * kSlab;    // [kTY]...: next plane, from above
  float* sDm = sDp + kTY * kSlab;   // [kTY]...: next plane, from below
  const int lane = threadIdx.x & 31, r = threadIdx.x >> 5;
  const int X0 = (int)(blockIdx.x % tiles_x) * kTX;
  const int Y0 = (int)(blockIdx.x / tiles_x) * kTY;
  const int64_t per = (int64_t)nz * ny * nx;
  const int y = Y0 + r;
  const int x0 = X0 + kV * lane;
  const int lk = kV * lane;  // the lane's first column in a row's slab

  for (int64_t b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* m = x + b * per;
    float* o = out + b * per;
    stage<kTY>(planes, m, cs, 0, ny, nx, Y0, X0, vec);
    if (nz > 1) stage<kTY>(planes + kPlane, m, cs, 1, ny, nx, Y0, X0, vec);
    float acc[kV][3], carry[kV][3], t[kV][3];
#pragma unroll
    for (int j = 0; j < kV; ++j)
      carry[j][0] = carry[j][1] = carry[j][2] = 0.0f;
    for (int z = 0; z < nz; ++z) {
      // Planes z and z + 1 are in; every warp is done with plane z - 1
      // and with the deliveries of the last plane.
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (z + 2 < nz)
        stage<kTY>(planes + (z + 2) % 3 * kPlane, m, cs, z + 2, ny, nx, Y0,
                   X0, vec);
      const float* P = planes + z % 3 * kPlane;
      const float* N = planes + (z + 1) % 3 * kPlane;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[j][c] = carry[j][c];
          carry[j][c] = 0.0f;
        }
      }
      Row own, nxt, nb_row;
      view<kTY>(P, r, lane, own);
      // In the plane: E links (far ends in this row), then the links to
      // the next row, kept for that row's warp.
      group<0, 0, true, kPrefer, kAll>(own, own, L, lane, acc, t);
      plus(acc, t);
      view<kTY>(P, r + 1, lane, nxt);
      group<0, 1, true, kPrefer, kAll>(own, nxt, L, lane, acc, t);
      if (r + 1 < kTY) deliver(sS, r + 1, lk, t);
      if (r == 0) {
        // The row above the tile: its links into row 0.
        view<kTY>(P, -1, lane, nb_row);
        group<0, 1, false, kPrefer, kAll>(nb_row, own, L, lane, t, t);
        deliver(sS, 0, lk, t);
      }
      if (z + 1 < nz) {
        // To plane z + 1: rows r - 1, r (carried in registers), r + 1.
        view<kTY>(N, r - 1, lane, nb_row);
        group<1, -1, true, kPrefer, kAll>(own, nb_row, L, lane, acc, t);
        if (r > 0) deliver(sDm, r - 1, lk, t);
        view<kTY>(N, r, lane, nb_row);
        group<1, 0, true, kPrefer, kAll>(own, nb_row, L, lane, acc, t);
        plus(carry, t);
        if (r == kTY - 1) {
          // The row below the tile: its links into row kTY - 1 of z + 1.
          group<1, -1, false, kPrefer, kAll>(nxt, nb_row, L, lane, t, t);
          deliver(sDm, kTY - 1, lk, t);
        }
        view<kTY>(N, r + 1, lane, nb_row);
        group<1, 1, true, kPrefer, kAll>(own, nb_row, L, lane, acc, t);
        if (r + 1 < kTY) deliver(sDp, r + 1, lk, t);
        if (r == 1) {
          // The row above the tile: its links into row 0 of z + 1.
          view<kTY>(P, -1, lane, nxt);
          view<kTY>(N, 0, lane, nb_row);
          group<1, 1, false, kPrefer, kAll>(nxt, nb_row, L, lane, t, t);
          deliver(sDp, 0, lk, t);
        }
      }
      __syncthreads();
      // Plane z's links from the row above are in: the plane is done.
      // Plane z + 1's links from plane z in the rows above and below.
      take(sS, r, lk, acc);
      if (z + 1 < nz) {
        take(sDp, r, lk, carry);
        take(sDm, r, lk, carry);
      }
      if (y < ny && x0 < nx) {
        float* row = o + ((int64_t)z * ny + y) * nx;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float* p = row + c * cs + x0;
          if (vec && x0 + kV - 1 < nx) {
            *reinterpret_cast<float4*>(p) =
                make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
          } else {
#pragma unroll
            for (int j = 0; j < kV; ++j)
              if (x0 + j < nx) p[j] = acc[j][c];
          }
        }
      }
    }
    __syncthreads();  // the next mesh restages plane 0
  }
}

template <int kTY, bool kPrefer, bool kAll>
int launch(const float* x, float* out, int64_t nb, int nz, int ny, int nx,
           const Links13& L, int dev, cudaStream_t stream) {
  using T = Tile<kTY>;
  const auto fn = force3d_kernel<kTY, kPrefer, kAll>;
  // The shared-memory opt-in, once per device (a racing second call only
  // sets it again).
  static unsigned long long opted = 0;
  if (dev >= 64 || !(opted >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted |= 1ull << dev;
  }
  const int tiles_x = (nx + kTX - 1) / kTX;
  const int64_t tiles = (int64_t)tiles_x * ((ny + kTY - 1) / kTY);
  const int64_t cs = nb * nz * (int64_t)ny * nx;
  const bool vec = (nx & 3) == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const dim3 grid((unsigned)tiles, (unsigned)(nb < 65535 ? nb : 65535));
  fn<<<grid, T::kThreads, T::kSmemBytes, stream>>>(x, out, nb, cs, nz, ny,
                                                   nx, tiles_x, vec, L);
  return (int)cudaGetLastError();
}

template <int kTY>
int launch_rows(const float* x, float* out, int64_t nb, int nz, int ny,
                int nx, const Links13& L, bool prefer, int dev,
                cudaStream_t s) {
  const bool all = L.mask == (1u << kSlots) - 1;
  if (prefer)
    return all ? launch<kTY, true, true>(x, out, nb, nz, ny, nx, L, dev, s)
               : launch<kTY, true, false>(x, out, nb, nz, ny, nx, L, dev, s);
  return all ? launch<kTY, false, true>(x, out, nb, nz, ny, nx, L, dev, s)
             : launch<kTY, false, false>(x, out, nb, nz, ny, nx, L, dev, s);
}

}  // namespace

extern "C" {

// x, out: [3, nb, nz, ny, nx] contiguous (channels x, y, z). table: host
// float[nlinks * 8], per half-link (ex, ey, ez, l0x, l0y, l0z, l0, k_eff)
// in forward form ((ez, ey, ex) > 0), no direction twice
// (cuda_mesh._link_table). Returns cudaGetLastError()
// (cudaErrorInvalidValue for a bad table or a plane of 2^31 nodes or
// more).
int force3d_launch(const float* x, float* out, int64_t nb, int nz, int ny,
                   int nx, const float* table, int nlinks, int prefer,
                   void* stream) {
  if (nb <= 0 || nz <= 0 || ny <= 0 || nx <= 0) return 0;
  if ((int64_t)ny * nx > INT32_MAX || nlinks < 0 || nlinks > kSlots)
    return (int)cudaErrorInvalidValue;
  Links13 L = {};
  for (int l = 0; l < nlinks; ++l) {
    const float* e = table + 8 * l;
    const int ex = (int)e[0], ey = (int)e[1], ez = (int)e[2];
    const bool fwd = ez == 1 || (ez == 0 && (ey == 1 || (ey == 0 && ex == 1)));
    if (!fwd || ex < -1 || ex > 1 || ey < -1 || ey > 1)
      return (int)cudaErrorInvalidValue;
    const int s = slot(ez, ey, ex);
    if (L.mask >> s & 1) return (int)cudaErrorInvalidValue;
    L.mask |= 1u << s;
    L.l0v[s][0] = e[3];
    L.l0v[s][1] = e[4];
    L.l0v[s][2] = e[5];
    L.l0[s] = e[6];
    L.k[s] = e[7];
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int sms[64] = {};
  if (dev >= 64 || sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    sms[dev] = n;
  }
  // Tiles of 16 rows where they give every SM a block; else of 8, twice
  // the blocks with half the warps each, so a small batch of meshes
  // (path (a)'s tile meshes) walks its planes with less latency.
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t meshes = nb < 65535 ? nb : 65535;
  const int64_t tiles16 = (int64_t)((nx + kTX - 1) / kTX) * ((ny + 15) / 16);
  if (tiles16 * meshes >= sms[dev])
    return launch_rows<16>(x, out, nb, nz, ny, nx, L, prefer, dev, s);
  return launch_rows<8>(x, out, nb, nz, ny, nx, L, prefer, dev, s);
}

}  // extern "C"
