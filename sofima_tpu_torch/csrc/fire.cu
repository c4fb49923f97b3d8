// Fused FIRE mesh relaxation: the whole chunked convergence loop of
// mesh.relax_mesh_fused in ONE cooperative kernel launch, for 2d section
// meshes (K3) and 3d tile meshes (K11).
//
// Replaces sofima_tpu/ops/pallas_mesh.py `_fused_fire_kernel` (entry
// relax_mesh_fused_pallas) with `_roll_force_2d`: 8-neighbour Hooke
// springs (diagonals at k/sqrt(2)), the force of K8 under the Pallas NaN
// rule (mesh2d.cuh); and the inner `kernel` of
// relax_mesh_fused_pallas_3d with `_roll_force_3d` /
// `_roll_force_3d_loop`: 26-neighbour springs at k * stride_x / l0, the
// force of K9 (mesh3d.cuh). One loop body serves both, templated on the
// dimension: prefer_orig_order, NaN-inert nodes, zero-length k0 springs
// to `prev` clamped by the force cap, cap escalation, and the stop test
// "two consecutive converged chunks". The 3d kernel's `link_loop`,
// `symmetric` and `guard` variants are Mosaic workarounds with the same
// result; nodes outside the grid simply carry no spring here.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A section's
// mesh is ~250^2 nodes and a LICONN tile mesh 8 x 128 x 256, and every
// FIRE step needs one global reduction (the power sum f.v) before any
// node may take the next step. So the design keeps the state on chip and
// spends one grid-wide exchange per step:
//  * Each block owns one tile of nodes (tz x ty x tx = 256 threads x
//    `npt` nodes, from ops/cuda_mesh.fire_plan) for the whole solve, and
//    all blocks are co-resident (cooperative launch). A tile's positions
//    and a one-node halo live in shared memory, its velocities and
//    accelerations too: no node state is re-read from device memory.
//  * A step is: position update, force, Verlet velocity, FIRE mixing,
//    power partial, one exchange. The nodes on a tile face that borders
//    another tile publish (x, v, a) into that face's slots, a compact
//    per-tile buffer (two sets, by step parity, so a step's writes never
//    race the reads of the step before). Once a block has the power
//    total it knows dt, alpha, the cap and the uphill reset; it then
//    advances its own nodes and its halo with the same expression
//    (`advance`, on fma intrinsics so both give the same bits), and takes
//    the next force from shared memory.
//  * Every word that crosses blocks carries the step that wrote it (a
//    64-bit store of the float and its tag), so readers poll for it and
//    no fence orders one write after another. Each block publishes its
//    power partial (FP64 inside the block, then float); block 0 polls the
//    partials, sums them in one fixed order in FP64 and publishes the
//    total; every block polls the total and its missing halo words in
//    one loop. So all blocks agree on the FIRE scalars without atomics, and a
//    run repeats bit for bit. Kinetic energy and v_max ride on the last
//    step of a chunk, in the same exchange.
// K3 keeps force2d_node's body and the FIRE expressions of the kernel
// it replaces; only where x is read from (shared memory) and the order
// of the grid sums changed.
//
// A mesh whose tiles the card cannot hold at once (ops/cuda_mesh.fire_plan
// finds no plan: above ~1M nodes near square, 100 x 4700 elongated, or
// 262 144 nodes in 3d) takes the second route, `grid_fire_kernel`: the
// state (x, v, a) in device memory, a cooperative grid sized by the
// occupancy API, each thread looping over nodes, two grid barriers a step
// (after the position update, after the power partials), block partials
// in FP64 summed by every block in one fixed order. It has no size limit
// of its own; the wrapper holds both routes to the reference's VMEM bound
// (786 432 nodes in 2d, 524 288 in 3d), so both packages take the same
// meshes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "mesh2d.cuh"
#include "mesh3d.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // blocks per SM the registers must allow
constexpr unsigned kFull = 0xffffffffu;

struct FireParams {
  float dt, gamma, k0, k, k_diag, stride_x, stride_y;
  float f_alpha, f_inc, f_dec, alpha, dt_cap;
  float start_cap, final_cap, cap_scale, stop_v_max;
  int num_iters, max_chunks, n_min, cap_upscale_every;
  int prefer_orig_order, has_prev;
  sofima::Links3d links;  // 3d only
};

// The tiling: tiles of tz x ty x tx nodes (tz = 1 in 2d; ty = 2^sy and
// tx = 2^sx), ntz x nty x ntx of them, one per block, in (z, y, x) order.
struct Tiling {
  int tz, ty, tx, sy, sx, ntz, nty, ntx;
};

// jnp.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX.
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// The velocity-Verlet position update x + dt v + (dt^2 / 2) a, contracted
// as the compiler contracts the written expression, but spelled out: the
// owner of a node and every block that holds it in its halo must get the
// same bits.
__device__ __forceinline__ float advance(float x, float v, float a, float dt,
                                         float half_dt2) {
  return __fmaf_rn(half_dt2, a, __fmaf_rn(dt, v, x));
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Words that cross blocks are 64 bits: a float's bits below and a tag,
// the number of the step that wrote it (from 1), above. One
// single-copy-atomic relaxed store publishes both, and a reader polls
// until the tag is the one it waits for. Each word vouches only for
// itself, so no fence has to order one write after another.
__device__ __forceinline__ unsigned long long word(unsigned tag, float v) {
  return (unsigned long long)tag << 32 | __float_as_uint(v);
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ bool tagged(unsigned long long w, unsigned tag) {
  return (unsigned)(w >> 32) == tag;
}

__device__ __forceinline__ float value(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

// A poll that has not seen its tag after this many rounds (seconds)
// traps, a launch error the wrapper raises on, rather than hang.
constexpr long long kMaxPolls = 1ll << 25;

// The block sum (c = 0, 1) or max (c = 2) of per-thread values, in one
// fixed order; the same value in every thread.
__device__ __forceinline__ double block_total(double v, int c,
                                              double* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = c == 2 ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red's last readers are done
  if (lane == 0) red[wid] = v;
  __syncthreads();
  double t = red[0];
  for (int w = 1; w < kWarps; ++w) t = c == 2 ? fmax(t, red[w]) : t + red[w];
  return t;
}

constexpr int kMaxBlocks = 2 * kThreads;

// The FIRE scalars after a step whose power total was negative
// (`uphill`) or not: dt, alpha, the force cap, the count of downhill
// steps n_pos, and the uphill reset (v reads as 0 in the next step).
__device__ __forceinline__ void fire_next(bool uphill, const FireParams& P,
                                          float& dt, float& alpha, float& cap,
                                          int& n_pos, bool& reset) {
  n_pos = uphill ? 0 : n_pos + 1;
  const bool grow = !uphill && n_pos > P.n_min;
  dt = uphill ? dt * P.f_dec : (grow ? fminf(dt * P.f_inc, P.dt_cap) : dt);
  alpha = uphill ? P.alpha : (grow ? alpha * P.f_alpha : alpha);
  const bool up_cap = !uphill && n_pos > 0 &&
                      (n_pos % P.cap_upscale_every) == 0;
  cap = fminf(up_cap ? P.cap_scale * cap : cap, P.final_cap);
  reset = uphill;
}

// x_in, x_out, prev: [D, nz, gy, gx] (nz = 1 in 2d; prev may be NULL).
// One block per tile. pub: [2, tiles, 3, D, nf] words by tag parity: each
// tile's face slots, (x, v, a) of the nodes on its faces (a compact set,
// so what the halos read stays in L2). slots: [2, 3 * tiles + 3] words
// by tag parity: each tile's partials of (power, kinetic energy, max
// |v|^2), then their totals. Both zeroed by the caller. ehist:
// [max_chunks]; steps: [1]. Dynamic shared memory
// (cuda_mesh.fire_smem_bytes): positions of the tile and its halo box,
// the tile's velocities and accelerations, the list of halo entries that
// lie on the mesh and their polled (x, v, a).
template <int D, bool kPrefer>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_fire_kernel(const float* __restrict__ x_in, float* __restrict__ x_out,
                  const float* __restrict__ prev,
                  unsigned long long* __restrict__ pub,
                  unsigned long long* __restrict__ slots,
                  float* __restrict__ ehist, int* __restrict__ steps,
                  int nz, int gy, int gx, Tiling T, FireParams P) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps];
  __shared__ float tot[3];
  __shared__ int wcount[kWarps];
  constexpr int H = D == 3 ? 1 : 0;  // z halo
  const int bx = T.tx + 2, by = T.ty + 2, bz = T.tz + 2 * H;
  const int box = bz * by * bx;
  const int tn = T.tz * T.ty * T.tx;
  const int hn = box - tn;  // room for the halo list
  float* xs = smem;          // [D][box]: tile and halo positions
  float* vs = xs + D * box;  // [D][tn]: own velocities
  float* as = vs + D * tn;   // [D][tn]: own accelerations
  int* hl = (int*)(as + D * tn);  // [hn]: halo entries' box index
  int* hi = hl + hn;              // [hn]: and word in the faces
  float* hs = (float*)(hi + hn);  // [3 D][hn]: their polled x, v, a
  const int n = nz * gy * gx;
  const int nb = gridDim.x;
  const int nslots = 3 * nb + 3;
  const int oz = blockIdx.x / (T.nty * T.ntx) * T.tz;
  const int oy = blockIdx.x / T.ntx % T.nty * T.ty;
  const int ox = blockIdx.x % T.ntx * T.tx;
  // Face slots of a tile: the x faces (low, high), the y faces, the z
  // faces (3d); a slot holds one node's (x, v, a), 3 D words.
  const int fx = T.tz * T.ty, fy = T.tz * T.tx, fz = T.ty * T.tx;
  const int nf = 2 * (fx + fy) + (D == 3 ? 2 * fz : 0);
  const size_t pub_set = (size_t)nb * 3 * D * nf;

  // Own node l of the tile: its mesh coordinates and box index; false
  // where the tile overhangs the mesh.
  const auto own = [&](int l, int& z, int& y, int& xx, int& bi) {
    const int lx = l & (T.tx - 1), ly = (l >> T.sx) & (T.ty - 1);
    const int lz = l >> (T.sx + T.sy);
    z = oz + lz;
    y = oy + ly;
    xx = ox + lx;
    bi = ((lz + H) * by + ly + 1) * bx + lx + 1;
    return z < nz && y < gy && xx < gx;
  };
  // Halo entry hb of the box: its mesh index, or -1 (interior or off the
  // mesh); and where its owner publishes it: the owner tile's face that
  // faces this tile (the x face if the entry lies beyond this tile in x,
  // else the y face, else the z face), as a word offset in one set.
  const auto halo = [&](int hb, int& word_at) {
    const int hx = hb % bx, hy = hb / bx % by, hz = hb / (bx * by);
    const bool inner = hx >= 1 && hx <= T.tx && hy >= 1 && hy <= T.ty &&
                       hz >= H && hz < T.tz + H;
    const int z = oz + hz - H, y = oy + hy - 1, xx = ox + hx - 1;
    if (inner || z < 0 || z >= nz || y < 0 || y >= gy || xx < 0 || xx >= gx)
      return -1;
    const int tzi = z / T.tz, tyi = y >> T.sy, txi = xx >> T.sx;
    const int lz = z - tzi * T.tz, ly = y & (T.ty - 1), lx = xx & (T.tx - 1);
    int slot;
    if (xx < ox)
      slot = fx + lz * T.ty + ly;  // the owner's high x face
    else if (xx >= ox + T.tx)
      slot = lz * T.ty + ly;  // its low x face
    else if (y < oy)
      slot = 2 * fx + fy + lz * T.tx + lx;
    else if (y >= oy + T.ty)
      slot = 2 * fx + lz * T.tx + lx;
    else if (z < oz)
      slot = 2 * (fx + fy) + fz + ly * T.tx + lx;
    else
      slot = 2 * (fx + fy) + ly * T.tx + lx;
    word_at = ((tzi * T.nty + tyi) * T.ntx + txi) * 3 * D * nf + slot;
    return (z * gy + y) * gx + xx;
  };
  const auto force = [&](int bi, int z, int y, int xx, int i, float cap,
                         float f[D]) {
    if constexpr (D == 2) {
      const sofima::Springs2d S = {P.k, P.k_diag, P.stride_x, P.stride_y};
      const auto at = [&](int c, int ey, int ex) {
        return xs[c * box + bi + ey * bx + ex];
      };
      // Nodes off the mesh's edges skip the bounds tests (in 3d the second
      // copy of the 26 links would cost more in instruction fetch).
      if (y > 0 && y < gy - 1 && xx > 0 && xx < gx - 1)
        sofima::force2d_node<false>(at, gy, gx, y, xx, S, kPrefer, f);
      else
        sofima::force2d_node(at, gy, gx, y, xx, S, kPrefer, f);
    } else {
      const auto at = [&](int c, int ez, int ey, int ex) {
        return xs[c * box + bi + (ez * by + ey) * bx + ex];
      };
      sofima::force3d_node(at, nz, gy, gx, z, y, xx, P.links, kPrefer, f);
    }
    if (P.has_prev) {
      for (int c = 0; c < D; ++c) {
        const float s = -P.k0 * nan_to_num(xs[c * box + bi] -
                                           __ldg(prev + c * n + i));
        f[c] += fminf(fmaxf(s, -cap), cap);
      }
    }
  };
  // Node l's (x, v, a) under `tag`, on each of the tile's faces that it
  // lies on and that borders another tile, for those tiles' halos.
  const auto publish = [&](unsigned tag, int l, int bi, int z, int y,
                           int xx) {
    const int lx = l & (T.tx - 1), ly = (l >> T.sx) & (T.ty - 1);
    const int lz = l >> (T.sx + T.sy);
    unsigned long long* dst =
        pub + (tag & 1) * pub_set + (size_t)blockIdx.x * 3 * D * nf;
    const auto put = [&](int slot) {
      for (int c = 0; c < D; ++c) {
        st_word(dst + c * nf + slot, word(tag, xs[c * box + bi]));
        st_word(dst + (D + c) * nf + slot, word(tag, vs[c * tn + l]));
        st_word(dst + (2 * D + c) * nf + slot, word(tag, as[c * tn + l]));
      }
    };
    if (lx == 0 && xx > 0) put(lz * T.ty + ly);
    if (lx == T.tx - 1 && xx < gx - 1) put(fx + lz * T.ty + ly);
    if (ly == 0 && y > 0) put(2 * fx + lz * T.tx + lx);
    if (ly == T.ty - 1 && y < gy - 1) put(2 * fx + fy + lz * T.tx + lx);
    if (D == 3 && lz == 0 && z > 0) put(2 * (fx + fy) + ly * T.tx + lx);
    if (D == 3 && lz == T.tz - 1 && z < nz - 1)
      put(2 * (fx + fy) + fz + ly * T.tx + lx);
  };
  // The tile's partials under `tag` into its slots (after the block's
  // other writes: block_total synchronizes first). Block 0 then polls all
  // tiles' partials, sums them in one fixed order in FP64, publishes the
  // totals and keeps them in tot.
  const auto reduce = [&](unsigned tag, double s0, double s1, double m2,
                          int nv) {
    unsigned long long* sl = slots + (tag & 1) * nslots;
    const auto partial = [&](double v, int c) {
      const double t = block_total(v, c, red);
      if (threadIdx.x == 0)
        st_word(sl + c * nb + blockIdx.x, word(tag, (float)t));
    };
    partial(s0, 0);
    if (nv > 1) {
      partial(s1, 1);
      partial(m2, 2);
    }
    if (blockIdx.x != 0) return;
    float got[2][3];
    for (long long r = 0;; ++r) {
      bool ok = true;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int b = threadIdx.x + k * kThreads;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          got[k][c] = 0.0f;
          if (b < nb && c < nv) {
            const unsigned long long w = ld_word(sl + c * nb + b);
            ok = ok && tagged(w, tag);
            got[k][c] = value(w);
          }
        }
      }
      if (__syncthreads_and(ok)) break;
      if (r > kMaxPolls) __trap();
    }
    const auto total = [&](int c) {
      const double v = c == 2 ? fmax((double)got[0][c], (double)got[1][c])
                              : (double)got[0][c] + (double)got[1][c];
      const float t = (float)block_total(v, c, red);
      if (threadIdx.x == 0) {
        tot[c] = t;
        st_word(sl + 3 * nb + c, word(tag, t));
      }
    };
    total(0);
    if (nv > 1) {
      total(1);
      total(2);
    }
  };
  // The halo entries under `tag` into hs: one read as soon as they may be
  // out (`start_halo`), then polls of what was missing, together with the
  // `nv` totals under `tag` into tot (block 0 has them already); returns
  // when all are in. Only missing entries are read again, so the card is
  // not flooded with halo reads (bit j of `seen`: entry threadIdx.x + j *
  // kThreads).
  int nh = 0;  // halo entries on the mesh
  unsigned seen = 0;
  bool halo_in = true;
  const auto read_halo = [&](unsigned tag) {
    const unsigned long long* src = pub + (tag & 1) * pub_set;
    bool ok = true;
    for (int k = threadIdx.x, j = 0; k < nh; k += kThreads, ++j) {
      if (seen >> j & 1) continue;
      bool all = true;
#pragma unroll
      for (int s = 0; s < 3 * D; ++s) {
        const unsigned long long w = ld_word(src + s * nf + hi[k]);
        all = all && tagged(w, tag);
        hs[s * hn + k] = value(w);
      }
      if (all) seen |= 1u << j;
      ok = ok && all;
    }
    halo_in = ok;
  };
  const auto start_halo = [&](unsigned tag) {
    seen = 0;
    read_halo(tag);
  };
  const auto wait = [&](unsigned tag, int nv) {
    const unsigned long long* totals = slots + (tag & 1) * nslots + 3 * nb;
    bool have = blockIdx.x == 0 || threadIdx.x >= nv;
    for (long long r = 0;; ++r) {
      if (!have) {
        const unsigned long long w = ld_word(totals + threadIdx.x);
        have = tagged(w, tag);
        tot[threadIdx.x] = value(w);
      }
      if (!halo_in) read_halo(tag);
      if (__syncthreads_and(have && halo_in)) return;
      if (r > kMaxPolls) __trap();
    }
  };

  // FIRE scalars, the same in every block.
  float dt = P.dt, alpha = P.alpha, cap = P.start_cap;
  int n_pos = 0;
  bool reset = false;

  // x0 into the tile and halo; the halo entries on the mesh, listed once
  // in box order; a0 = force(x0, prev, start_cap), v0 = 0.
  for (int l = threadIdx.x; l < tn; l += kThreads) {
    int z, y, xx, bi;
    if (!own(l, z, y, xx, bi)) continue;
    const int i = (z * gy + y) * gx + xx;
    for (int c = 0; c < D; ++c) xs[c * box + bi] = x_in[c * n + i];
  }
  for (int r = 0; r < box; r += kThreads) {
    const int hb = r + threadIdx.x;
    int word_at = 0;
    const int i = hb < box ? halo(hb, word_at) : -1;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const unsigned ball = __ballot_sync(kFull, i >= 0);
    if (lane == 0) wcount[wid] = __popc(ball);
    __syncthreads();
    int off = nh;
    for (int w = 0; w < kWarps; ++w) {
      if (w < wid) off += wcount[w];
      nh += wcount[w];
    }
    if (i >= 0) {
      const int k = off + __popc(ball & ((1u << lane) - 1u));
      hl[k] = hb;
      hi[k] = word_at;
      for (int c = 0; c < D; ++c) xs[c * box + hb] = x_in[c * n + i];
    }
    __syncthreads();
  }
  unsigned tag = 1;
  for (int l = threadIdx.x; l < tn; l += kThreads) {
    int z, y, xx, bi;
    if (!own(l, z, y, xx, bi)) continue;
    const int i = (z * gy + y) * gx + xx;
    float f[D];
    force(bi, z, y, xx, i, cap, f);
    for (int c = 0; c < D; ++c) {
      as[c * tn + l] = f[c];
      vs[c * tn + l] = 0.0f;
    }
    publish(tag, l, bi, z, y, xx);
  }
  start_halo(tag);

  int t = 0, chunk = 0, streak = 0;  // t: steps taken in this chunk
  for (;;) {
    const bool last = t == P.num_iters;
    wait(tag, tag == 1 ? 0 : last ? 3 : 1);
    if (tag > 1) {
      // The last step's power total: the FIRE scalars; at a chunk's end,
      // also the kinetic energy, v_max, the two-streak stop and the cap
      // ramp.
      fire_next(tot[0] < 0.0f, P, dt, alpha, cap, n_pos, reset);
      if (last) {
        t = 0;
        const bool uphill = tot[0] < 0.0f;
        const float e_kin = uphill ? 0.0f : tot[1];
        const float v_max = uphill ? 0.0f : sqrtf(tot[2]);
        if (blockIdx.x == 0 && threadIdx.x == 0) ehist[chunk] = e_kin;
        const bool conv = v_max < P.stop_v_max && cap >= P.final_cap;
        streak = conv ? streak + 1 : 0;
        if (v_max < P.stop_v_max && cap < P.final_cap)
          cap = fminf(cap * P.cap_scale, P.final_cap);
        ++chunk;
        if (streak >= 2 || chunk >= P.max_chunks) break;
      }
    }
    ++tag;
    double pw = 0.0, e = 0.0, m = 0.0;
    // Velocity-Verlet position update: own nodes and the halo.
    const float half_dt2 = 0.5f * dt * dt;
    for (int l = threadIdx.x; l < tn; l += kThreads) {
      int z, y, xx, bi;
      if (!own(l, z, y, xx, bi)) continue;
      for (int c = 0; c < D; ++c) {
        const float v = reset ? 0.0f : vs[c * tn + l];
        xs[c * box + bi] =
            advance(xs[c * box + bi], v, as[c * tn + l], dt, half_dt2);
      }
    }
    for (int k = threadIdx.x; k < nh; k += kThreads) {
      for (int c = 0; c < D; ++c) {
        const float v = reset ? 0.0f : hs[(D + c) * hn + k];
        xs[c * box + hl[k]] = advance(hs[c * hn + k], v,
                                      hs[(2 * D + c) * hn + k], dt,
                                      half_dt2);
      }
    }
    __syncthreads();

    // New force, Verlet velocity, FIRE power partial and mixing.
    const float d_in = 1.0f / (1.0f + 0.5f * dt * P.gamma);
    const float d_out = 1.0f - 0.5f * dt * P.gamma;
    for (int l = threadIdx.x; l < tn; l += kThreads) {
      int z, y, xx, bi;
      if (!own(l, z, y, xx, bi)) continue;
      const int i = (z * gy + y) * gx + xx;
      float f[D], vn[D];
      force(bi, z, y, xx, i, cap, f);
      float fv = 0.0f, ff = 0.0f, vv = 0.0f;
      for (int c = 0; c < D; ++c) {
        const float v = reset ? 0.0f : vs[c * tn + l];
        vn[c] = d_in * (v * d_out + 0.5f * dt * (as[c * tn + l] + f[c]));
        fv += f[c] * vn[c];
        ff += f[c] * f[c];
        vv += vn[c] * vn[c];
      }
      pw += fv;
      const float a_norm = sqrtf(ff) + 1e-6f;
      const float v_norm = sqrtf(vv);
      float vsq = 0.0f;
      for (int c = 0; c < D; ++c) {
        const float v = vn[c] + alpha * (f[c] / a_norm * v_norm - vn[c]);
        as[c * tn + l] = f[c];
        vs[c * tn + l] = v;
        vsq += v * v;
      }
      e += vsq;
      m = fmax(m, (double)vsq);
      publish(tag, l, bi, z, y, xx);
    }
    reduce(tag, pw, e, m, ++t == P.num_iters ? 3 : 1);
    start_halo(tag);
  }

  for (int l = threadIdx.x; l < tn; l += kThreads) {
    int z, y, xx, bi;
    if (!own(l, z, y, xx, bi)) continue;
    const int i = (z * gy + y) * gx + xx;
    for (int c = 0; c < D; ++c) x_out[c * n + i] = xs[c * box + bi];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) steps[0] = chunk * P.num_iters;
}

// The second route: x: [D, nz, gy, gx] relaxed in place (nz = 1 in 2d);
// prev: the same shape or NULL; v, a: the same shape, scratch; part:
// [3 * gridDim.x] doubles (power, kinetic energy, max |v|^2 per block);
// ehist: [max_chunks]; steps: [1]. The same step as fused_fire_kernel's:
// force2d_node / force3d_node on x in device memory, the same FIRE
// expressions, and the same `advance`.
template <int D, bool kPrefer>
__global__ void __launch_bounds__(kThreads)
grid_fire_kernel(float* x, const float* __restrict__ prev, float* v,
                 float* a, double* part, float* __restrict__ ehist,
                 int* __restrict__ steps, int nz, int gy, int gx,
                 FireParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[kWarps];
  const int n = nz * gy * gx;
  const int nb = gridDim.x;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = nb * kThreads;

  // Node i's spring force and capped k0 spring. x is written by other
  // blocks between barriers, so it is read through plain loads (never the
  // read-only path).
  const auto force = [&](int i, float cap, float f[D]) {
    const int xx = i % gx, y = i / gx % gy;
    if constexpr (D == 2) {
      const sofima::Springs2d S = {P.k, P.k_diag, P.stride_x, P.stride_y};
      const auto at = [&](int c, int ey, int ex) {
        return x[c * n + i + ey * gx + ex];
      };
      sofima::force2d_node(at, gy, gx, y, xx, S, kPrefer, f);
    } else {
      const auto at = [&](int c, int ez, int ey, int ex) {
        return x[c * n + i + (ez * gy + ey) * gx + ex];
      };
      sofima::force3d_node(at, nz, gy, gx, i / (gx * gy), y, xx, P.links,
                           kPrefer, f);
    }
    if (P.has_prev) {
      for (int c = 0; c < D; ++c) {
        const float s = -P.k0 * nan_to_num(x[c * n + i] -
                                           __ldg(prev + c * n + i));
        f[c] += fminf(fmaxf(s, -cap), cap);
      }
    }
  };
  // The grid total of part row c, the same in every block: each block
  // sums all partials in one fixed order.
  const auto total = [&](int c) {
    double t = 0.0;
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      const double p = __ldcg(part + c * nb + b);
      t = c == 2 ? fmax(t, p) : t + p;
    }
    return block_total(t, c, red);
  };

  float dt = P.dt, alpha = P.alpha, cap = P.start_cap;
  int n_pos = 0;
  bool reset = false;
  for (int i = first; i < n; i += stride) {
    float f[D];
    force(i, cap, f);
    for (int c = 0; c < D; ++c) {
      a[c * n + i] = f[c];
      v[c * n + i] = 0.0f;
    }
  }
  grid.sync();  // a0 reads neighbours' x, which the first update moves

  int chunk = 0, streak = 0;
  for (;;) {
    float e_kin = 0.0f, v_max = 0.0f;
    for (int t = 0; t < P.num_iters; ++t) {
      // Velocity-Verlet position update.
      const float half_dt2 = 0.5f * dt * dt;
      for (int i = first; i < n; i += stride) {
        for (int c = 0; c < D; ++c) {
          const float vi = reset ? 0.0f : v[c * n + i];
          x[c * n + i] = advance(x[c * n + i], vi, a[c * n + i], dt,
                                 half_dt2);
        }
      }
      grid.sync();

      // New force, Verlet velocity, FIRE power partial and mixing.
      const float d_in = 1.0f / (1.0f + 0.5f * dt * P.gamma);
      const float d_out = 1.0f - 0.5f * dt * P.gamma;
      const bool last = t + 1 == P.num_iters;
      double pw = 0.0, e = 0.0, m = 0.0;
      for (int i = first; i < n; i += stride) {
        float f[D], vn[D];
        force(i, cap, f);
        float fv = 0.0f, ff = 0.0f, vv = 0.0f;
        for (int c = 0; c < D; ++c) {
          const float vi = reset ? 0.0f : v[c * n + i];
          vn[c] = d_in * (vi * d_out + 0.5f * dt * (a[c * n + i] + f[c]));
          fv += f[c] * vn[c];
          ff += f[c] * f[c];
          vv += vn[c] * vn[c];
        }
        pw += fv;
        const float a_norm = sqrtf(ff) + 1e-6f;
        const float v_norm = sqrtf(vv);
        float vsq = 0.0f;
        for (int c = 0; c < D; ++c) {
          const float vm = vn[c] + alpha * (f[c] / a_norm * v_norm - vn[c]);
          a[c * n + i] = f[c];
          v[c * n + i] = vm;
          vsq += vm * vm;
        }
        e += vsq;
        m = fmax(m, (double)vsq);
      }
      for (int c = 0; c < (last ? 3 : 1); ++c) {
        const double bt = block_total(c == 0 ? pw : c == 1 ? e : m, c, red);
        if (threadIdx.x == 0) part[c * nb + blockIdx.x] = bt;
      }
      grid.sync();
      const float power = (float)total(0);
      fire_next(power < 0.0f, P, dt, alpha, cap, n_pos, reset);
      if (last && !reset) {
        e_kin = (float)total(1);
        v_max = sqrtf((float)total(2));
      }
    }
    // Chunk boundary: kinetic energy, v_max, two-streak stop, cap ramp.
    if (blockIdx.x == 0 && threadIdx.x == 0) ehist[chunk] = e_kin;
    const bool conv = v_max < P.stop_v_max && cap >= P.final_cap;
    streak = conv ? streak + 1 : 0;
    if (v_max < P.stop_v_max && cap < P.final_cap)
      cap = fminf(cap * P.cap_scale, P.final_cap);
    ++chunk;
    if (streak >= 2 || chunk >= P.max_chunks) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) steps[0] = chunk * P.num_iters;
}

const void* grid_kernel_of(int dim, int prefer) {
  if (dim == 3)
    return prefer ? (const void*)grid_fire_kernel<3, true>
                  : (const void*)grid_fire_kernel<3, false>;
  return prefer ? (const void*)grid_fire_kernel<2, true>
                : (const void*)grid_fire_kernel<2, false>;
}

const void* kernel_of(int dim, int prefer) {
  if (dim == 3)
    return prefer ? (const void*)fused_fire_kernel<3, true>
                  : (const void*)fused_fire_kernel<3, false>;
  return prefer ? (const void*)fused_fire_kernel<2, true>
                : (const void*)fused_fire_kernel<2, false>;
}

FireParams make_params(int dim, float dt, float gamma, float k0, float k,
                       float k_diag, float stride_x, float stride_y,
                       int num_iters, int max_chunks, float stop_v_max,
                       float f_alpha, float f_inc, float f_dec, float alpha,
                       int n_min, float dt_cap, float start_cap,
                       float final_cap, float cap_scale,
                       int cap_upscale_every, int prefer_orig_order,
                       bool has_prev, const float* table) {
  FireParams P = {};
  P.dt = dt; P.gamma = gamma; P.k0 = k0; P.k = k; P.k_diag = k_diag;
  P.stride_x = stride_x; P.stride_y = stride_y;
  P.f_alpha = f_alpha; P.f_inc = f_inc; P.f_dec = f_dec; P.alpha = alpha;
  P.dt_cap = dt_cap; P.start_cap = start_cap; P.final_cap = final_cap;
  P.cap_scale = cap_scale; P.stop_v_max = stop_v_max;
  P.num_iters = num_iters; P.max_chunks = max_chunks; P.n_min = n_min;
  P.cap_upscale_every = cap_upscale_every;
  P.prefer_orig_order = prefer_orig_order;
  P.has_prev = has_prev;
  if (dim == 3) {
    for (int l = 0; l < sofima::kLinks3d; ++l) {
      P.links.l0v[l][0] = table[5 * l];
      P.links.l0v[l][1] = table[5 * l + 1];
      P.links.l0v[l][2] = table[5 * l + 2];
      P.links.l0[l] = table[5 * l + 3];
      P.links.k_eff[l] = table[5 * l + 4];
    }
  }
  return P;
}

}  // namespace

extern "C" {

// Co-resident blocks of the `dim`-d kernel (with or without
// prefer_orig_order) on the whole card at `smem` bytes of dynamic shared
// memory per block (0 on error or without cooperative launch).
int fused_fire_max_blocks(int device, int dim, int prefer, int smem) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) !=
          cudaSuccess ||
      !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  const void* fn = kernel_of(dim, prefer);
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// x: [dim, nz, gy, gx] (nz = 1 for dim 2) read; out: the same shape,
// written; prev: the same shape or NULL; pub: [2 * nblocks * 3 * dim *
// nf] (cuda_mesh.fire_pub_words) and slots: [2 * (3 * nblocks + 3)]
// 64-bit words, zeroed by the caller (nblocks <= 512); ehist:
// [max_chunks] (pre-filled with NaN by the caller); steps: [1].
// The tiling (tz, ty = 2^sy, tx = 2^sx; ntz, nty, ntx tiles, one block
// each) and the dynamic shared memory `smem` come from
// cuda_mesh.fire_plan. table: host float[26 * 5] per-link constants (l0x,
// l0y, l0z, l0, k_eff) for dim 3, NULL for dim 2. Returns the launch's
// cudaError_t.
int fused_fire_launch(int dim, const float* x, float* out, const float* prev,
                      unsigned long long* pub, unsigned long long* slots,
                      float* ehist,
                      int* steps, int nz, int gy, int gx,
                      int tz, int sy, int sx, int ntz, int nty, int ntx,
                      int smem, float dt, float gamma, float k0, float k,
                      float k_diag, float stride_x, float stride_y,
                      int num_iters, int max_chunks, float stop_v_max,
                      float f_alpha, float f_inc, float f_dec, float alpha,
                      int n_min, float dt_cap, float start_cap,
                      float final_cap, float cap_scale,
                      int cap_upscale_every, int prefer_orig_order,
                      const float* table, void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dim == 3 && table == nullptr) return (int)cudaErrorInvalidValue;
  if ((tz << (sy + sx)) % kThreads != 0 || ntz * nty * ntx > kMaxBlocks)
    return (int)cudaErrorInvalidValue;
  const FireParams P = make_params(
      dim, dt, gamma, k0, k, k_diag, stride_x, stride_y, num_iters,
      max_chunks, stop_v_max, f_alpha, f_inc, f_dec, alpha, n_min, dt_cap,
      start_cap, final_cap, cap_scale, cap_upscale_every, prefer_orig_order,
      prev != nullptr, table);
  Tiling T = {tz, 1 << sy, 1 << sx, sy, sx, ntz, nty, ntx};
  void* args[] = {&x,  &out, &prev, &pub, &slots, &ehist, &steps,
                  &nz, &gy,  &gx,   &T,   (void*)&P};
  const void* fn = kernel_of(dim, prefer_orig_order);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchCooperativeKernel(fn, dim3(ntz * nty * ntx),
                                    dim3(kThreads), args, (size_t)smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The second route's co-resident blocks on the whole card (0 on error or
// without cooperative launch).
int grid_fire_max_blocks(int device, int dim, int prefer) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) !=
          cudaSuccess ||
      !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, grid_kernel_of(dim, prefer), kThreads, 0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// The second route. x: [dim, nz, gy, gx] relaxed in place; prev: the same
// shape or NULL; v, a: the same shape, scratch; part: [3 * nblocks]
// doubles; ehist: [max_chunks] (pre-filled with NaN by the caller);
// steps: [1]; nblocks <= grid_fire_max_blocks. The scalars and `table`
// as fused_fire_launch's. Returns the launch's cudaError_t.
int grid_fire_launch(int dim, float* x, const float* prev, float* v, float* a,
                     double* part, float* ehist, int* steps, int nz, int gy,
                     int gx, int nblocks, float dt, float gamma, float k0,
                     float k, float k_diag, float stride_x, float stride_y,
                     int num_iters, int max_chunks, float stop_v_max,
                     float f_alpha, float f_inc, float f_dec, float alpha,
                     int n_min, float dt_cap, float start_cap,
                     float final_cap, float cap_scale, int cap_upscale_every,
                     int prefer_orig_order, const float* table,
                     void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dim == 3 && table == nullptr) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaErrorInvalidValue;
  const FireParams P = make_params(
      dim, dt, gamma, k0, k, k_diag, stride_x, stride_y, num_iters,
      max_chunks, stop_v_max, f_alpha, f_inc, f_dec, alpha, n_min, dt_cap,
      start_cap, final_cap, cap_scale, cap_upscale_every, prefer_orig_order,
      prev != nullptr, table);
  void* args[] = {&x,     &prev,  &v,  &a,  &part, &ehist,
                  &steps, &nz,    &gy, &gx, (void*)&P};
  cudaError_t err = cudaLaunchCooperativeKernel(
      grid_kernel_of(dim, prefer_orig_order), dim3(nblocks), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
