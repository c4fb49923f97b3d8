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
// force of K9 (mesh3d.cuh). One loop body serves both, templated on the dimension:
// prefer_orig_order, NaN-inert nodes, zero-length k0 springs to `prev`
// clamped by the force cap, cap escalation, and the stop test "two
// consecutive converged chunks". The 3d kernel's `link_loop`,
// `symmetric` and `guard` variants are Mosaic workarounds with the same
// result; nodes outside the grid simply carry no spring here.
//
// What bounds it on the H100: latency, not bytes or FLOPs. A section's
// mesh is ~250^2 nodes and a LICONN tile mesh 8 x 128 x 256 (x, v, a,
// prev: 2-13 MB, L2-resident), and every FIRE step needs one global
// reduction (the power sum a.v) before any node may take the next step.
// A launch per step would pay ~5 us of launch latency thousands of times
// per solve. Here one cooperative launch keeps the state in device
// memory and separates the phases with grid-wide barriers: two per step
// (after the position update, and after the per-block power partials are
// written), one per chunk (kinetic energy and v_max) and one after the
// initial force, before any node moves. Block partials
// are summed by every block in the same fixed order, so all blocks agree
// on the FIRE scalars (dt, alpha, n_pos, cap) without atomics and a run
// repeats bit for bit. The grid is sized from the occupancy API so that
// every block is resident, as a grid barrier requires; larger meshes
// loop over nodes per thread, so there is no size limit (the Pallas
// kernels' VMEM bound is gone).

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
constexpr unsigned kFull = 0xffffffffu;

struct FireParams {
  float dt, gamma, k0, k, k_diag, stride_x, stride_y;
  float f_alpha, f_inc, f_dec, alpha, dt_cap;
  float start_cap, final_cap, cap_scale, stop_v_max;
  int num_iters, max_chunks, n_min, cap_upscale_every;
  int prefer_orig_order, has_prev;
  sofima::Links3d links;  // 3d only
};

// jnp.nan_to_num: NaN -> 0, +-inf -> +-FLT_MAX.
__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// Spring force plus the capped k0 spring to prev on node i of a
// [D, nz, gy, gx] mesh (nz = 1 in 2d).
template <int D>
__device__ __forceinline__ void node_force(const float* __restrict__ x,
                                           const float* __restrict__ prev,
                                           int nz, int gy, int gx, int i,
                                           float cap, const FireParams& P,
                                           float f[D]) {
  const int n = nz * gy * gx;
  const int xx = i % gx;
  const int y = (i / gx) % gy;
  if constexpr (D == 2) {
    const sofima::Springs2d S = {P.k, P.k_diag, P.stride_x, P.stride_y};
    sofima::force2d_node(x, n, gy, gx, y, xx, S, P.prefer_orig_order != 0,
                         f);
  } else {
    sofima::force3d_node(x, n, nz, gy, gx, i / (gx * gy), y, xx, P.links,
                         P.prefer_orig_order != 0, f);
  }
  if (P.has_prev) {
    for (int c = 0; c < D; ++c) {
      const float s = -P.k0 * nan_to_num(x[c * n + i] - prev[c * n + i]);
      f[c] += fminf(fmaxf(s, -cap), cap);
    }
  }
}

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block partial of `v` into part[blockIdx.x] (fixed order).
template <bool kMax>
__device__ void block_partial(float v, float* red, float* part) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;  // |v|^2 >= 0
    v = kMax ? warp_max(v) : warp_sum(v);
    if (lane == 0) part[blockIdx.x] = v;
  }
}

// Total over all block partials, the same value in every block.
template <bool kMax>
__device__ float grid_total(const float* part, float* bcast) {
  if (threadIdx.x < 32) {
    float v = 0.0f;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += 32)
      v = kMax ? fmaxf(v, part[b]) : v + part[b];
    v = kMax ? warp_max(v) : warp_sum(v);
    if (threadIdx.x == 0) *bcast = v;
  }
  __syncthreads();
  const float r = *bcast;
  __syncthreads();
  return r;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_fire_kernel(float* __restrict__ x, const float* __restrict__ prev,
                  float* __restrict__ v, float* __restrict__ a,
                  float* __restrict__ part, float* __restrict__ ehist,
                  int* __restrict__ steps, int nz, int gy, int gx,
                  FireParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[32];
  __shared__ float bcast;
  const int n = nz * gy * gx;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;
  float* part_p = part;                  // power
  float* part_e = part + gridDim.x;      // kinetic energy
  float* part_m = part + 2 * gridDim.x;  // max |v|^2

  float dt = P.dt, alpha = P.alpha, cap = P.start_cap;
  int n_pos = 0;

  // a0 = force(x, prev, start_cap); v0 = 0.
  for (int i = gtid; i < n; i += gsize) {
    float f[D];
    node_force<D>(x, prev, nz, gy, gx, i, cap, P, f);
    for (int c = 0; c < D; ++c) {
      a[c * n + i] = f[c];
      v[c * n + i] = 0.0f;
    }
  }
  // a0 reads neighbours' x, which the first position update rewrites.
  grid.sync();

  int chunk = 0, streak = 0;
  while (streak < 2 && chunk < P.max_chunks) {
    for (int t = 0; t < P.num_iters; ++t) {
      // Velocity-Verlet position update (own nodes only).
      const float half_dt2 = 0.5f * dt * dt;
      for (int i = gtid; i < n; i += gsize) {
        for (int c = 0; c < D; ++c)
          x[c * n + i] = x[c * n + i] + dt * v[c * n + i] +
                         half_dt2 * a[c * n + i];
      }
      grid.sync();

      // New force, Verlet velocity, FIRE power partial and mixing.
      const float d_in = 1.0f / (1.0f + 0.5f * dt * P.gamma);
      const float d_out = 1.0f - 0.5f * dt * P.gamma;
      float pw = 0.0f;
      for (int i = gtid; i < n; i += gsize) {
        float f[D], vn[D];
        node_force<D>(x, prev, nz, gy, gx, i, cap, P, f);
        float fv = 0.0f, ff = 0.0f, vv = 0.0f;
        for (int c = 0; c < D; ++c) {
          vn[c] = d_in * (v[c * n + i] * d_out + 0.5f * dt * (a[c * n + i] +
                                                               f[c]));
          fv += f[c] * vn[c];
          ff += f[c] * f[c];
          vv += vn[c] * vn[c];
        }
        pw += fv;
        const float a_norm = sqrtf(ff) + 1e-6f;
        const float v_norm = sqrtf(vv);
        for (int c = 0; c < D; ++c) {
          a[c * n + i] = f[c];
          v[c * n + i] = vn[c] + alpha * (f[c] / a_norm * v_norm - vn[c]);
        }
      }
      block_partial<false>(pw, red, part_p);
      grid.sync();

      // FIRE scalars, identical in every block.
      const float power = grid_total<false>(part_p, &bcast);
      const bool uphill = power < 0.0f;
      n_pos = uphill ? 0 : n_pos + 1;
      const bool grow = !uphill && n_pos > P.n_min;
      dt = uphill ? dt * P.f_dec : (grow ? fminf(dt * P.f_inc, P.dt_cap) : dt);
      alpha = uphill ? P.alpha : (grow ? alpha * P.f_alpha : alpha);
      const bool up_cap = !uphill && n_pos > 0 &&
                          (n_pos % P.cap_upscale_every) == 0;
      cap = fminf(up_cap ? P.cap_scale * cap : cap, P.final_cap);
      if (uphill) {
        for (int i = gtid; i < n; i += gsize) {
          for (int c = 0; c < D; ++c) v[c * n + i] = 0.0f;
        }
      }
    }

    // Chunk boundary: kinetic energy, v_max, two-streak stop, cap ramp.
    float e = 0.0f, m = 0.0f;
    for (int i = gtid; i < n; i += gsize) {
      float vs = 0.0f;
      for (int c = 0; c < D; ++c) vs += v[c * n + i] * v[c * n + i];
      e += vs;
      m = fmaxf(m, vs);
    }
    block_partial<false>(e, red, part_e);
    block_partial<true>(m, red, part_m);
    grid.sync();
    const float e_kin = grid_total<false>(part_e, &bcast);
    const float v_max = sqrtf(grid_total<true>(part_m, &bcast));
    if (blockIdx.x == 0 && threadIdx.x == 0) ehist[chunk] = e_kin;
    const bool conv = v_max < P.stop_v_max && cap >= P.final_cap;
    streak = conv ? streak + 1 : 0;
    if (v_max < P.stop_v_max && cap < P.final_cap)
      cap = fminf(cap * P.cap_scale, P.final_cap);
    ++chunk;
    // part_e / part_m are rewritten only a full chunk later, after many
    // barriers, so no extra barrier is needed before the next chunk.
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) steps[0] = chunk * P.num_iters;
}

}  // namespace

extern "C" {

int fused_fire_threads() { return kThreads; }

// Largest co-resident grid for the cooperative launch of the `dim`-d
// kernel (0 on error).
int fused_fire_max_blocks(int device, int dim) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) !=
          cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  const void* fn = dim == 3 ? (const void*)fused_fire_kernel<3>
                            : (const void*)fused_fire_kernel<2>;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// x: [dim, nz, gy, gx] relaxed in place (nz = 1 for dim 2); prev: the same
// shape or NULL; v, a: the same shape, scratch; part: [3 * nblocks];
// ehist: [max_chunks] (pre-filled with NaN by the caller); steps: [1].
// table: host float[26 * 5] per-link constants (l0x, l0y, l0z, l0, k_eff)
// for dim 3, NULL for dim 2. Returns the launch's cudaError_t.
int fused_fire_launch(int dim, float* x, const float* prev, float* v,
                      float* a, float* part, float* ehist, int* steps, int nz,
                      int gy, int gx, int nblocks, float dt, float gamma,
                      float k0, float k, float k_diag, float stride_x,
                      float stride_y, int num_iters, int max_chunks,
                      float stop_v_max, float f_alpha, float f_inc,
                      float f_dec, float alpha, int n_min, float dt_cap,
                      float start_cap, float final_cap, float cap_scale,
                      int cap_upscale_every, int prefer_orig_order,
                      const float* table, void* stream) {
  if (dim != 2 && dim != 3) return (int)cudaErrorInvalidValue;
  if (dim == 3 && table == nullptr) return (int)cudaErrorInvalidValue;
  FireParams P = {};
  P.dt = dt; P.gamma = gamma; P.k0 = k0; P.k = k; P.k_diag = k_diag;
  P.stride_x = stride_x; P.stride_y = stride_y;
  P.f_alpha = f_alpha; P.f_inc = f_inc; P.f_dec = f_dec; P.alpha = alpha;
  P.dt_cap = dt_cap; P.start_cap = start_cap; P.final_cap = final_cap;
  P.cap_scale = cap_scale; P.stop_v_max = stop_v_max;
  P.num_iters = num_iters; P.max_chunks = max_chunks; P.n_min = n_min;
  P.cap_upscale_every = cap_upscale_every;
  P.prefer_orig_order = prefer_orig_order;
  P.has_prev = prev != nullptr;
  if (dim == 3) {
    for (int l = 0; l < sofima::kLinks3d; ++l) {
      P.links.l0v[l][0] = table[5 * l];
      P.links.l0v[l][1] = table[5 * l + 1];
      P.links.l0v[l][2] = table[5 * l + 2];
      P.links.l0[l] = table[5 * l + 3];
      P.links.k_eff[l] = table[5 * l + 4];
    }
  }
  void* args[] = {&x, &prev, &v, &a, &part, &ehist, &steps, &nz, &gy, &gx,
                  &P};
  const void* fn = dim == 3 ? (const void*)fused_fire_kernel<3>
                            : (const void*)fused_fire_kernel<2>;
  cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(nblocks), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
