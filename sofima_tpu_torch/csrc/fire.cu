// Fused FIRE mesh relaxation: the whole chunked convergence loop of
// mesh.relax_mesh_fused in ONE cooperative kernel launch.
//
// Replaces sofima_tpu/ops/pallas_mesh.py `_fused_fire_kernel` (entry
// relax_mesh_fused_pallas) with `_roll_force_2d`: 8-neighbour Hooke
// springs (diagonals at k/sqrt(2)), prefer_orig_order, NaN-inert nodes,
// zero-length k0 springs to `prev` clamped by the force cap, cap
// escalation, and the stop test "two consecutive converged chunks".
//
// What bounds it on the H100: latency, not bytes or FLOPs. A section's
// mesh is ~250^2 nodes (x, v, a, prev: ~2 MB, L2-resident), and every
// FIRE step needs one global reduction (the power sum a.v) before any
// node may take the next step. A launch per step would pay ~5 us of
// launch latency thousands of times per solve. Here one cooperative
// launch keeps the state in device memory and separates the phases with
// grid-wide barriers: two per step (after the position update, and
// after the per-block power partials are written) plus one per chunk
// (kinetic energy and v_max). Block partials are summed by every block
// in the same fixed order, so all blocks agree on the FIRE scalars (dt,
// alpha, n_pos, cap) without atomics and a run repeats bit for bit. The
// grid is sized from the occupancy API so that every block is resident,
// as a grid barrier requires; larger meshes loop over nodes per thread,
// so there is no size limit (the Pallas kernel's VMEM bound is gone).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

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
};

// jnp.sign: -1, 0 or 1 (copysignf would give +-1 at zero).
__device__ __forceinline__ float sign0(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// In-plane spring force on node (y, x) plus the capped k0 spring to prev.
__device__ void node_force(const float* __restrict__ x, const float* __restrict__ prev,
                           int gy, int gx, int y, int xx, float cap,
                           const FireParams& P, float* f0, float* f1) {
  const int n = gy * gx;
  const int i = y * gx + xx;
  const float x0 = x[i], x1 = x[n + i];
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int ey = -1; ey <= 1; ++ey) {
    for (int ex = -1; ex <= 1; ++ex) {
      if (ex == 0 && ey == 0) continue;
      const int ny = y + ey, nx = xx + ex;
      // Outside the grid behaves like the NaN guard ring: no spring.
      if (ny < 0 || ny >= gy || nx < 0 || nx >= gx) continue;
      const int j = ny * gx + nx;
      const float l0x = P.stride_x * ex, l0y = P.stride_y * ey;
      const float l0 = sqrtf(l0x * l0x + l0y * l0y);
      const float k_eff = (ex == 0 || ey == 0) ? P.k : P.k_diag;
      const float d0 = x[j] - x0 + l0x;
      const float d1 = x[n + j] - x1 + l0y;
      const float dd = d0 * d0 + d1 * d1;
      const float inv_l = rsqrtf(fmaxf(dd, 0.0f));
      float g0, g1;
      if (P.prefer_orig_order) {
        const float fac0 = ex != 0 ? (float)ex * sign0(d0) : 1.0f;
        const float fac1 = ey != 0 ? (float)ey * sign0(d1) : 1.0f;
        g0 = k_eff * (1.0f - l0 * fac0 * inv_l) * d0;
        g1 = k_eff * (1.0f - l0 * fac1 * inv_l) * d1;
      } else {
        const float coef = k_eff * (1.0f - l0 * inv_l);
        g0 = coef * d0;
        g1 = coef * d1;
      }
      if (isfinite(dd)) {
        acc0 += g0;
        acc1 += g1;
      }
    }
  }
  if (P.has_prev) {
    const float c0 = -P.k0 * nan_to_num(x0 - prev[i]);
    const float c1 = -P.k0 * nan_to_num(x1 - prev[n + i]);
    acc0 += fminf(fmaxf(c0, -cap), cap);
    acc1 += fminf(fmaxf(c1, -cap), cap);
  }
  *f0 = acc0;
  *f1 = acc1;
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

__global__ void __launch_bounds__(kThreads)
fused_fire_kernel(float* __restrict__ x, const float* __restrict__ prev,
                  float* __restrict__ v, float* __restrict__ a,
                  float* __restrict__ part, float* __restrict__ ehist,
                  int* __restrict__ steps, int gy, int gx, FireParams P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[32];
  __shared__ float bcast;
  const int n = gy * gx;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;
  float* part_p = part;                  // power
  float* part_e = part + gridDim.x;      // kinetic energy
  float* part_m = part + 2 * gridDim.x;  // max |v|^2

  float dt = P.dt, alpha = P.alpha, cap = P.start_cap;
  int n_pos = 0;

  // a0 = force(x, prev, start_cap); v0 = 0.
  for (int i = gtid; i < n; i += gsize) {
    float f0, f1;
    node_force(x, prev, gy, gx, i / gx, i % gx, cap, P, &f0, &f1);
    a[i] = f0;
    a[n + i] = f1;
    v[i] = 0.0f;
    v[n + i] = 0.0f;
  }

  int chunk = 0, streak = 0;
  while (streak < 2 && chunk < P.max_chunks) {
    for (int t = 0; t < P.num_iters; ++t) {
      // Velocity-Verlet position update (own nodes only).
      const float half_dt2 = 0.5f * dt * dt;
      for (int i = gtid; i < n; i += gsize) {
        x[i] = x[i] + dt * v[i] + half_dt2 * a[i];
        x[n + i] = x[n + i] + dt * v[n + i] + half_dt2 * a[n + i];
      }
      grid.sync();

      // New force, Verlet velocity, FIRE power partial and mixing.
      const float d_in = 1.0f / (1.0f + 0.5f * dt * P.gamma);
      const float d_out = 1.0f - 0.5f * dt * P.gamma;
      float pw = 0.0f;
      for (int i = gtid; i < n; i += gsize) {
        float f0, f1;
        node_force(x, prev, gy, gx, i / gx, i % gx, cap, P, &f0, &f1);
        float v0 = d_in * (v[i] * d_out + 0.5f * dt * (a[i] + f0));
        float v1 = d_in * (v[n + i] * d_out + 0.5f * dt * (a[n + i] + f1));
        pw += f0 * v0 + f1 * v1;
        const float a_norm = sqrtf(f0 * f0 + f1 * f1) + 1e-6f;
        const float v_norm = sqrtf(v0 * v0 + v1 * v1);
        v0 = v0 + alpha * (f0 / a_norm * v_norm - v0);
        v1 = v1 + alpha * (f1 / a_norm * v_norm - v1);
        a[i] = f0;
        a[n + i] = f1;
        v[i] = v0;
        v[n + i] = v1;
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
          v[i] = 0.0f;
          v[n + i] = 0.0f;
        }
      }
    }

    // Chunk boundary: kinetic energy, v_max, two-streak stop, cap ramp.
    float e = 0.0f, m = 0.0f;
    for (int i = gtid; i < n; i += gsize) {
      const float vs = v[i] * v[i] + v[n + i] * v[n + i];
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

// Largest co-resident grid for the cooperative launch (0 on error).
int fused_fire_max_blocks(int device) {
  int per_sm = 0, sms = 0, coop = 0;
  if (cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device) !=
          cudaSuccess || !coop)
    return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_fire_kernel,
                                                    kThreads, 0) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// x: [2, gy, gx] relaxed in place; prev: [2, gy, gx] or NULL; v, a:
// [2, gy, gx] scratch; part: [3 * nblocks]; ehist: [max_chunks] (pre-filled
// with NaN by the caller); steps: [1]. Returns cudaGetLastError().
int fused_fire_launch(float* x, const float* prev, float* v, float* a,
                      float* part, float* ehist, int* steps, int gy, int gx,
                      int nblocks, float dt, float gamma, float k0, float k, float k_diag,
                      float stride_x, float stride_y, int num_iters,
                      int max_chunks, float stop_v_max, float f_alpha,
                      float f_inc, float f_dec, float alpha, int n_min,
                      float dt_cap, float start_cap, float final_cap,
                      float cap_scale, int cap_upscale_every,
                      int prefer_orig_order, void* stream) {
  FireParams P;
  P.dt = dt; P.gamma = gamma; P.k0 = k0; P.k = k; P.k_diag = k_diag;
  P.stride_x = stride_x; P.stride_y = stride_y;
  P.f_alpha = f_alpha; P.f_inc = f_inc; P.f_dec = f_dec; P.alpha = alpha;
  P.dt_cap = dt_cap; P.start_cap = start_cap; P.final_cap = final_cap;
  P.cap_scale = cap_scale; P.stop_v_max = stop_v_max;
  P.num_iters = num_iters; P.max_chunks = max_chunks; P.n_min = n_min;
  P.cap_upscale_every = cap_upscale_every;
  P.prefer_orig_order = prefer_orig_order;
  P.has_prev = prev != nullptr;
  void* args[] = {&x, &prev, &v, &a, &part, &ehist, &steps, &gy, &gx, &P};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)fused_fire_kernel, dim3(nblocks), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
