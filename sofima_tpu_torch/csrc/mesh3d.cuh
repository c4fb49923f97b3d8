// The 26-neighbour spring force of a 3d mesh node, shared by the force
// kernel (force3d.cu, K9) and the fused 3d FIRE solver (fire.cu, K11).
//
// Node positions are relative, [3, nz, ny, nx] per mesh (channels x, y, z):
// node (z, y, x) sits at its grid position times the stride plus its value.
// For a neighbour at offset e the link vector is
//   d = x[node + e] - x[node] + l0v(e),  l0v(e) = stride * e,
// and the force on the node is k_eff (1 - l0 / |d|) d, with
// k_eff = k * stride_x / l0 per link family, or with prefer_orig_order the
// per-component factor l0 * e_c sign(d_c) / |d| (1 where e_c = 0) in
// place of l0 / |d|. Neighbours outside the grid carry no spring.
//
// NaN convention of mesh._spring_force (the XLA stencil): each link force
// component is nan_to_num'ed to 0 (NaN and +-inf alike). The Pallas
// bodies (pallas_mesh._roll_force_3d) instead skip a link whose d.d is
// not finite; the two agree wherever no node is infinite and no two nodes
// coincide, which no path produces.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sofima {

constexpr int kLinks3d = 26;

// Per-link constants in (ez, ey, ex) loop order over {-1, 0, 1}^3 minus
// the centre, as computed on the host from the stride and k.
struct Links3d {
  float l0v[kLinks3d][3];  // stride * e (x, y, z)
  float l0[kLinks3d];      // |l0v|
  float k_eff[kLinks3d];   // k * stride_x / l0
};

// jnp.sign: -1, 0 or 1 (copysignf would give +-1 at zero).
__device__ __forceinline__ float sign0(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// jnp.nan_to_num(v, posinf=0, neginf=0).
__device__ __forceinline__ float finite_or_zero(float v) {
  return isfinite(v) ? v : 0.0f;
}

// Force on node (z, y, xx) of an nz x ny x nx mesh. `at(c, ez, ey, ex)`
// reads channel c of the node at offset (ez, ey, ex) from it, (0, 0, 0)
// being the node itself; it is called only for nodes inside the mesh.
template <class At>
__device__ __forceinline__ void force3d_node(const At& at, int nz, int ny,
                                             int nx, int z, int y, int xx,
                                             const Links3d& L, bool prefer,
                                             float f[3]) {
  const float c0 = at(0, 0, 0, 0), c1 = at(1, 0, 0, 0), c2 = at(2, 0, 0, 0);
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  int li = 0;
  for (int ez = -1; ez <= 1; ++ez) {
    for (int ey = -1; ey <= 1; ++ey) {
      for (int ex = -1; ex <= 1; ++ex) {
        if (ex == 0 && ey == 0 && ez == 0) continue;
        const int l = li++;
        const int qz = z + ez, qy = y + ey, qx = xx + ex;
        if (qz < 0 || qz >= nz || qy < 0 || qy >= ny || qx < 0 || qx >= nx)
          continue;
        const float d0 = at(0, ez, ey, ex) - c0 + L.l0v[l][0];
        const float d1 = at(1, ez, ey, ex) - c1 + L.l0v[l][1];
        const float d2 = at(2, ez, ey, ex) - c2 + L.l0v[l][2];
        const float dd = d0 * d0 + d1 * d1 + d2 * d2;
        const float l0 = L.l0[l], k = L.k_eff[l];
        // 1/|d| as rsqrt: inf at d = 0 and 0 at |d| = inf, so every
        // degenerate link still ends in a non-finite value that
        // finite_or_zero drops, as l0 / sqrt(d.d) would.
        const float inv_len = rsqrtf(dd);
        float g0, g1, g2;
        if (prefer) {
          const float f0 = ex != 0 ? (float)ex * sign0(d0) : 1.0f;
          const float f1 = ey != 0 ? (float)ey * sign0(d1) : 1.0f;
          const float f2 = ez != 0 ? (float)ez * sign0(d2) : 1.0f;
          g0 = k * (1.0f - l0 * f0 * inv_len) * d0;
          g1 = k * (1.0f - l0 * f1 * inv_len) * d1;
          g2 = k * (1.0f - l0 * f2 * inv_len) * d2;
        } else {
          const float coef = k * (1.0f - l0 * inv_len);
          g0 = coef * d0;
          g1 = coef * d1;
          g2 = coef * d2;
        }
        acc0 += finite_or_zero(g0);
        acc1 += finite_or_zero(g1);
        acc2 += finite_or_zero(g2);
      }
    }
  }
  f[0] = acc0;
  f[1] = acc1;
  f[2] = acc2;
}

// The same on a mesh in global memory: `x` points at its channel 0 and
// channels are `cs` floats apart.
__device__ __forceinline__ void force3d_node(const float* __restrict__ x,
                                             int64_t cs, int nz, int ny,
                                             int nx, int z, int y, int xx,
                                             const Links3d& L, bool prefer,
                                             float f[3]) {
  const int64_t i = ((int64_t)z * ny + y) * nx + xx;
  const int64_t sy = nx, sz = (int64_t)ny * nx;
  const auto at = [&](int c, int ez, int ey, int ex) {
    return x[c * cs + i + ez * sz + ey * sy + ex];
  };
  force3d_node(at, nz, ny, nx, z, y, xx, L, prefer, f);
}

}  // namespace sofima
