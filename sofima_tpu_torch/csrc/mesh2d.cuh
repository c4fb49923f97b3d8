// The 8-neighbour in-plane spring force of a 2d mesh: its definition,
// and the force on one node under K3's NaN rule (`force2d_node`, used by
// the fused 2d FIRE solver, fire.cu). K8 (force2d.cu) evaluates the same
// links once each under the other rule.
//
// Node positions are relative, [2, ny, nx] per mesh (channels x, y): node
// (y, x) sits at its grid position times the stride plus its value. For a
// neighbour at offset e the link vector is
//   d = x[node + e] - x[node] + l0v(e),  l0v(e) = stride * e,
// and the force on the node is k_e (1 - l0 / |d|) d, with k_e = k on the
// axis links and k / sqrt(2) on the diagonals, or with prefer_orig_order
// the per-component factor l0 * e_c sign(d_c) / |d| (1 where e_c = 0) in
// place of l0 / |d|. Neighbours outside the grid carry no spring.
//
// NaN convention. The two reference forms differ only for a link of zero
// length (coincident nodes); a link with a NaN or infinite end adds
// nothing in both.
//  * mesh.inplane_force (the XLA stencil mesh._spring_force) maps each
//    link force component through nan_to_num(posinf=0, neginf=0), so a
//    zero-length link adds 0. K8 computes that function and follows it.
//  * The Pallas bodies (pallas_mesh._force_tile, _roll_force_2d) keep a
//    link whose d.d is finite, so a zero-length link adds NaN. K3
//    replaces `_roll_force_2d` and keeps its rule.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh3d.cuh"  // sign0

namespace sofima {

struct Springs2d {
  float k;       // axis links
  float k_diag;  // k / sqrt(2), diagonals
  float stride_x, stride_y;
};

// K3's force on node (y, xx) of an ny x nx mesh. `at(c, ey, ex)` reads
// channel c of the node at offset (ey, ex) from it, (0, 0) being the node
// itself; it is called only for nodes inside the mesh. The fused solver
// reads them from its shared-memory tile (fire.cu). kBounds = false
// skips the bounds tests, for a node whose 8 neighbours all lie inside:
// the same links, in the same order.
template <bool kBounds = true, class At>
__device__ __forceinline__ void force2d_node(const At& at, int ny, int nx,
                                             int y, int xx,
                                             const Springs2d& S, bool prefer,
                                             float f[2]) {
  const float x0 = at(0, 0, 0), x1 = at(1, 0, 0);
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int ey = -1; ey <= 1; ++ey) {
    for (int ex = -1; ex <= 1; ++ex) {
      if (ex == 0 && ey == 0) continue;
      const int qy = y + ey, qx = xx + ex;
      if (kBounds && (qy < 0 || qy >= ny || qx < 0 || qx >= nx)) continue;
      const float l0x = S.stride_x * ex, l0y = S.stride_y * ey;
      const float l0 = sqrtf(l0x * l0x + l0y * l0y);
      const float k_eff = (ex == 0 || ey == 0) ? S.k : S.k_diag;
      const float d0 = at(0, ey, ex) - x0 + l0x;
      const float d1 = at(1, ey, ex) - x1 + l0y;
      const float dd = d0 * d0 + d1 * d1;
      // 1/|d| as rsqrt: inf at d = 0 and 0 at |d| = inf.
      const float inv_l = rsqrtf(fmaxf(dd, 0.0f));
      float g0, g1;
      if (prefer) {
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
  f[0] = acc0;
  f[1] = acc1;
}

}  // namespace sofima
