// 3d spring-mesh force: every node's 26-neighbour Hookean force in one
// launch, one thread per node.
//
// Replaces sofima_tpu/ops/pallas_mesh.py `elastic_mesh_3d_pallas` (bodies
// `_kernel_3d_loop` and `_kernel_3d_rolls`) and serves its slab variant
// `elastic_mesh_3d_pallas_slab` (`_kernel_3d_slab_win`,
// `_kernel_3d_slab_symloop`, `_kernel_3d_slab`); its arithmetic is that of
// the contract both share, mesh.elastic_mesh_3d (the XLA stencil,
// `_spring_force`): see mesh3d.cuh.
//
// What bounds it on the H100: memory traffic. Each node must read its 3
// positions and write its 3 forces, 24 B, so the 4.2 M-node mesh of the
// mesh3d bench stage moves 100 MB, ~30 us at 3.35 TB/s; the arithmetic
// (13 links per node if each spring were evaluated once) is ~20 us at
// 67 TFLOP/s. The TPU kernels stage halo windows in VMEM and roll them,
// and their slab / link-loop / guard-ring variants exist to get past the
// Mosaic compiler; here each thread reads its 26 neighbours straight
// from device memory, and the re-reads hit L1/L2 because neighbouring
// threads take neighbouring x. Every link is evaluated from both ends
// (26 evaluations per node, twice the least arithmetic); staging a halo
// tile in shared memory and sharing each link between its two nodes is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh3d.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
force3d_kernel(const float* __restrict__ x, float* __restrict__ out,
               int64_t nb, int nz, int ny, int nx, sofima::Links3d links,
               int prefer) {
  const int64_t per = (int64_t)nz * ny * nx;  // nodes per mesh
  const int64_t cs = nb * per;                // channel stride
  const int64_t total = cs;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < total;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = g / per;
    const int64_t r = g - b * per;
    const int xx = (int)(r % nx);
    const int y = (int)((r / nx) % ny);
    const int z = (int)(r / ((int64_t)nx * ny));
    float f[3];
    sofima::force3d_node(x + b * per, cs, nz, ny, nx, z, y, xx, links,
                         prefer != 0, f);
    out[g] = f[0];
    out[cs + g] = f[1];
    out[2 * cs + g] = f[2];
  }
}

}  // namespace

extern "C" {

// x, out: [3, nb, nz, ny, nx] contiguous. table: host float[26 * 5], per
// link (l0x, l0y, l0z, l0, k_eff) in (ez, ey, ex) loop order. Returns
// cudaGetLastError().
int force3d_launch(const float* x, float* out, int64_t nb, int nz, int ny,
                   int nx, const float* table, int prefer, void* stream) {
  sofima::Links3d links;
  for (int l = 0; l < sofima::kLinks3d; ++l) {
    links.l0v[l][0] = table[5 * l];
    links.l0v[l][1] = table[5 * l + 1];
    links.l0v[l][2] = table[5 * l + 2];
    links.l0[l] = table[5 * l + 3];
    links.k_eff[l] = table[5 * l + 4];
  }
  const int64_t total = nb * nz * ny * nx;
  if (total == 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  force3d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, nb, nz, ny, nx, links, prefer);
  return (int)cudaGetLastError();
}

}  // extern "C"
