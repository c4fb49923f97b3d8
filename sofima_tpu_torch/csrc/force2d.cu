// 2d spring-mesh force (K8): every node's 8-neighbour in-plane Hookean
// force in one launch, one thread per node, any batch of meshes.
//
// Replaces sofima_tpu/ops/pallas_mesh.py `inplane_force_pallas` (body
// `_kernel` with `_force_tile`); its arithmetic and NaN rule are those of
// the function on the port's path, mesh.inplane_force (the XLA stencil):
// see mesh2d.cuh.
//
// What bounds it on the H100: memory traffic. Each node must read its 2
// positions and write its 2 forces, 16 B, so bench.py's 2048^2 mesh
// moves 67 MB, 20 us at 3.35 TB/s; the arithmetic (8 links x ~15 flops
// per node) is 7.5 us at 67 TFLOP/s. The TPU kernel DMAs an (8, 128)-
// aligned halo window into VMEM per grid step; here each thread reads its
// 8 neighbours straight from device memory, and the re-reads hit L1/L2
// because neighbouring threads take neighbouring x. Every link is
// evaluated from both ends (twice the least arithmetic); a shared-memory
// halo tile is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh2d.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
force2d_kernel(const float* __restrict__ x, float* __restrict__ out,
               int64_t nb, int ny, int nx, sofima::Springs2d springs,
               int prefer) {
  const int64_t per = (int64_t)ny * nx;  // nodes per mesh
  const int64_t cs = nb * per;           // channel stride
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < cs;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = g / per;
    const int64_t r = g - b * per;
    const int xx = (int)(r % nx);
    const int y = (int)(r / nx);
    float f[2];
    sofima::force2d_node<true>(x + b * per, cs, ny, nx, y, xx, springs,
                               prefer != 0, f);
    out[g] = f[0];
    out[cs + g] = f[1];
  }
}

}  // namespace

extern "C" {

// x, out: [2, nb, ny, nx] contiguous (channels x, y). k_diag = k / sqrt(2)
// from the host. Returns cudaGetLastError().
int force2d_launch(const float* x, float* out, int64_t nb, int ny, int nx,
                   float k, float k_diag, float stride_x, float stride_y,
                   int prefer, void* stream) {
  const int64_t total = nb * ny * nx;
  if (total == 0) return 0;
  sofima::Springs2d springs = {k, k_diag, stride_x, stride_y};
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;
  force2d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, nb, ny, nx, springs, prefer);
  return (int)cudaGetLastError();
}

}  // extern "C"
