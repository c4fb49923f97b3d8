"""sofima_tpu_torch: the PyTorch / CUDA port of sofima_tpu.

A second package beside `sofima_tpu` (the JAX reference, which stays as
it is). The layout mirrors the reference so each module's twin is easy
to find; every module docstring names its `sofima_tpu` counterpart.

Ported: everything `sofima_tpu` does. Serial-section stack alignment
(`pipeline.stack_align`: flow -> clean -> solve -> invert -> render,
cold or warm-started, with masked flow in `flow_field`), 3d tile
stitching (`pipeline.stitch3d`) with the 3d mesh solvers, the 2d tile
montage (`pipeline.montage`), the library API that upstream SOFIMA's
notebooks drive (the flow calculator, `flow_utils`, `map_utils`, `warp`,
`stitch_rigid`, `stitch_elastic`), the chunk-parallel processors and
their runner, the TensorStore decorators, and the spatially sharded
solver, sharded flow and multi-process runner on torch.distributed
(`parallel`). The Pallas kernels are hand-written CUDA kernels for
Hopper (`csrc/*.cu`, built with nvcc at first use by `ops._build`);
each has a plain PyTorch version beside it that serves CPU tensors.

Module map:
  flow_field, flow_utils   — coarse-to-fine dense flow and its cleaning
  mesh                     — FIRE spring-mesh solver (plain version)
  map_utils                — map composition, inversion, filling
  warp                     — warp_subvolume, ndimage_warp, render_tiles
  stitch_rigid,            — tile placement and elastic tile stitching
  stitch_elastic
  convert                  — configs and state to and from sofima_tpu
  placement                — where entry points run (the card by default)
  ops                      — kernels (cuda_*) and small-grid algebra
  pipeline                 — the stack-alignment, 3d stitching and montage
                             pipelines
  processor                — chunk-parallel processors and their runner
  decorators               — TensorStore virtual-chunked decorators
  utils                    — boxes, volumes, configs, metrics, checkpoints
  parallel                 — the sharded solver and flow over
                             torch.distributed ranks, the multi-process
                             runner, and `launch` (ranks as child
                             processes)
"""

__version__ = '0.1.0'

# Submodules are imported by user code (import sofima_tpu_torch.mesh
# etc.); the package root stays light, as sofima_tpu's does.
