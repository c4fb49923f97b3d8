"""sofima_tpu_torch: the PyTorch / CUDA port of sofima_tpu.

A second package beside `sofima_tpu` (the JAX reference, which stays as
it is). The layout mirrors the reference so each module's twin is easy
to find; every module docstring names its `sofima_tpu` counterpart.

Slice ported so far: serial-section stack alignment
(`pipeline.stack_align`): flow -> clean -> solve -> invert -> render.
The four Pallas kernels on that path are hand-written CUDA kernels for
Hopper (`csrc/*.cu`, built with nvcc at first use by `ops._build`);
each has a plain PyTorch version beside it that serves CPU tensors.

Module map:
  flow_field, flow_utils   — coarse-to-fine dense flow and its cleaning
  mesh                     — FIRE spring-mesh solver (plain version)
  map_utils                — map composition and inversion
  convert                  — configs and state to and from sofima_tpu
  ops                      — kernels (cuda_*) and small-grid algebra
  pipeline                 — the stack-alignment pipeline
"""

__version__ = '0.1.0'

# Submodules are imported by user code (import sofima_tpu_torch.mesh
# etc.); the package root stays light, as sofima_tpu's does.
