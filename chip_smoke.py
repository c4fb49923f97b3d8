"""GPU smoke run of sofima_tpu_torch: every kernel, then every ported path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from sofima_tpu_torch/csrc and drives the
slices of the port, each kernel checked against its plain PyTorch
version at its path's shapes (timed beside it, with the least time the
card could take for the same work and, where one exists, one PyTorch
call that computes the same function):

  * stack alignment: K1-K4 on 10k^2 sections, then a synthetic 10k^2
    serial-section stack (seeded texture, cumulative drift plus wobble,
    as bench.py's pipeline stage builds it) aligned by
    `align_stack_pipelined` at bench.py's headline configuration and
    checked against the known ground truth;
  * masked flow and warm start: K5 on bench.py's `flow_masked` input
    (10k^2, p = 160, s = 40, its crack band + blob mask), then the masked
    coarse-to-fine path on the stack's first pair (all-valid mask against
    the unmasked targeted path; bench's mask against the same path with
    K5 and K4 swapped for their plain versions), the warm-start stack
    path on the same stack, and a forced
    stale-prior refresh at 640^2; the invert layer (csrc/invert.cu) on the
    stack path's solved meshes, `_invert_phase` for one section and a
    block of 15, against the plain chain on a CPU copy of the inputs;
  * 3d tile stitching: K9 (3d force, both force forms; also held and
    timed on path (a)'s tile meshes, and held on a batch of odd meshes
    with NaN holes on its tile edges), K11 (fused 3d FIRE) and K13 (3d
    render); the fused solvers' grid-stride route (K3 and K11 on meshes
    whose tiles the card cannot hold at once, up to the reference's VMEM
    bound: [2, 1, 100, 7000] and [3, 8, 256, 256], against their plain
    versions; one node over the bound raises as the reference does);
    then (a) `stitch_and_render_3d` on bench.py's LICONN
    geometry (2 x 2 tiles of 64 x 576 x 576, seeded band-limited
    texture) with bench.py's quality gates, (b) `mesh.relax_mesh` with
    the 3d force on bench.py's mesh3d mesh and (c) the fused 3d solver
    on bench.py's mesh3d_fused mesh, with their throughputs; and the
    stitch at the CPU tests' geometry on the card against the CPU;
  * 2d montage and the staged 2d solver: K8 (2d force) on bench.py's
    `mesh` input, then (d) bench.py's `mesh` stage (`velocity_verlet`,
    1000 steps on 2048^2 nodes, both force forms) against the same run
    with K8 swapped for its plain version, (e) `montage_align_2d` at
    bench.py's `montage2d` geometry (3 x 3 tiles of 3600^2, 400 px
    overlap, cut from a seeded 10k^2 texture) with its quality gates,
    K1, K4 and K8 against their plain versions on the inputs that path
    gave them, and the whole path against the same run with those
    kernels swapped for their plain versions; the montage at the CPU
    tests' geometry on the card against the CPU,
    and one drift-removal `align_step` (the staged solver: K8, no K3);
  * the library API: (f) examples/e2e_alignment.py's chain at bench.py's
    section size (a 10k^2 pair deformed by e2e's 12 px field): the
    calculator's padfield flow (p = 160, s = 40, batch 256) at 1x and, as
    the em_alignment notebook does, at 2x, `clean_flow`, `resample_map`,
    `reconcile_flows` (once more with `min_patch_size`, the component
    labelling, held against the CPU there and on a holed copy of the
    flow), the fused solver (K3, held against its plain version on the
    same inputs for its first 1000 steps), `invert_map` + `fill_missing`,
    `warp_subvolume` (K4, standing for the reference's K12 / K4p) and
    e2e's gate on the residual flow; one 2d `ndimage_warp` (K4 per work
    box, K12) against its plain version; K4's launches from both against
    their plain versions on their inputs, and the render against the
    plain render; then K6 through the rectangular strip path (every
    launch on its FFT route, timed on that path's launches beside
    torch.fft's surfaces of the same pairs; its dense-DFT route held at
    256 x 128) and K7 on the first 30 grid rows of that pair's p = 160
    patches (beside the torch.fft chain), and at 256^2 (its
    global-scratch route) and 31 x 37;
  * the tile-stitching library API: (g) examples/e2e_stitching.py's
    chain at bench.py's montage2d geometry, cut with a per-tile integer
    jitter and one tile's content displaced by a non-integer bump: the
    sequential `compute_coarse_offsets` (equal to the cut's jitter and
    to `compute_coarse_offsets_batched`), `interpolate_missing_offsets`,
    `optimize_coarse_mesh`, `compute_flow_map` in its padfield mode at
    the reference's defaults, `aggregate_arrays`, `mesh.relax_mesh`
    with the targets as `prev_fn` (K8) and `warp.render_tiles` (K4,
    counted under 'warp_subvolume'), with bench's montage gates, its
    phase times and the largest node move, and the whole chain against
    the same run with K4 and K8 swapped for their plain versions; then
    `compute_flow_map3d(flow_mode='padfield', mask_map=...)` on path
    (a)'s x pair cut to 128 rows, on the card and on the CPU;
  * the processor layer: the render processor StitchAndRender3dTiles on
    path (a)'s tiles and solved meshes (an .npz in a temporary
    directory, through `runner.process_volume`; path (a)'s gates, K13 on
    its recorded renders against plain); K1, K2, K5 and K6 with
    per-axis peak windows against their plain versions; and (h)
    examples/e2e_pipeline.py's processor chain at the em_2d defaults on
    4 x 4096^2 (EstimateFlow at 1x and 2x, ReconcileAndFilterFlows,
    EstimateMissingFlow's device waves, the missing-flow reconcile,
    RelaxMesh sequential in z, InvertMap, WarpByMap Lanczos), with
    e2e_pipeline's gate, the chunked flow against one whole-section K1
    call (no seams), section 2's hole refilled from Δz = 2, and K1, K8
    and K4p against their plain versions on the inputs the path gave
    them;
  * the decorator layer: (i) the chunk functions of the TensorStore
    decorators (what each decorator's read_fn computes; the card's
    machine has no tensorstore) on path (h)'s sections 0 and 1 at the
    em_2d defaults: OptimFlow padfield, circular (K1) and masked with
    bench's mask (K5), each against the known field; CleanFlowFilter,
    ReconcileFlowFilter, MeshRelaxFlowFilter (K8), MakeAffineCoordMap and
    ComposeCoordMaps; WarpAffine (K12) on two known affines and ECC
    (OptimAffineTransformSectionwise, affine and euclidean) recovering
    them; OptimTranslationTransform on rolled copies; then on path (a)'s
    tile volume moved by a smooth 3d field: the 3d padfield OptimFlow,
    MeshRelaxFlowFilter 3d (K9), WarpAffine 3d (K13), WarpCoordMap and
    the 3d translation; ECC and phase correlation against the CPU; the
    checkpointing relaxer stopped at a snapshot and resumed, equal to
    one run; and the kernel stages again under `plain_kernels`;
  * the parallel package: (j) jobs of child-process ranks
    (sofima_tpu_torch.parallel.launch; this process never joins a
    process group), one rank (no process group: `initialize` on NCCL,
    the default backend, is a no-op for one process) and then two gloo
    ranks sharing the card: `relax_mesh_sharded` on bench.py's `mesh` stage (K8; a y
    split, a 1 x 2 grid, and the mesh with NaN rows and drift removal)
    and on path (b)'s 3d mesh (K9; y split, 1 x 2 grid), each within
    MESH_TOL of the one-rank `mesh.relax_mesh_fused` with equal steps
    and NaN pattern; `dense_flow_field_sharded` on the stack path's
    first pair (K1; K5 with bench's mask; the pair cut to an unaligned
    height) and `sharded_flow_step`, exact against the one-rank flow;
    and `process_volume_distributed` with path (h)'s EstimateFlow, the
    union of the ranks' work boxes equal to path (h)'s output. Every
    rank must return the same result; the ranks' launches join K1, K5,
    K8 and K9's rows.

K3 and K11 (the fused FIRE solvers) are also held without `prev` on a
mesh whose sides are not a multiple of the tile, with a NaN row along a
tile edge (steps, NaN pattern, max |dx|, a bit-for-bit repeat), print
their microseconds per step, and K3 is timed on path (f)'s whole solve.
K4 is held against its plain version in all four methods at 10k^2 (the
shared-memory branch: the share of staged tiles is printed) and on a
field of random positions (every tile on the direct branch); K13 so in
linear and Lanczos at path (a)'s render shape and on random positions.
K5 is also timed route by route on bench's grid (the pure pairs on the
shared-memory FFT, the impure on the dense DFT, each alone on its list),
and its pure route must run on the masked path. K1 and K2 must take
their FFT route at the stack path's shapes (no launch counted under
'flow_peaks_dft' there, nor on the cold and warm stack paths); torch.fft's
time for the same pairs' surfaces (pre-cut patches) is printed beside
them as a yardstick for the transform alone, and their dense-DFT route is
held against the plain version at p = 192 on a 2048^2 pair. The
redesigned kernels (K1, K2, K3, K4, K5, K6, K7, K8, K9, K11, K13, and
K4's launches as K12 and K4p) print their times before the redesign
beside the new ones; K9's and the grid-stride route's compiler reports
(registers, spills) are printed after the build; the stack path and path
(c) must take the tiled fused route (no launch counted under
'fused_fire_grid'); the
kernels line holds only numbers measured (or, for bound_ms, computed) in
this run.

Each path runs with the launch counters set to 0 just before it and
read just after; a kernel of the path that was not launched fails the
run. Any failed check raises. The last line is the JSON status; the
line before it lists each kernel with its launch count, its error
against the plain version and its times. Without CUDA it exits non-zero
before any work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

N = 10_000          # section edge (bench.py's size)
N_Z = 4             # sections; bench.py runs 16, cut here only for time
STRIDE = 40
SEED = 0
FLOW_STAT_TOL = 3e-4    # rtol = atol for sharpness / ratio (tests' bar)
# Share of statistics that must meet it: just below the shares read on
# an H100 at these inputs (0.9987 for K1, 0.9993 for K2).
STAT_FRACTION = 0.998
# K5's share: near masked regions the Padfield surfaces divide by
# correlation values close to 0, so summation order moves more of the
# statistics; the bar is the GPU tests' (99%), with every quality-gate
# decision equal as for K1/K2.
STAT_FRACTION_MASKED = 0.99
MASK_BAND, MASK_PERIOD = 900, 7919   # bench.py's flow_masked crack band
MASK_BLOB = (3000, 7000, 1500)       # and blob (centre y, x, radius)
# Masked c2f, card against the plain path: summation order can flip an
# integer peak where two candidates tie to float rounding (1 node of
# 50 661 against the CPU plain path on an H100): at most this share, by
# at most 1 px, with the NaN pattern equal.
MASKED_TIE_SHARE = 1e-4
TRANSPORT_EXACT = 0.95  # all-valid masked c2f vs targeted on an integer
                        # shift (tests/test_shift_warp.py's bar)
MESH_TOL = 1e-3         # px, fused solver vs plain solver
RENDER_TOL = 1e-2       # gray levels, render kernel vs plain render
MAX_ERR = 3.5           # bench.py's pipeline ground-truth gate
SMALL_MESH_TOL = 0.4    # px = 0.01 * stride, small-input parity
INVERT_TOL = 1e-4       # px, the invert layer's kernels vs plain (NaNs exact)
INVERT_BATCHES = (1, 15)  # sections a call of `_invert_phase`: the stream's
                          # and a block's (bench.py's 16, less its anchor)
INVERT_LAUNCHES = 24    # the layer's own launches a call, at most
MESH3D = (8, 512, 1024)       # bench.py's mesh3d nodes (z, y, x)
FUSED3D = (8, 128, 256)       # bench.py's mesh3d_fused nodes
LICONN = (64, 576, 64)        # bench.py's stitch3d: depth, tile edge, overlap
FORCE_TOL = 1e-4        # 3d force vs plain (tests/test_pallas_mesh.py's bar)
STITCH_REL_ERR = 0.5    # bench.py's stitch3d gates
STITCH_COVERAGE = 0.5
SMALL_MESH_TOL_3D = 0.08      # px = 0.01 * stride 8
SMALL_CANVAS_TOL = (0.05, 2.0)  # gray levels: mean, max where both weigh
MESH2D = (2048, 2048)         # bench.py's mesh stage nodes (y, x)
MONTAGE = (3, 3600, 400)      # bench.py's montage2d: grid, tile, overlap
MONTAGE_ERR = 10.0            # bench.py's montage2d gates
MONTAGE_COVERAGE = 0.95
# Path (d), card against plain on the card: 1000 FIRE steps from a
# random mesh; the force's last-bit differences feed back through the
# global power sum.
VERLET_TOL = 1e-2             # px
SMALL_MESH_TOL_2D = 0.2       # px = 0.01 * stride 20
SMALL_CANVAS_TOL_2D = (0.01, 0.05)  # gray levels: mean, max, both masks
# Path (e), card against plain on the card: the canvas mask is analytic in
# the sampling positions, so a last-bit mesh difference may move a pixel
# across the margin; at most this share of the canvas.
MONTAGE_MASK_SHARE = 1e-4
# Path (g), examples/e2e_stitching.py's chain through the library API at
# bench.py's montage2d geometry (MONTAGE): the coarse search grid and
# bound of path (e), the largest per-tile integer jitter of the cut (px),
# and the Gaussian bump that moves tile (1, 1)'s content by a non-integer
# amount inside its left overlap: (x, y) amplitude in px and sigma as a
# share of the tile edge. Some node must move at least STITCH_API_MOVE px
# away from its coarse placement in the joint solve.
STITCH_API_OVERLAPS = (360, 440)
STITCH_API_MIN_OVERLAP = 200
STITCH_API_JITTER = 5
STITCH_API_BUMP = (2.6, -1.7, 1 / 12)
STITCH_API_MOVE = 0.5
# The 3d padfield phase: one overlap pair of path (a)'s LICONN tiles, cut
# to this many rows, through compute_flow_map3d(flow_mode='padfield').
PADFIELD3D_ROWS = 128
E2E_AMP = 12.0          # px, examples/e2e_alignment.py's deformation
E2E_PATCH = 160         # e2e_alignment's calculator patch and batch
E2E_BATCH = 256
E2E_GATE = 1.5          # px: residual flow after alignment (and < 1/5
                        # of before), e2e_alignment's gate
K6_PATCH = (160, 80)    # K6 through the rectangular strip path
# K6's dense-DFT route (shapes the FFT route does not serve): pairs, shape.
K6_DFT_ROUTE = (256, (256, 128))
K7_ROWS = 30            # grid rows of p = 160, s = 40 pairs held for K7
SURFACE_TOL = 1e-3      # K7 vs plain, relative to each surface's max
# K7 also at a size over the shared-memory route (three launches through
# global scratch) and at a prime, rectangular size: (pairs, p1, p2).
K7_EXTRA = ((64, 256, 256), (512, 31, 37))
K4_METHODS = ('nearest', 'linear', 'cubic', 'lanczos')
K4_RANDOM = 2048        # edge of K4's random-position field
K13_RANDOM = (64, 256, 256)   # K13's random-position output (z, y, x)
K12_REPS = 20           # timed calls per K12 box (kernel and grid_sample)
# The redesigned kernels' times before the redesign (the dense-DFT K7,
# K1, K2 and K6, the runtime-tap K4 gather, K5 with every pair on the
# dense DFT, the runtime-tap, unstaged K13, the per-node K8 and the
# two-barrier K3 / K11, measured by this script on an H100 80GB HBM3 at
# 700 W), printed beside the new ones and kept out of the kernels line.
K1_PRIOR_MS = 56.77
K2_PRIOR_MS = 70.46
K7_PRIOR_MS = 115.8
K4_PRIOR_MS = 7.149
K4_PRIOR_MS_LINEAR = 1.446
K12_PRIOR_MS = 3.025
K4P_PRIOR_MS = 7.227
K5_PRIOR_MS = 985.7
K13_PRIOR_MS = 1.070
K13_PRIOR_MS_LANCZOS = 10.82
K6_PRIOR_MS = 340.5     # the dense DFT, summed over the strip path
K8_PRIOR_MS = 0.0884    # one thread per node, every link from both ends
K3_PRIOR_MS = 8.451     # two grid barriers a step, state in device memory
K11_PRIOR_MS = 29.28    # (1125 steps on 250^2; 1000 on [3, 8, 128, 256])
K9_PRIOR_MS = 0.2636    # one thread per node, every link from both ends
K9_PRIOR_MS_TILE = 0.1130  # (path (b)'s mesh; a call on path (a)'s)
# K9 also on a batch of meshes no side of which is a multiple of its 8 x
# 128 or 16 x 128 tiles, with NaN holes on the tile edges.
K9_ODD = (3, 2, 5, 37, 71)
# The fused solvers' grid-stride route: meshes over what the card holds
# as tiles and within the reference's VMEM bound (the 3d one exactly at
# it), (dim, nodes); FIRE steps held against plain.
FIRE_GRID = ((3, (8, 256, 256)), (2, (1, 100, 7000)))
FIRE_GRID_ITERS = 200
# K3 and K11 also without `prev`, on meshes whose sides are not a
# multiple of the tile, with a NaN row along a tile edge: (z,) y, x nodes.
# K3 also on FIRE_MULTI, a mesh its plan gives more than one node a thread.
FIRE_ODD = {2: (203, 150), 3: (5, 37, 71)}
FIRE_MULTI = (301, 283)
# K1's dense-DFT route (sizes the FFT route does not serve): image edge,
# p and step of the pair it is held on.
DFT_ROUTE = (2048, 192, 64)
MIN_PATCH = 4           # reconcile_flows' min_patch_size in path (f)
HOLE_SHARE = 0.45       # nodes dropped from a copy of path (f)'s 1x flow,
                        # leaving islands for the component pruning
K3_STEPS = 1000         # path (f)'s K3 held against plain for this many
ND_WORK, ND_OVERLAP = 2048, 64   # path (f)'s ndimage_warp work boxes
# Path (f) against its plain kernels: integer renders may differ by one
# gray level where the float value sits at .5, on at most this share.
RENDER_FLIP_SHARE = 1e-3
# Path (h), examples/e2e_pipeline.py's processor chain at the em_2d
# defaults: PROC_Z sections of PROC_N^2 (section 0 a texture, z warped by
# z x a smooth PROC_AMP px field), a PROC_BLANK^2 zeroed square in
# section 1 (section 2's Δz = 1 flow loses it; Δz = 2 refills it), and
# the share of the square's nodes that must be refilled.
PROC_N, PROC_Z, PROC_AMP, PROC_BLANK = 4096, 4, 8.0, 512
PROC_FILLED = 0.9
# Path (i), the decorator layer's chunk functions: path (h)'s sections 0
# and 1 at the em_2d defaults, path (a)'s tile volume; WarpAffine's known
# affine (rotation in degrees, scale, xy shift in px; the euclidean pair
# without the scale), the rolls that the translation transforms must
# find exactly (y, x and z, y, x), ECC's margin (the crop of both
# sections that the warp leaves full) and corner bar, the share of valid
# flow nodes within DEC_FLOW_PX of the known field, the 3d field's
# amplitude, the crop on which ECC is also run on the CPU, the
# checkpoint's snapshot period (chunks) and the composition's bar.
DEC_AFFINE = (0.3, 1.001, (6.4, -3.7))
DEC_ROLL, DEC_ROLL3 = (37, -21), (5, -9, 13)
DEC_MARGIN, DEC_CORNER_PX = 64, 0.05
DEC_FLOW_SHARE, DEC_FLOW_PX = 0.95, 1.0
DEC_3D, DEC_3D_AMP = (64, 576, 576), 3.0
DEC_ECC_CROP = 1024
DEC_SAVE_EVERY = 2
DEC_COMPOSE_PX = 2e-3
# Per-axis peak windows held on K1, K2, K5 and K6: (min_distance,
# peak_radius), one radius per surface axis (y, x).
PER_AXIS = ((1, 3), (4, 2))
# Path (j), the sharded solves, the sharded flow and the multi-process
# runner, each job's ranks child processes (sofima_tpu_torch.parallel.
# launch): one rank (no process group), then two gloo ranks sharing
# the card. The 2d
# solve takes bench.py's `mesh` stage (2048^2 nodes, 1000 steps, its
# config) and the 3d solve path (b)'s (8 x 512 x 1024, 200 steps); the
# drift-removal case adds SHARD_NAN_ROWS NaN rows to the 2d mesh, one
# row more than a multiple of the ranks; the flows take the stack path's
# first pair, once cut to SHARD_FLOW_ROWS rows; `sharded_flow_step`
# takes SHARD_STEP_STARTS patch starts of that pair. A rank that fails
# or outlives SHARD_TIMEOUT seconds fails the run.
SHARD_NAN_ROWS, SHARD_FLOW_ROWS, SHARD_STEP_STARTS = 8, 9976, 1024
SHARD_TIMEOUT = 300
SHARD_ONE_RANK = ('solve2d_y', 'solve3d_y')
SHARD_TWO_RANKS = ('solve2d_y', 'solve2d_grid', 'solve2d_pad_drift',
                   'solve3d_y', 'solve3d_grid', 'flow_circular',
                   'flow_masked', 'flow_cut', 'flow_step', 'runner')

# The least time the card could take for the same work: the
# larger of bytes over HBM bandwidth and operations over the f32 peak
# outside the tensor cores (NVIDIA H100 SXM data sheet).
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# Operation counts per unit of work, f32 flops (a sqrt, rsqrt, sin or
# division counts as one):
#   circular xcorr of a p x p pair: 3 real 2d FFTs (2.5 N log2 N each,
#   half a complex FFT's 5 N log2 N, N = p^2), the spectrum product and
#   the peak search (~8 per point);
#   a p1 x p2 pair: the same with N = p1 p2;
#   Lanczos render: ~350 per output pixel (16 weights of ~12, 64 taps of
#   2, the row sums and the norm); trilinear 3d render: ~50 per voxel;
#   spring force: 15 per 2d link (8 per node) and 24 per 3d link, each
#   3d spring counted once (13 per node, Newton's third law);
#   FIRE step: the force plus ~60 (2d) / ~80 (3d) per node for the k0
#   spring, the Verlet update, the mixing and the power sum.
LANCZOS_FLOPS_PX = 350
LINEAR_FLOPS_PX = 30    # bilinear render: 4 weights, 4 taps, row sums
LINEAR3D_FLOPS_VOX = 50
# Lanczos 3d render: 512 taps of 2, 64 + 8 row sums of 2, 24 weights of
# ~12.
LANCZOS3D_FLOPS_VOX = 512 * 2 + 72 * 2 + 24 * 12
FORCE3D_FLOPS_NODE = 13 * 24
FORCE2D_FLOPS_NODE = 8 * 15
FIRE2D_FLOPS_NODE_STEP = 8 * 15 + 60
FIRE3D_FLOPS_NODE_STEP = FORCE3D_FLOPS_NODE + 80
# The invert layer a node: 16 samples of the offset field (12 fixed-point
# steps, 2 Newton steps, 2 residual gates) at 4 taps of ~12 and the 4
# Jacobian planes' taps in each Newton step (~900), then the fill of its
# two channels (16 Jacobi sweeps of ~6 over 4/3 of a level's nodes, 9
# jump-flooding passes of 8 offsets of ~5: ~620 a channel).
INVERT_FLOPS_NODE = 900 + 2 * 620


def check(ok: bool, what: str) -> None:
  if not ok:
    raise AssertionError(what)


def smi() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()


def sync():
  torch.cuda.synchronize()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
  """Bit-for-bit equality, NaN included."""
  return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def cuda_ms(fn, reps: int = 3) -> float:
  """Mean milliseconds per call on the device (after one warm-up)."""
  fn()
  sync()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  sync()
  return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
  sync()
  t0 = time.perf_counter()
  fn()
  sync()
  return (time.perf_counter() - t0) * 1e3


def least_time(nbytes: float, flops: float) -> dict:
  """bound_ms / bound_by of work that moves `nbytes` and does `flops`."""
  t_b, t_o = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
  return dict(bound_ms=max(t_b, t_o),
              bound_by='bytes' if t_b >= t_o else 'operations')


def compiler_report(log: str, kernel: str) -> list[str]:
  """ptxas's registers and spills of each instantiation of `kernel`."""
  rows = []
  for block in log.split('Compiling entry function')[1:]:
    name = block.split("'")[1] if "'" in block else ''
    if kernel not in name:
      continue
    regs = re.search(r'Used (\d+) registers', block)
    spill = re.search(r'(\d+) bytes spill stores', block)
    tmpl = re.search(kernel + r'I(\w+?)E(?:E|v)', name)
    rows.append(f'{kernel}<{tmpl.group(1) if tmpl else "?"}>: '
                f'{regs.group(1) if regs else "?"} registers, '
                f'{spill.group(1) if spill else "?"} B of spills')
  return rows


def xcorr_flops(p: int, p2: int | None = None) -> float:
  n = p * (p if p2 is None else p2)
  return 3 * 2.5 * n * np.log2(n) + 8 * n


def masked_flops(p: int, n_pure: int, n_impure: int) -> float:
  """K5's operations for a mix of branches (a dead pair does none).

  A pure pair is one circular xcorr plus its four moments (4 per point);
  an impure pair 12 real 2d FFTs (6 forward, 6 inverse: four times the 3
  of an xcorr) plus the Padfield combination (~20 per point)."""
  n = p * p
  return n_pure * (xcorr_flops(p) + 4 * n) + n_impure * (
      4 * xcorr_flops(p) + 20 * n)


def bench_mask(n: int, dev) -> torch.Tensor:
  """bench.py's flow_masked tissue mask (True = invalid), ~17%."""
  yy = torch.arange(n, device=dev)[:, None]
  xx = torch.arange(n, device=dev)[None, :]
  cy, cx, r = MASK_BLOB
  return (((yy + xx) % MASK_PERIOD < MASK_BAND)
          | ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r))


def texture(n: int, dev) -> torch.Tensor:
  """bench.py's band-limited EM-like texture in [0, 255] (float32)."""
  rng = np.random.RandomState(SEED)
  noise = torch.from_numpy(rng.rand(n, n).astype(np.float32)).to(dev)
  f = torch.fft.rfft2(noise.double())
  fy = torch.fft.fftfreq(n, device=dev, dtype=torch.float64)[:, None]
  fx = torch.fft.rfftfreq(n, device=dev, dtype=torch.float64)[None, :]
  f *= torch.exp(-((fx ** 2 + fy ** 2) / (2 * 0.08 ** 2)))
  tex = torch.fft.irfft2(f, s=(n, n)).float()
  return (tex - tex.min()) / (tex.max() - tex.min()) * 255.0


def make_stack(base: torch.Tensor, n_z: int) -> torch.Tensor:
  """uint8 [n_z, n, n] stack: section z is `base` warped (with K4 in
  'linear' mode) by a cumulative drift of (2.5z, -2z) px plus a 7 px
  wobble, as bench.py's pipeline stage builds it."""
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.ops import interp
  n = base.shape[-1]
  g = n // STRIDE
  dev = base.device
  base_u8 = torch.clamp(base + 0.5, 0, 255).to(torch.uint8)
  gm = torch.arange(g, dtype=torch.float32, device=dev) * STRIDE
  ys = torch.arange(n, dtype=torch.float32, device=dev)
  sections = [base_u8]
  for z in range(1, n_z):
    dyz = 2.5 * z + 7.0 * torch.sin(2 * np.pi * gm[None, :] / 2500.0
                                    + 0.7 * z).expand(g, g)
    dxz = -2.0 * z + 7.0 * torch.cos(2 * np.pi * gm[:, None] / 2500.0
                                     + 0.4 * z).expand(g, g)
    dd = interp.upsample_map_linear(torch.stack([dyz, dxz]), STRIDE, (0, 0),
                                    (n, n))
    cz = torch.stack([dd[0] + ys[:, None], dd[1] + ys[None, :]])[None]
    del dd
    sec = cuda_warp.shift_warp(base_u8.float()[None], cz.contiguous(),
                               'linear')[0]
    sections.append(torch.clamp(sec + 0.5, 0, 255).to(torch.uint8))
    del cz, sec
  return torch.stack(sections)


def headline_config():
  """bench.py's headline pipeline configuration (bench.py:516-520)."""
  from sofima_tpu_torch.pipeline import stack_align
  cfg = stack_align.StackAlignConfig(max_displacement=128, residual=6,
                                     render_two_pass=True, peak_crop=32)
  return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                           num_iters=125))


def compare_flow(got, ref, name, fraction=STAT_FRACTION, dim=2):
  """Holds a flow ([dim + 2, ...]: offsets, sharpness, ratio) to `ref`."""
  xy_bad = int((torch.nan_to_num(got[:dim], nan=9e9)
                != torch.nan_to_num(ref[:dim], nan=9e9)).any(0).sum())
  print(f'  {name}: patches whose x/y peak or NaN differs: {xy_bad}')
  check(xy_bad == 0, f'{name}: integer peaks differ from the plain version')
  # Sharpness divides by the correlation minimum around the peak, which
  # can sit near zero, so f32 summation order moves it freely there. The
  # bar: a STAT_FRACTION share of the statistics within rtol = atol =
  # 3e-4, and the quality gates they feed (|sharpness| >= 1.6, ratio >=
  # 1.6 or 0) decide alike.
  fin = torch.isfinite(ref[dim:]) & torch.isfinite(got[dim:])
  d = (got[dim:] - ref[dim:]).abs()[fin]
  bound = FLOW_STAT_TOL + FLOW_STAT_TOL * ref[dim:].abs()[fin]
  frac = float((d <= bound).float().mean())
  rel = float((d / ref[dim:].abs()[fin].clamp(min=1e-6)).max())

  def gates(f):
    ratio = f[dim + 1].abs()
    return (f[dim].abs() >= 1.6) & ((ratio == 0) | (ratio >= 1.6))

  flips = int((gates(got) != gates(ref)).sum())
  print(f'  {name}: x/y and NaN exact over {ref[0].numel()} patches; '
        f'statistics within rtol=atol={FLOW_STAT_TOL}: {frac:.6f} '
        f'(max rel {rel:.3g}); quality-gate flips {flips}')
  check(frac >= fraction, f'{name}: sharpness/ratio disagree')
  check(flips == 0, f'{name}: quality-gate decisions differ')
  # max_abs_err is the flow itself (x/y peaks, NaN rows excluded); the
  # statistics' agreement is reported beside it.
  return dict(
      err=float(torch.nan_to_num((got[:dim] - ref[:dim]).abs(),
                                 nan=0.0).max()),
      stat_frac=frac, stat_max_rel=rel, stat_max_abs=float(d.max()))


def fft_surfaces_ms(pre, post, offsets, grid, p, step) -> float:
  """torch.fft's time for the circular cross-correlation surfaces of a
  flow grid's pairs, cut from the images beforehand (untimed): rfft2 of
  both batches, the conjugate product, irfft2. A yardstick for the
  transform alone: it neither takes the means off nor searches peaks."""
  from sofima_tpu_torch.ops import cuda_flow
  gy, gx = grid
  n = gy * gx
  ii = torch.arange(n, device=pre.device)
  y0, x0 = (ii // gx) * step[0], (ii % gx) * step[1]
  qy0, qx0 = y0, x0
  if offsets is not None:
    off = offsets.reshape(n, 2).to(torch.int64)
    qy0, qx0 = y0 + off[:, 0], x0 + off[:, 1]
  cut = lambda img, ys, xs: torch.cat([
      cuda_flow._patches(img, ys[c:c + 4096], xs[c:c + 4096], p)
      for c in range(0, n, 4096)])
  a, b = cut(pre, y0, x0), cut(post, qy0, qx0)
  return cuda_ms(lambda: torch.fft.irfft2(
      torch.fft.rfft2(a) * torch.conj(torch.fft.rfft2(b)), s=(p, p)))


def fft_route(fn, name, _build):
  """One call of K1 or K2 that must take the FFT route (no launch under
  'flow_peaks_dft') and repeat bit for bit; returns its rows."""
  before = _build.launch_counts['flow_peaks_dft']
  got = fn()
  check(_build.launch_counts['flow_peaks_dft'] == before,
        f'{name} did not take the FFT route')
  check(same_bits(got, fn()), f'{name} does not repeat bit for bit')
  print(f'  {name}: FFT route; a second launch repeats the first bit for bit')
  return got


def print_flow_times(r, prior_ms) -> None:
  print(f'  FFT route: {r["threads"]} threads a block, {r["blocks_per_sm"]} '
        'blocks per SM')
  print(f'  kernel {r["ms"]:.3f} ms (before {prior_ms}), plain '
        f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.3f} ms; torch.fft '
        f'surfaces alone (rfft2, conj product, irfft2 of the pre-cut '
        f'patches) {r["torch_fft_ms"]:.3f} ms')


def k5_phase(dev, report, pre, post) -> None:
  """K5 on bench.py's flow_masked stage: the dense masked grid (p = 160,
  s = 40) of a 10k^2 pair with its tissue mask on both planes, against
  the plain version; each route alone on its own list."""
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.ops import cuda_flow
  print('K5 masked_flow_peaks, 10k^2, p = 160, s = 40, bench.py\'s mask')
  valid = (~bench_mask(N, dev)).to(torch.float32)
  gm = (N - (160 - 40)) // 40
  cls = cuda_flow.masked_patch_classes(valid, valid, 160, (40, 40))
  n_impure, n_pure, n_dead = (int((cls == c).sum()) for c in range(3))
  print(f'  {gm * gm} patches: {n_dead} dead, {n_pure} pure, {n_impure} '
        f'impure; invalid share {1 - float(valid.mean()):.3f}')
  check(min(n_dead, n_pure, n_impure) > 0, 'K5: a branch is missing')
  k5 = lambda: cuda_flow.masked_dense_flow_peaks(pre, post, valid, valid,
                                                 (160, 160), (40, 40))
  k5p = lambda: cuda_flow.masked_flow_peaks_plain(
      pre, post, valid, valid, (gm, gm), 160, (40, 40), None, 2, 0.5, 5)
  got = k5()
  check(same_bits(got, k5()), 'K5 does not repeat bit for bit')
  print('  a second launch repeats the first bit for bit')
  ref = k5p()
  check(bool(torch.isnan(got[0][cls == 2]).all()), 'K5: dead rows not NaN')
  # Each route alone, on its own list (the other's rows stay NaN): the
  # pure pairs on the shared-memory FFT, the impure on the dense DFT.
  lib = _build.library()
  flat = cls.reshape(-1)
  lists = {r: torch.nonzero(flat == c).flatten().to(torch.int32)
           for r, c in (('pure', 1), ('impure', 0))}
  rows = torch.full((4, gm * gm), float('nan'), device=dev)
  route = {
      'pure': lambda: cuda_flow._launch_masked_pure(
          lib, pre, post, lists['pure'], gm, 160, (40, 40), None, 2, 0.5, 5,
          rows),
      'impure': lambda: cuda_flow._launch_masked_dense(
          lib, pre, post, valid, valid, lists['impure'], gm, 160, (40, 40),
          None, 2, 0.5, 5, rows)}
  ms_route = {r: cuda_ms(fn) for r, fn in route.items()}
  check(same_bits(rows.reshape(4, gm, gm), got),
        'K5: the routes alone differ from the whole call')
  nbytes = 4 * N * N * 4 + 16 * gm * gm
  report['K5'] = dict(compare_flow(got, ref, 'K5', STAT_FRACTION_MASKED),
                      ms=cuda_ms(k5),
                      ms_pure=ms_route['pure'], ms_impure=ms_route['impure'],
                      plain_ms=wall_ms(k5p), library_ms=None,
                      dead=n_dead, pure=n_pure, impure=n_impure,
                      bound_ms_pure=least_time(
                          nbytes, masked_flops(160, n_pure, 0))['bound_ms'],
                      bound_ms_impure=least_time(
                          nbytes, masked_flops(160, 0, n_impure))['bound_ms'],
                      **least_time(nbytes,
                                   masked_flops(160, n_pure, n_impure)))
  r5 = report['K5']
  print(f'  kernel {r5["ms"]:.3f} ms (before {K5_PRIOR_MS}; routes alone: '
        f'pure {r5["ms_pure"]:.3f} ms, bound {r5["bound_ms_pure"]:.3f}; '
        f'impure {r5["ms_impure"]:.3f} ms, bound '
        f'{r5["bound_ms_impure"]:.3f}), plain {r5["plain_ms"]:.3f} ms, bound '
        f'{r5["bound_ms"]:.3f} ms ({r5["bound_by"]})')


def k1_k2_phase(report, pre, post, _build, rng) -> None:
  """K1 and K2 at the stack path's shapes on the 10k^2 pair (both on the
  FFT route; K2's offsets drawn from `rng`), and K1's dense-DFT route at
  p = 192."""
  from sofima_tpu_torch.ops import cuda_flow
  image_bytes = 2 * N * N * 4

  # K1: the coarse pass, p = step = 160 on the 10k^2 pair.
  print('K1 dense_flow_peaks, 10k^2, p = s = 160')
  k1 = lambda: cuda_flow.dense_flow_peaks(pre, post, (160, 160), (160, 160))
  gy = (N - (160 - 160)) // 160
  k1p = lambda: cuda_flow.flow_peaks_plain(
      pre, post, None, (gy, gy), 160, (160, 160), 160, None, 2, 0.5, 5)
  got = fft_route(k1, 'K1', _build)
  report['K1'] = dict(compare_flow(got, k1p(), 'K1'), ms=cuda_ms(k1),
                      plain_ms=wall_ms(k1p),
                      library_ms=None,
                      torch_fft_ms=fft_surfaces_ms(pre, post, None, (gy, gy),
                                                   160, (160, 160)),
                      **dict(zip(('threads', 'blocks_per_sm'),
                                 cuda_flow.flow_fft_config(160, 160))),
                      **least_time(image_bytes + 16 * gy * gy,
                                   gy * gy * xcorr_flops(160)))
  print_flow_times(report['K1'], K1_PRIOR_MS)

  # K1's dense-DFT route, for sizes the FFT route does not serve.
  n_d, p_d, s_d = DFT_ROUTE
  print(f'K1 dense-DFT route, {n_d}^2, p = {p_d}, s = {s_d}')
  pre_d, post_d = (t[:n_d, :n_d].contiguous() for t in (pre, post))
  g_d = (n_d - (p_d - s_d)) // s_d
  kd = lambda: cuda_flow.dense_flow_peaks(pre_d, post_d, (p_d, p_d),
                                          (s_d, s_d))
  kdp = lambda: cuda_flow.flow_peaks_plain(
      pre_d, post_d, None, (g_d, g_d), p_d, (s_d, s_d), p_d, None, 2, 0.5, 5)
  before = _build.launch_counts['flow_peaks_dft']
  got = kd()
  check(_build.launch_counts['flow_peaks_dft'] == before + 1,
        f'K1 at p = {p_d} did not take the dense-DFT route')
  rd = compare_flow(got, kdp(), 'K1 dense-DFT route')
  report['K1'].update(dft_route_p=p_d, dft_route_ms=cuda_ms(kd),
                      dft_route_plain_ms=wall_ms(kdp),
                      dft_route_err=rd['err'],
                      dft_route_stat_frac=rd['stat_frac'])
  print(f'  kernel {report["K1"]["dft_route_ms"]:.3f} ms, plain '
        f'{report["K1"]["dft_route_plain_ms"]:.3f} ms')
  del pre_d, post_d

  # K2: the fine pass, p = 80, s = 40, 4-row blocks. As on the main path,
  # each block's window is targeted near the true shift (7, -12), here
  # with a random error of up to 3 px.
  print('K2 targeted_flow_peaks, 10k^2, p = 80, s = 40, peak_crop = 32')
  geo = cuda_flow.targeted_geometry((N, N), (80, 80), (40, 40), rows=4)
  jitter = rng.randint(-3, 4, size=(geo['nrsteps'], geo['ngroups'], 2))
  offs = torch.from_numpy((jitter + np.array([7, -12])).astype(np.int32))
  offs = offs.to(pre.device)
  k2 = lambda: cuda_flow.dense_flow_peaks_targeted(
      pre, post, offs, (80, 80), (40, 40), max_offset=128, peak_crop=32,
      rows=4)
  ex = torch.repeat_interleave(torch.repeat_interleave(
      offs, 4, 0), geo['group'], 1)[:geo['gy'], :geo['gx']].contiguous()
  k2p = lambda: cuda_flow.flow_peaks_plain(
      pre, post, ex, (geo['gy'], geo['gx']), 80, (40, 40), 32, None, 2,
      0.5, 5)
  n2 = geo['gy'] * geo['gx']
  got = fft_route(k2, 'K2', _build)
  report['K2'] = dict(compare_flow(got, k2p(), 'K2'), ms=cuda_ms(k2),
                      plain_ms=wall_ms(k2p),
                      library_ms=None,
                      torch_fft_ms=fft_surfaces_ms(
                          pre, post, ex, (geo['gy'], geo['gx']), 80,
                          (40, 40)),
                      **dict(zip(('threads', 'blocks_per_sm'),
                                 cuda_flow.flow_fft_config(80, 32))),
                      **least_time(image_bytes + offs.numel() * 4 + 16 * n2,
                                   n2 * xcorr_flops(80)))
  print_flow_times(report['K2'], K2_PRIOR_MS)
  del got


def k3_inputs(g: int, rng, dev):
  """K3's inputs at the stack path's mesh: smooth targets with noise, a
  NaN frame and a NaN block; x0 = targets with NaN at 0."""
  yy, xx = np.mgrid[:g, :g].astype(np.float32)
  prev = np.stack([3.0 * np.sin(xx / 17.0) + rng.randn(g, g) * 0.7,
                   2.0 * np.cos(yy / 23.0) + rng.randn(g, g) * 0.7])
  prev = prev.astype(np.float32)[:, None]
  prev[:, :, :2] = prev[:, :, -2:] = np.nan
  prev[:, :, :, :2] = prev[:, :, :, -2:] = np.nan
  prev[:, :, 100:104, 60:70] = np.nan
  prev_t = torch.from_numpy(prev).to(dev)
  return torch.nan_to_num(prev_t, nan=0.0), prev_t


def fused3d_config():
  """bench.py's mesh3d_fused configuration (cfg3f)."""
  from sofima_tpu_torch import mesh
  return mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0, 40.0),
      num_iters=500, max_iters=1000, stop_v_max=0.0, dt_max=100.0)


def fire_odd_phase(dev, dim: int, rng, shape):
  """K3 (dim 2) or K11 (dim 3) without `prev` on a mesh of `shape` with
  a NaN row on the first tile edge in y, against its plain version.
  Returns the launch plan."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_mesh
  nodes = (1,) * (3 - len(shape)) + shape
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
      num_iters=100, max_iters=400, stop_v_max=0.0, dt_max=100.0,
      prefer_orig_order=dim == 2)
  x = rng.randn(dim, *shape).astype(np.float32) * 3
  plan = cuda_mesh.fire_plan_of(torch.from_numpy(x).to(dev), cfg)
  row = min(plan.tile[1], nodes[1] - 1)
  if dim == 2:
    x[:, row] = np.nan
  else:
    x[:, nodes[0] // 2, row] = np.nan
  xt = torch.from_numpy(x).to(dev)
  if dim == 2:
    run = lambda: cuda_mesh.relax_mesh_fused(xt[:, None], None, cfg)[::2]
    got, steps = run()
    got = got[:, 0]
    ref, _, steps_p = cuda_mesh.relax_mesh_fused_plain(xt, None, cfg)
  else:
    run = lambda: cuda_mesh.relax_mesh_fused_3d(xt, None, cfg)[::2]
    got, steps = run()
    ref, _, steps_p = cuda_mesh.relax_mesh_fused_3d_plain(xt, None, cfg)
  name = 'K3' if dim == 2 else 'K11'
  err = float(torch.nan_to_num((got - ref).abs(), nan=0.0).max())
  print(f'  no prev, {list(x.shape)} nodes (tile {plan.tile}, {plan.npt} '
        f'a thread), a NaN row at y = {row}: steps {int(steps)} (plain '
        f'{steps_p}), max |dx| {err:.3g} px; a second launch repeats it bit '
        'for bit')
  check(int(steps) == int(steps_p), f'{name} (no prev) steps differ')
  check(bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
        f'{name} (no prev) NaN pattern differs')
  check(bool(torch.isnan(got).any()), f'{name} (no prev): no NaN row')
  check(err < MESH_TOL, f'{name} (no prev) differs from plain by {err} px')
  again = run()[0]
  check(same_bits(got, again[:, 0] if dim == 2 else again),
        f'{name} (no prev) does not repeat bit for bit')
  return plan


def fire_grid_phase(dev, report, _build) -> None:
  """K3 and K11's grid-stride route on FIRE_GRID's meshes, with a NaN row,
  against their plain versions; then a mesh one node row over the
  reference's VMEM bound, which both packages refuse."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_mesh
  rng = np.random.RandomState(SEED + 14)
  for dim, nodes in FIRE_GRID:
    key = 'K3' if dim == 2 else 'K11'
    cfg = mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
        num_iters=100, max_iters=FIRE_GRID_ITERS, stop_v_max=0.0,
        dt_max=100.0, prefer_orig_order=dim == 2)
    x = rng.randn(dim, *nodes).astype(np.float32) * 3
    x[:, nodes[0] // 2, 37] = np.nan
    xt = torch.from_numpy(x).to(dev)
    prev = torch.zeros_like(xt)
    if dim == 2:
      run = lambda: cuda_mesh.relax_mesh_fused(xt, prev, cfg)
      plain = lambda: cuda_mesh.relax_mesh_fused_plain(xt[:, 0], prev[:, 0],
                                                       cfg)
    else:
      run = lambda: cuda_mesh.relax_mesh_fused_3d(xt, prev, cfg)
      plain = lambda: cuda_mesh.relax_mesh_fused_3d_plain(xt, prev, cfg)
    _build.reset_launch_counts()
    got, _, steps = run()
    sync()
    grid_launches = _build.launch_counts['fused_fire_grid']
    got = got[:, 0] if dim == 2 else got
    ref, _, steps_p = plain()
    err = float(torch.nan_to_num((got - ref).abs(), nan=0.0).max())
    n = int(np.prod(nodes))
    print(f'{key} grid-stride route, {[dim, *nodes]} ({n} nodes, a NaN '
          f'row): steps {int(steps)} (plain {steps_p}), max |dx| {err:.3g} '
          f'px, grid-route launches {grid_launches}')
    check(grid_launches == 1, f'{key} did not take the grid-stride route')
    check(int(steps) == int(steps_p), f'{key} grid route: steps differ')
    check(bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
          f'{key} grid route: NaN pattern differs')
    check(bool(torch.isnan(got).any()), f'{key} grid route: no NaN row')
    check(err < MESH_TOL, f'{key} grid route differs from plain by {err}')
    ms = cuda_ms(run)
    print(f'  kernel {ms:.3f} ms, {ms * 1e3 / int(steps):.2f} us a step')
    report[key].update(grid_route_nodes=[dim, *nodes],
                       grid_route_err=err, grid_route_ms=ms,
                       grid_route_us_per_step=ms * 1e3 / int(steps))
    over = list(nodes)
    over[-1] = cuda_mesh.VMEM_BOUND_BYTES // (16 * dim * int(
        np.prod(nodes[:-1]))) + 1
    try:
      if dim == 2:
        cuda_mesh.relax_mesh_fused(torch.zeros(dim, *over, device=dev),
                                   None, cfg)
      else:
        cuda_mesh.relax_mesh_fused_3d(torch.zeros(dim, *over, device=dev),
                                      None, cfg)
      raised = ''
    except ValueError as e:
      raised = str(e)
    print(f'  {[dim, *over]}: raises "{raised}"')
    check(raised == cuda_mesh.VMEM_MESSAGE,
          f'{key} took {over}, over the reference\'s VMEM bound')
    del xt, prev, got, ref


def stack_slice(dev, report, _build) -> dict:
  """K1-K4 at the stack path's shapes, then the stack path itself.

  Returns the kernels' launch counts from the stack path's run."""
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.ops import interp
  from sofima_tpu_torch.pipeline import stack_align

  tex = texture(N, dev)
  pre = tex.contiguous()
  post = torch.roll(tex, (7, -12), (0, 1)).contiguous()
  rng = np.random.RandomState(SEED + 1)
  k1_k2_phase(report, pre, post, _build, rng)

  # K3: the fused FIRE solve on a 250^2 mesh (headline solver config).
  print('K3 fused_fire, 250^2 nodes')
  g = N // STRIDE
  cfg = headline_config()
  x0, prev_t = k3_inputs(g, rng, dev)
  k3 = lambda: cuda_mesh.relax_mesh_fused(x0, prev_t, cfg.mesh)
  got, _, steps = k3()
  ref, _, steps_p = cuda_mesh.relax_mesh_fused_plain(x0[:, 0], prev_t[:, 0],
                                                     cfg.mesh)
  check(int(steps) == int(steps_p), f'K3 steps {int(steps)} vs {steps_p}')
  check(same_bits(got, k3()[0]), 'K3 does not repeat bit for bit')
  check(bool(torch.equal(torch.isnan(got[:, 0]), torch.isnan(ref))),
        'K3 NaN pattern differs')
  err = float(torch.nan_to_num((got[:, 0] - ref).abs(), nan=0.0).max())
  print(f'  steps {int(steps)} (plain {steps_p}), max |dx| {err:.3g} px; '
        'a second launch repeats it bit for bit')
  check(err < MESH_TOL, f'K3 differs from the plain solver by {err} px')
  report['K3'] = dict(err=err, ms=cuda_ms(k3), plain_ms=wall_ms(
      lambda: cuda_mesh.relax_mesh_fused_plain(x0[:, 0], prev_t[:, 0],
                                               cfg.mesh)), library_ms=None,
                      steps=int(steps),
                      **least_time(3 * 2 * g * g * 4,
                                   int(steps) * g * g
                                   * FIRE2D_FLOPS_NODE_STEP))
  report['K3']['us_per_step'] = report['K3']['ms'] * 1e3 / int(steps)
  print(f'  kernel {report["K3"]["ms"]:.3f} ms (before the redesign '
        f'{K3_PRIOR_MS}), {report["K3"]["us_per_step"]:.3f} us a step, plain '
        f'{report["K3"]["plain_ms"]:.3f} ms, bound '
        f'{report["K3"]["bound_ms"]:.3f} ms')
  fire_odd_phase(dev, 2, np.random.RandomState(SEED + 11), FIRE_ODD[2])
  plan = fire_odd_phase(dev, 2, np.random.RandomState(SEED + 13),
                        FIRE_MULTI)
  check(plan.npt > 1, f'K3 takes one node a thread on {FIRE_MULTI}')

  # K4: a 10k^2 render through a ~100 px displacement, each method against
  # its plain version; the bilinear render also by grid_sample. The kernel
  # stages every warp tile's source window in shared memory on this
  # smooth field; a field of random positions makes every tile gather
  # from global memory.
  print('K4 warp_gather, 10k^2, all four methods')
  node = torch.arange(g + 1, dtype=torch.float32, device=dev) * STRIDE
  disp = torch.stack([
      100.3 + 5.0 * torch.sin(node[None, :] / 900.0).expand(g + 1, g + 1),
      -97.6 + 5.0 * torch.cos(node[:, None] / 700.0).expand(g + 1, g + 1)])
  dense = interp.upsample_map_linear(disp, STRIDE, (0, 0), (N, N))
  ys = torch.arange(N, dtype=torch.float32, device=dev)
  coords = torch.stack([dense[0] + ys[:, None], dense[1] + ys[None, :]])
  coords = coords[None].contiguous()
  del dense
  img = tex[None].contiguous()
  k4 = {m: (lambda m=m: cuda_warp.shift_warp(img, coords, m))
        for m in K4_METHODS}
  errs = {m: float((k4[m]() - cuda_warp.shift_warp_plain(img, coords, m))
                   .abs().max()) for m in K4_METHODS}
  for m in K4_METHODS:
    check(errs[m] < RENDER_TOL, f'K4 ({m}) differs from plain by {errs[m]}')
  stats = torch.zeros(2, dtype=torch.int32, device=dev)
  cuda_warp.shift_warp(img, coords, 'lanczos', tile_stats=stats)
  staged, tiles = stats.tolist()
  # Random positions (the direct branch): 2048^2 outputs over the image.
  rc = torch.from_numpy(np.random.RandomState(SEED + 2).rand(
      1, 2, K4_RANDOM, K4_RANDOM).astype(np.float32) * N).to(dev)
  errs_rand = {}
  for m in K4_METHODS:
    stats.zero_()
    got = cuda_warp.shift_warp(img, rc, m, tile_stats=stats)
    errs_rand[m] = float((got - cuda_warp.shift_warp_plain(img, rc, m))
                         .abs().max())
    check(errs_rand[m] < RENDER_TOL,
          f'K4 ({m}, random) differs from plain by {errs_rand[m]}')
    check(stats[0].item() == 0 and stats[1].item() > 0,
          f'K4 ({m}, random) staged {stats.tolist()}')
  del rc, got
  print('  max |diff| vs plain, gray levels: ' + ', '.join(
      f'{m} {errs[m]:.3g}' for m in K4_METHODS) + f' (bar {RENDER_TOL}); '
      f'{staged} of {tiles} warp tiles staged (Lanczos)')
  print(f'  random positions ({K4_RANDOM}^2, every tile direct): ' + ', '.join(
      f'{m} {errs_rand[m]:.3g}' for m in K4_METHODS))
  # The library call computes the bilinear render: grid_sample with zero
  # padding and align_corners=True on normalized (x, y) coordinates.
  grid = torch.stack([coords[0, 1] * (2.0 / (N - 1)) - 1.0,
                      coords[0, 0] * (2.0 / (N - 1)) - 1.0], dim=-1)[None]
  lib = lambda: torch.nn.functional.grid_sample(
      img[None], grid, mode='bilinear', padding_mode='zeros',
      align_corners=True)
  lib_err = float((lib()[0, 0] - k4['linear']()[0]).abs().max())
  ms4 = {m: cuda_ms(k4[m]) for m in K4_METHODS}
  report['K4'] = dict(err=errs['lanczos'], ms=ms4['lanczos'],
                      plain_ms=wall_ms(
      lambda: cuda_warp.shift_warp_plain(img, coords, 'lanczos')),
                      ms_linear=ms4['linear'],
                      ms_nearest=ms4['nearest'], ms_cubic=ms4['cubic'],
                      max_abs_err_by_method=errs,
                      max_abs_err_random=errs_rand,
                      staged_tiles=staged, tiles=tiles,
                      staged_share=staged / max(tiles, 1),
                      library_ms=cuda_ms(lib), library_max_abs_diff=lib_err,
                      bound_ms_linear=least_time(
                          16 * N * N, LINEAR_FLOPS_PX * N * N)['bound_ms'],
                      **least_time(16 * N * N, LANCZOS_FLOPS_PX * N * N))
  r4 = report['K4']
  print(f'  kernel: Lanczos {r4["ms"]:.3f} ms (before {K4_PRIOR_MS}), bilinear '
        f'{r4["ms_linear"]:.3f} ms (before {K4_PRIOR_MS_LINEAR}), nearest '
        f'{r4["ms_nearest"]:.3f}, cubic {r4["ms_cubic"]:.3f}; plain '
        f'{r4["plain_ms"]:.3f} ms; bound {r4["bound_ms"]:.3f} ms (bilinear '
        f'{r4["bound_ms_linear"]:.3f}); grid_sample (bilinear) '
        f'{r4["library_ms"]:.3f} ms, |K4 - grid_sample| {lib_err:.3g}')
  del coords, img, grid, k4

  k5_phase(dev, report, pre, post)

  print(f'stack: {N_Z} sections of {N}^2 (bench.py runs 16; cut for time)')
  stack = make_stack(post, N_Z)
  del pre, post, tex

  # Main path: align_stack_pipelined, headline config, uint8 output.
  stack_align.align_stack_pipelined(stack, cfg, out_dtype=torch.uint8)
  sync()
  _build.reset_launch_counts()
  timings = {}
  t0 = time.perf_counter()
  rendered, solved, overflow = stack_align.align_stack_pipelined(
      stack, cfg, out_dtype=torch.uint8, timings=timings)
  sync()
  wall = time.perf_counter() - t0
  launches = dict(_build.launch_counts)
  mpix = (N_Z - 1) * N * N / wall / 1e6
  inter = (slice(320, -320), slice(320, -320))
  base_i = stack[0][inter].float()
  errs = [float((rendered[z][inter].float() - base_i).abs().mean())
          for z in range(1, N_Z)]
  raw = float((stack[N_Z - 1][inter].float() - base_i).abs().mean())
  print('stack path: align_stack_pipelined (max_displacement=128, '
        'residual=6, render_two_pass, peak_crop=32, num_iters=125, uint8)')
  print('  phase seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s, {mpix:.1f} Mpix/s over {N_Z - 1} sections')
  print(f'  worst interior error {max(errs):.3f} (gate {MAX_ERR}; '
        f'unaligned {raw:.2f}), overflow {bool(overflow)}')
  print(f'  launches {launches}')
  check(tuple(rendered.shape) == (N_Z, N, N), 'rendered shape')
  check(tuple(solved.shape) == (N_Z, 2, 1, g, g), 'solved shape')
  check(bool(torch.isfinite(solved).all()), 'solved mesh is not finite')
  check(max(errs) <= MAX_ERR, f'interior error {max(errs)} > {MAX_ERR}')
  check(not bool(overflow), 'envelope overflow on the main path')
  for k in ('dense_flow_peaks', 'targeted_flow_peaks', 'fused_fire',
            'warp_gather', 'invert_section', 'fill_invalid'):
    check(launches[k] > 0, f'kernel {k} was not launched on the stack path')
  check(launches['flow_peaks_dft'] == 0,
        'K1/K2 took the dense-DFT route on the stack path')
  check(launches['fused_fire_grid'] == 0,
        'K3 took the grid-stride route on the stack path')
  # Launches by route: the dense-DFT route's counter (K1's and K2's
  # together) is 0 here, so every launch of each took the FFT route.
  for key, name in (('K1', 'dense_flow_peaks'), ('K2', 'targeted_flow_peaks')):
    report[key].update(launches_fft=launches[name],
                       launches_dft=launches['flow_peaks_dft'])
  report['stack_cold'] = dict(wall_s=wall, mpix_s=mpix, max_err=max(errs),
                              **timings)
  invert_phase(report, solved, cfg, launches)
  del rendered, solved

  # Small input: the card's run against the plain versions on the CPU.
  n_s = 480
  small = stack[:3, :n_s, :n_s].contiguous()
  cfg_s = dataclasses.replace(cfg, max_displacement=64, residual=8)
  r_gpu, s_gpu, o_gpu = stack_align.align_stack_pipelined(small, cfg_s)
  r_cpu, s_cpu, o_cpu = stack_align.align_stack_pipelined(small.cpu(), cfg_s)
  d = float((s_gpu.cpu() - s_cpu).abs().max())
  print(f'small input ({n_s}^2 x 3): mesh max |diff| vs CPU plain path '
        f'{d:.3g} px, overflow {bool(o_gpu)} / {bool(o_cpu)}')
  check(d < SMALL_MESH_TOL, 'small-input meshes differ')
  check(bool(o_gpu) == bool(o_cpu), 'small-input overflow flags differ')
  check(bool(torch.isfinite(r_gpu).all()), 'small-input render not finite')
  return launches, stack


def invert_phase(report, solved, cfg, launches) -> None:
  """The invert layer on the stack path's solved meshes: `_invert_phase`
  for each of INVERT_BATCHES sections (the moving ones, in turn) against
  the plain chain on a CPU copy of the same inputs (the plain version's
  home: the card's plain chain rounds some positions of ~10^4 px a unit
  in the last place, 1e-3 px, away from it), the inversion alone too (its
  NaNs are the gate's); times by CUDA events, the plain chain's on the
  card under `plain_kernels`."""
  from sofima_tpu_torch import map_utils
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.ops import cuda_invert
  from sofima_tpu_torch.pipeline import stack_align
  g = solved.shape[-1]
  names = ('invert_section', 'fill_invalid')
  print(f'invert: _invert_phase on the stack path\'s solved meshes ({g}^2)')
  rows = {}
  for nb in INVERT_BATCHES:
    idx = 1 + torch.arange(nb, device=solved.device) % (solved.shape[0] - 1)
    x = solved[idx[0]] if nb == 1 else solved[idx]
    calls, kernel = [], cuda_invert.invert_section

    def record(*args, kernel=kernel, calls=calls):
      out = kernel(*args)
      calls.append((args, out.clone()))
      return out

    before = {k: _build.launch_counts[k] for k in names}
    cuda_invert.invert_section = record
    try:
      rel, inv = stack_align._invert_phase(x, cfg)
    finally:
      cuda_invert.invert_section = kernel
    own = sum(_build.launch_counts[k] - before[k] for k in names)
    check(len(calls) == 1, f'invert: {len(calls)} kernel inversions a call')
    args, inv_k = calls[0]
    inv_p = map_utils._invert_section_plain(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    rel_p, _ = stack_align._invert_phase(x.cpu(), cfg)
    # inv_abs is rel_inv + the node grid, the same add on both sides.
    errs = []
    for what, a, b in (('inversion', inv_k, inv_p), ('rel_inv', rel, rel_p)):
      a = a.cpu()
      check(bool(torch.equal(torch.isnan(a), torch.isnan(b))),
            f'invert ({nb}): the {what} NaN pattern differs from plain')
      errs.append(float(torch.nan_to_num((a - b).abs(), nan=0.0).max()))
      check(errs[-1] <= INVERT_TOL,
            f'invert ({nb}): the {what} differs from plain by {errs[-1]} px')
    check(own <= INVERT_LAUNCHES, f'invert ({nb}): {own} launches a call')
    with plain_kernels():
      rel_c, _ = stack_align._invert_phase(x, cfg)
    err_card = float(torch.nan_to_num((rel - rel_c).abs(), nan=0.0).max())
    nan_share = float(torch.isnan(inv_k).any(dim=-3).float().mean())
    ms = cuda_ms(lambda: stack_align._invert_phase(x, cfg), reps=20)
    with plain_kernels():
      plain = wall_ms(lambda: stack_align._invert_phase(x, cfg))
    # Least traffic: the mesh in, the two maps out, float32.
    rows[nb] = dict(err=max(errs), ms=ms, plain_ms=plain, launches_call=own,
                    nan_share=nan_share, max_abs_err_card_plain=err_card,
                    **least_time(3 * 2 * g * g * 4 * nb,
                                 INVERT_FLOPS_NODE * g * g * nb))
    print(f'  {nb} section(s): max |diff| vs plain (CPU) {max(errs):.3g} px '
          f'(inversion {errs[0]:.3g}; bar {INVERT_TOL}), NaN patterns equal '
          f'({nan_share:.3%} of the inversion NaN); rel_inv vs the card\'s '
          f'plain chain {err_card:.3g} px; {own} launches a call (at most '
          f'{INVERT_LAUNCHES}); kernels {ms:.3f} ms, plain (card) '
          f'{plain:.3f} ms, bound {rows[nb]["bound_ms"]:.3g} ms '
          f'({rows[nb]["bound_by"]})')
  one, block = (rows[nb] for nb in INVERT_BATCHES)
  report['INV'] = dict(
      one, err=max(r['err'] for r in rows.values()), library_ms=None,
      ms_block=block['ms'], plain_ms_block=block['plain_ms'],
      bound_ms_block=block['bound_ms'], launches_call_block=block[
          'launches_call'], block_sections=INVERT_BATCHES[1],
      launches_fill_invalid=launches['fill_invalid'])


def dense_flow_peaks_plain(pre, post, patch_size=(160, 160), step=(40, 40),
                           mean=None, min_distance=2, threshold_rel=0.5,
                           peak_radius=5):
  """K1's plain version with K1's wrapper signature."""
  from sofima_tpu_torch.ops import cuda_flow
  p, (sy, sx) = patch_size[0], step
  h, w = pre.shape
  return cuda_flow.flow_peaks_plain(
      pre.to(torch.float32).contiguous(), post.to(torch.float32).contiguous(),
      None, ((h - (p - sy)) // sy, (w - (p - sx)) // sx), p, (sy, sx), p,
      mean, min_distance, threshold_rel, peak_radius)


def shift_warp_plain(images, coords, method='lanczos', counter=None):
  """K4's plain version with K4's wrapper signature."""
  from sofima_tpu_torch.ops import cuda_warp
  del counter
  return cuda_warp.shift_warp_plain(images, coords, method)



@contextlib.contextmanager
def recorded_calls(calls: dict, keep: dict | None = None):
  """Records a copy of the arguments of every K1, K4, K6, K8, K9 and K13
  wrapper call into `calls[name]` (K4's under its launch counter's name:
  'warp_gather', 'warp_subvolume' or 'ndimage_warp'; the wrappers still
  launch and count), so that each kernel can be held against its plain
  version at a path's own shapes. `keep[name] = k` bounds what is kept
  of a name to its first k - 1 calls and its latest one."""
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.ops import cuda_warp
  keep = keep or {}
  saved = [(mod, name, getattr(mod, name)) for mod, name in (
      (cuda_flow, 'dense_flow_peaks'), (cuda_flow, 'flow_peaks'),
      (cuda_warp, 'shift_warp'), (cuda_mesh, 'force_2d'),
      (cuda_mesh, 'force_3d'), (cuda_warp, 'shift_warp_3d'))]

  def recorder(name, fn):
    def call(*args, **kwargs):
      key = kwargs.get('counter', 'warp_gather') if name == 'shift_warp' \
          else name
      kept = calls.setdefault(key, [])
      if key in keep and len(kept) >= keep[key]:
        kept.pop()
      kept.append(tuple(
          a.clone() if isinstance(a, torch.Tensor) else a for a in args))
      return fn(*args, **kwargs)
    return call

  for mod, name, fn in saved:
    setattr(mod, name, recorder(name, fn))
  try:
    yield
  finally:
    for mod, name, fn in saved:
      setattr(mod, name, fn)


@contextlib.contextmanager
def plain_kernels():
  """Routes K1, K5, K6, K7, K4, K8, K9, K13 and the invert layer's kernels
  (2d inversion, hole and nearest fill) to their plain versions on the
  card's tensors, so that a path can be run once with its kernels and
  once without."""
  from sofima_tpu_torch import map_utils
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_invert
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.ops import fill
  k1, k5 = cuda_flow.dense_flow_peaks, cuda_flow.masked_dense_flow_peaks
  k6, k7 = cuda_flow.flow_peaks, cuda_flow.corr_patches
  k4, k8 = cuda_warp.shift_warp, cuda_mesh.force_2d
  k9, k13 = cuda_mesh.force_3d, cuda_warp.shift_warp_3d
  inv = (cuda_invert.invert_section, cuda_invert.fill_invalid,
         cuda_invert.nearest_fill)

  def k5_plain(pre, post, pre_valid, post_valid, patch_size, step,
               mean=None, min_distance=2, threshold_rel=0.5, peak_radius=5):
    p, (sy, sx) = patch_size[0], step
    h, w = pre.shape
    pre = pre.to(torch.float32).contiguous()
    return cuda_flow.masked_flow_peaks_plain(
        pre, post.to(torch.float32).contiguous(),
        cuda_flow._valid_plane(pre_valid, pre),
        cuda_flow._valid_plane(post_valid, pre),
        ((h - (p - sy)) // sy, (w - (p - sx)) // sx), p, (sy, sx), mean,
        min_distance, threshold_rel, peak_radius)

  cuda_flow.dense_flow_peaks = dense_flow_peaks_plain
  cuda_flow.masked_dense_flow_peaks = k5_plain
  cuda_flow.flow_peaks = cuda_flow.patch_flow_peaks_plain
  cuda_flow.corr_patches = cuda_flow.corr_patches_plain
  def k13_plain(volume, coords, method, *bounds_origin, tile_stats=None):
    del tile_stats
    bo = list(bounds_origin) + [0] * (9 - len(bounds_origin))
    return cuda_warp.shift_warp_3d_plain(volume, coords, method, bo[:6],
                                         bo[6:])

  cuda_warp.shift_warp = shift_warp_plain
  cuda_mesh.force_2d = mesh.inplane_force_plain
  cuda_mesh.force_3d = mesh.elastic_mesh_3d_plain
  cuda_warp.shift_warp_3d = k13_plain
  cuda_invert.invert_section = map_utils._invert_section_plain
  cuda_invert.fill_invalid = fill.fill_invalid_plain
  cuda_invert.nearest_fill = fill.nearest_fill_plain
  try:
    yield
  finally:
    (cuda_invert.invert_section, cuda_invert.fill_invalid,
     cuda_invert.nearest_fill) = inv
    cuda_flow.dense_flow_peaks, cuda_flow.masked_dense_flow_peaks = k1, k5
    cuda_flow.flow_peaks, cuda_flow.corr_patches = k6, k7
    cuda_warp.shift_warp, cuda_mesh.force_2d = k4, k8
    cuda_mesh.force_3d, cuda_warp.shift_warp_3d = k9, k13


def masked_warm_slice(dev, report, _build, stack) -> dict:
  """The masked coarse-to-fine path and the warm-start stack path.

  Returns the launch counts of the masked path's run."""
  from sofima_tpu_torch import flow_field
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.pipeline import stack_align

  # Masked coarse-to-fine on the stack's first pair. The transport's
  # residual envelope is sized for the stack's wobble (7 px over 2500).
  kw = dict(max_displacement=128, residual=16, return_overflow=True)
  pre, post = stack[0].float(), stack[1].float()
  print('masked coarse-to-fine, pair (0, 1) of the 10k^2 stack')
  none = torch.zeros((N, N), dtype=torch.bool, device=dev)
  # An all-valid mask against the unmasked targeted path, on the pair
  # and on section 0 against itself rolled by (23, -31) px as the JAX
  # test does: both paths measure integer peaks, so on the stack's
  # fractional flows they split rounding ties differently (never by
  # more than 1 px), and on an integer shift they agree.
  exact = {}
  for name, q in (('pair (0, 1)', post),
                  ('integer shift', torch.roll(pre, (23, -31), (0, 1)))):
    masked, ov_m = flow_field.coarse_to_fine_flow(pre, q, pre_mask=none,
                                                  post_mask=none, **kw)
    targeted, ov_t = flow_field.coarse_to_fine_flow(pre, q, **kw)
    sl = (slice(2, -2), slice(2, -2))
    dx = (masked[0][sl] - targeted[0][sl]).abs()
    dy = (masked[1][sl] - targeted[1][sl]).abs()
    fin = torch.isfinite(dx) & torch.isfinite(dy)
    exact[name] = float(((dx == 0) & (dy == 0))[fin].float().mean())
    worst = float(torch.maximum(dx, dy)[fin].max())
    print(f'  all-valid mask vs the unmasked targeted path, {name}: exact '
          f'{exact[name]:.4f}, worst {worst:.1f} px (bar 1), overflow '
          f'{bool(ov_m)} / {bool(ov_t)}')
    check(worst <= 1.0, 'masked transport: more than 1 px from targeted')
    check(not bool(ov_m) and not bool(ov_t), 'masked c2f overflow')
  check(exact['integer shift'] >= TRANSPORT_EXACT,
        f'masked transport: exact share below {TRANSPORT_EXACT}')
  mask = bench_mask(N, dev)
  flow_field.coarse_to_fine_flow(pre, post, pre_mask=mask, post_mask=mask,
                                 **kw)  # warm-up
  sync()
  _build.reset_launch_counts()
  t0 = time.perf_counter()
  got, ov = flow_field.coarse_to_fine_flow(pre, post, pre_mask=mask,
                                           post_mask=mask, **kw)
  sync()
  wall = time.perf_counter() - t0
  launches = dict(_build.launch_counts)
  t0 = time.perf_counter()
  with plain_kernels():
    ref, ov_ref = flow_field.coarse_to_fine_flow(pre, post, pre_mask=mask,
                                                 post_mask=mask, **kw)
  sync()
  wall_plain = time.perf_counter() - t0
  both = torch.isfinite(got[:2]).all(0) & torch.isfinite(ref[:2]).all(0)
  same_nan = torch.equal(torch.isnan(got[0]), torch.isnan(ref[0]))
  bad = (got[:2] != ref[:2]).any(0) & both
  xy_bad = int(bad.sum())
  worst = float((got[:2] - ref[:2]).abs()[:, both].max())
  print(f'  bench mask: card {wall:.3f} s, plain path on the card '
        f'{wall_plain:.1f} s; {int(both.sum())} nodes finite in both, x/y '
        f'differ at {xy_bad} (worst {worst:.0f} px), NaN pattern equal '
        f'{same_nan}, valid share {float(both.float().mean()):.3f}, overflow '
        f'{bool(ov)} / {bool(ov_ref)}; launches {launches}')
  for i, j in bad.nonzero().tolist()[:5]:
    print(f'    node ({i}, {j}): card {got[:, i, j].tolist()}, plain '
          f'{ref[:, i, j].tolist()}')
  check(same_nan and worst <= 1.0
        and xy_bad <= MASKED_TIE_SHARE * int(both.sum()),
        'masked c2f differs from the plain path')
  check(not bool(ov) and not bool(ov_ref), 'masked c2f overflow')
  # Both passes hold pure and impure pairs: each launches both routes.
  check(launches['masked_flow_peaks'] == 2,
        'K5\'s dense route launches on the masked path')
  check(launches['masked_flow_pure'] == 2,
        'K5\'s pure route launches on the masked path')
  check(launches['warp_gather'] == 2, 'K4 (nearest) launches on masked path')
  report['path_masked'] = dict(wall_s=wall, plain_s=wall_plain,
                               xy_differ=xy_bad,
                               exact_all_valid_pair=exact['pair (0, 1)'],
                               exact_all_valid_int=exact['integer shift'],
                               valid_share=float(both.float().mean()))
  del masked, targeted, got, ref, none, mask, pre, post

  # Warm-start stack path: the headline config with warm_start.
  cfg = dataclasses.replace(headline_config(), warm_start=True)
  _build.reset_launch_counts()
  timings = {}
  t0 = time.perf_counter()
  rendered, solved, overflow = stack_align.align_stack_pipelined(
      stack, cfg, out_dtype=torch.uint8, timings=timings)
  sync()
  wall = time.perf_counter() - t0
  warm_l = dict(_build.launch_counts)
  inter = (slice(320, -320), slice(320, -320))
  base_i = stack[0][inter].float()
  errs = [float((rendered[z][inter].float() - base_i).abs().mean())
          for z in range(1, N_Z)]
  refreshes = warm_l['dense_flow_peaks'] - 1
  cold = report['stack_cold']
  print('warm-start stack path: align_stack_pipelined, headline config, '
        'warm_start=True')
  print('  phase seconds (cold): ' + ', '.join(
      f'{k} {timings[k]:.3f} ({cold[k]:.3f})' for k in timings))
  print(f'  wall {wall:.3f} s ({cold["wall_s"]:.3f} cold), '
        f'{(N_Z - 1) * N * N / wall / 1e6:.1f} Mpix/s; worst interior error '
        f'{max(errs):.3f} ({cold["max_err"]:.3f} cold; gate {MAX_ERR}), '
        f'overflow {bool(overflow)}; refreshes {refreshes}; launches {warm_l}')
  check(max(errs) <= MAX_ERR, f'warm interior error {max(errs)} > {MAX_ERR}')
  check(not bool(overflow), 'envelope overflow on the warm path')
  check(warm_l['flow_peaks_dft'] == 0,
        'K1/K2 took the dense-DFT route on the warm path')
  check(refreshes >= 0 and warm_l['targeted_flow_peaks'] == N_Z - 1
        + refreshes, 'K1 launched beyond pair 0 and the refreshes')
  report['stack_warm'] = dict(wall_s=wall, max_err=max(errs),
                              refreshes=refreshes,
                              k1_launches=warm_l['dense_flow_peaks'],
                              k2_launches=warm_l['targeted_flow_peaks'],
                              **timings)
  del rendered, solved

  # A forced refresh: pair 1 jumps 52/-48 px past the fine capture range
  # (tests/test_stack_align.py's case), so pair 0's flow is stale.
  n_s = 640
  base = stack[0][:n_s, :n_s].float()
  yy = torch.arange(n_s, dtype=torch.float32, device=dev)[:, None]
  xx = torch.arange(n_s, dtype=torch.float32, device=dev)[None, :]

  def shifted(dy, dx):
    coords = torch.stack([(yy + dy).expand(n_s, n_s),
                          (xx + dx).expand(n_s, n_s)])[None].contiguous()
    return cuda_warp.shift_warp(base[None].contiguous(), coords, 'linear')[0]

  small = torch.stack([base, shifted(2.0, -3.0), shifted(54.0, -51.0)])
  small = torch.clamp(small + 0.5, 0, 255).to(torch.uint8)
  cfg_s = stack_align.StackAlignConfig(max_displacement=96, residual=16)
  _, s_cold, _ = stack_align.align_stack_pipelined(small, cfg_s)
  _build.reset_launch_counts()
  _, s_warm, _ = stack_align.align_stack_pipelined(
      small, dataclasses.replace(cfg_s, warm_start=True))
  forced = dict(_build.launch_counts)
  d = float((s_warm - s_cold).abs().max())
  print(f'forced refresh ({n_s}^2 x 3, 52/-48 px jump): K1 launches '
        f'{forced["dense_flow_peaks"]} (pair 0 + refresh), K2 '
        f'{forced["targeted_flow_peaks"]}; meshes vs the cold chain {d:.3g} '
        f'px (bar {SMALL_MESH_TOL})')
  check(forced['dense_flow_peaks'] == 2, 'the stale prior was not refreshed')
  check(forced['targeted_flow_peaks'] == 3, 'K2 launches on the refresh')
  check(d < SMALL_MESH_TOL, 'refreshed meshes differ from the cold chain')
  report['refresh'] = dict(mesh_max_diff=d)
  return launches


def texture3d(shape, seed: int, dev) -> torch.Tensor:
  """bench.py's band-limited 3d texture in [0, 255] (sigma 0.12)."""
  rng = np.random.RandomState(seed)
  noise = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)
  f = torch.fft.rfftn(noise.double())
  del noise
  fz = torch.fft.fftfreq(shape[0], device=dev, dtype=torch.float64)
  fy = torch.fft.fftfreq(shape[1], device=dev, dtype=torch.float64)
  fx = torch.fft.rfftfreq(shape[2], device=dev, dtype=torch.float64)
  f *= torch.exp(-((fx[None, None, :] ** 2 + fy[None, :, None] ** 2
                    + fz[:, None, None] ** 2) / (2 * 0.12 ** 2)))
  vol = torch.fft.irfftn(f, s=shape).float()
  del f
  return (vol - vol.min()) / (vol.max() - vol.min()) * 255.0


def liconn_inputs(vol: torch.Tensor, tile_yx: int, overlap: int):
  """bench.py's 2 x 2 tile grid over `vol` with its coarse offsets."""
  step = tile_yx - overlap
  tiles = {(tx, ty): vol[:, ty * step:ty * step + tile_yx,
                         tx * step:tx * step + tile_yx].contiguous()
           for ty in range(2) for tx in range(2)}
  cx = np.full((3, 1, 2, 2), np.nan)
  cx[:, 0, :, 0] = np.array([-overlap, 0.0, 0.0])[:, None]
  cy = np.full((3, 1, 2, 2), np.nan)
  cy[:, 0, 0, :] = np.array([0.0, -overlap, 0.0])[:, None]
  coarse = np.zeros((3, 1, 2, 2), np.float32)
  for ty in range(2):
    for tx in range(2):
      coarse[0, 0, ty, tx] = -overlap * tx
      coarse[1, 0, ty, tx] = -overlap * ty
  return tiles, cx, cy, coarse


def k13_phase(dev, report) -> None:
  """K13 at one LICONN tile's render shape (a 64 x 576 x 576 tile renders
  128 x 640 x 640 voxels with its 2-node halo at stride 16): coordinates
  of a smooth ~1.5 px residual with NaN holes, bounds as the render
  buckets them (every block tile staged), in linear and Lanczos against
  the plain version and beside the 5-D grid_sample; then random
  positions over the volume (every block tile direct)."""
  from sofima_tpu_torch.ops import cuda_warp
  zdim, tile_yx, _ = LICONN
  halo = 2 * 16
  oz, oy, ox = zdim + 2 * halo, tile_yx + 2 * halo, tile_yx + 2 * halo
  print(f'K13 warp_gather_3d, {zdim} x {tile_yx} x {tile_yx} -> '
        f'{oz} x {oy} x {ox}')
  vol = texture3d((zdim, tile_yx, tile_yx), SEED + 4, dev)
  org = (-halo, -halo, -halo)
  zz = torch.arange(oz, dtype=torch.float32, device=dev)[:, None, None] - halo
  yy = torch.arange(oy, dtype=torch.float32, device=dev)[None, :, None] - halo
  xx = torch.arange(ox, dtype=torch.float32, device=dev)[None, None, :] - halo
  coords = torch.stack([
      (zz + 0.6 * torch.sin(yy / 57.0)).expand(oz, oy, ox),
      (yy + 1.5 * torch.cos(xx / 83.0 + zz / 40.0)).expand(oz, oy, ox),
      (xx + 1.4 * torch.sin(yy / 61.0 + 0.3)).expand(oz, oy, ox)]).contiguous()
  coords[:, oz // 2, 10:20, 30:90] = float('nan')
  bnds = (-2, 2, -4, 4, -4, 4)
  k13 = {m: (lambda m=m: cuda_warp.shift_warp_3d(vol, coords, m, *bnds,
                                                  *org))
         for m in ('linear', 'lanczos')}
  errs = {m: float((k13[m]() - cuda_warp.shift_warp_3d_plain(
      vol, coords, m, bnds, org)).abs().max()) for m in k13}
  stats = torch.zeros(2, dtype=torch.int32, device=dev)
  cuda_warp.shift_warp_3d(vol, coords, 'lanczos', *bnds, *org,
                          tile_stats=stats)
  staged, tiles = stats.tolist()
  print(f'  max |diff| trilinear {errs["linear"]:.3g}, Lanczos '
        f'{errs["lanczos"]:.3g} gray levels; {staged} of {tiles} block '
        f'tiles staged (Lanczos)')
  for m in k13:
    check(errs[m] < RENDER_TOL, f'K13 ({m}) differs from plain by {errs[m]}')
  # Random positions over the volume, bounds wide enough that every tap
  # is live: no block tile's brick fits its budget.
  rz, ry, rx = K13_RANDOM
  rc = torch.from_numpy(np.random.RandomState(SEED + 5).rand(
      3, rz, ry, rx).astype(np.float32) * np.array(
          [zdim, tile_yx, tile_yx], np.float32)[:, None, None, None]).to(dev)
  wide = (-rz, zdim, -ry, tile_yx, -rx, tile_yx)
  errs_rand = {}
  for m in k13:
    stats.zero_()
    got = cuda_warp.shift_warp_3d(vol, rc, m, *wide, tile_stats=stats)
    errs_rand[m] = float((got - cuda_warp.shift_warp_3d_plain(
        vol, rc, m, wide, (0, 0, 0))).abs().max())
    check(errs_rand[m] < RENDER_TOL,
          f'K13 ({m}, random) differs from plain by {errs_rand[m]}')
    check(stats[0].item() == 0 and stats[1].item() > 0,
          f'K13 ({m}, random) staged {stats.tolist()}')
  print(f'  random positions ({rz} x {ry} x {rx}, every tile direct): '
        + ', '.join(f'{m} {e:.3g}' for m, e in errs_rand.items()))
  del rc, got
  d, h, w = vol.shape
  norm = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1), 2.0 / (d - 1)],
                      device=dev)
  grid = (torch.stack([coords[2], coords[1], coords[0]], dim=-1) * norm
          - 1.0)[None]
  lib = lambda: torch.nn.functional.grid_sample(
      vol[None, None], grid, mode='bilinear', padding_mode='zeros',
      align_corners=True)
  lib_diff = float(torch.nan_to_num(lib()[0, 0] - k13['linear']()).abs()
                   .max())
  n_out = oz * oy * ox
  nbytes = 16 * n_out + 4 * vol.numel()
  report['K13'] = dict(
      err=errs['linear'], ms=cuda_ms(k13['linear']),
      plain_ms=wall_ms(
          lambda: cuda_warp.shift_warp_3d_plain(vol, coords, 'linear', bnds,
                                                org)),
      max_abs_err_lanczos=errs['lanczos'], ms_lanczos=cuda_ms(k13['lanczos']),
      max_abs_err_random=errs_rand, staged_tiles=staged, tiles=tiles,
      staged_share=staged / max(tiles, 1),
      library_ms=cuda_ms(lib), library_max_abs_diff=lib_diff,
      bound_ms_lanczos=least_time(
          nbytes, LANCZOS3D_FLOPS_VOX * n_out)['bound_ms'],
      **least_time(nbytes, LINEAR3D_FLOPS_VOX * n_out))
  r = report['K13']
  print(f'  kernel: trilinear {r["ms"]:.3f} ms (before {K13_PRIOR_MS}), '
        f'Lanczos {r["ms_lanczos"]:.3f} ms (before {K13_PRIOR_MS_LANCZOS}); '
        f'plain {r["plain_ms"]:.3f} ms; bound {r["bound_ms"]:.3f} ms '
        f'(Lanczos {r["bound_ms_lanczos"]:.3f}); grid_sample '
        f'{r["library_ms"]:.3f} ms (|diff| {lib_diff:.3g}: grid_sample has '
        f'no static bounds)')


def stitch_slice(dev, report, _build) -> dict:
  """K9, K11 and K13 at their paths' shapes, then paths (a), (b), (c).

  Returns the kernels' launch counts from their paths' runs."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.pipeline import stitch3d

  launches = {}
  rng = np.random.RandomState(SEED + 3)

  # K9: bench.py's mesh3d mesh, NaN nodes sprinkled in.
  shape_b = (3,) + MESH3D
  nodes_b = int(np.prod(MESH3D))
  print(f'K9 force3d, {list(shape_b)} nodes with NaN holes')
  xk = torch.from_numpy(rng.randn(*shape_b).astype(np.float32)).to(dev)
  holes = torch.from_numpy(rng.rand(*MESH3D) < 0.001).to(dev)
  xk = torch.where(holes[None], torch.full_like(xk, float('nan')), xk)
  stride_b = (40.0, 40.0, 40.0)
  errs = []
  for prefer in (False, True):
    got = cuda_mesh.force_3d(xk, 0.1, stride_b, prefer)
    ref = mesh.elastic_mesh_3d_plain(xk, 0.1, stride_b, prefer)
    errs.append(float((got - ref).abs().max()))
    check(bool(torch.isfinite(got).all()), 'K9 force not finite')
  err = max(errs)
  print(f'  max |df| {errs[0]:.3g} (prefer_orig_order {errs[1]:.3g})')
  check(err < FORCE_TOL, f'K9 differs from the plain force by {err}')
  k9 = lambda: cuda_mesh.force_3d(xk, 0.1, stride_b)
  check(same_bits(k9(), k9()), 'K9 does not repeat bit for bit')
  report['K9'] = dict(err=err, ms=cuda_ms(k9, reps=20), plain_ms=wall_ms(
      lambda: mesh.elastic_mesh_3d_plain(xk, 0.1, stride_b)),
                      library_ms=None,
                      **least_time(24 * nodes_b,
                                   FORCE3D_FLOPS_NODE * nodes_b))
  print(f'  kernel {report["K9"]["ms"]:.4f} ms (before the redesign '
        f'{K9_PRIOR_MS}), plain {report["K9"]["plain_ms"]:.3f} ms, bound '
        f'{report["K9"]["bound_ms"]:.4f} ms; a second launch repeats it bit '
        'for bit')
  del xk, holes, got, ref

  # K9 on odd meshes: NaN holes on the tile edges (rows 7 / 8 and 15 /
  # 16), across lanes (columns 63 / 64) and inside.
  xo = torch.from_numpy((rng.randn(*K9_ODD) * 5).astype(np.float32))
  xo[:, 0, 1, 15, 5] = xo[:, 1, 3, 16, 64] = xo[:, 0, 4, 36, 70] = np.nan
  xo[:, 1, 0, 7, 63] = np.nan
  xo = xo.to(dev)
  errs_o = []
  for prefer in (False, True):
    got = cuda_mesh.force_3d(xo, 0.1, (40.0, 30.0, 20.0), prefer)
    ref = mesh.elastic_mesh_3d_plain(xo, 0.1, (40.0, 30.0, 20.0), prefer)
    check(bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
          'K9 NaN pattern differs (odd meshes)')
    errs_o.append(float((got - ref).abs().max()))
  print(f'K9 on odd meshes {list(K9_ODD)}, anisotropic stride, NaN holes on '
        f'tile edges: max |df| {errs_o[0]:.3g} (prefer_orig_order '
        f'{errs_o[1]:.3g})')
  check(max(errs_o) < FORCE_TOL, f'K9 differs from plain by {max(errs_o)} '
        'on the odd meshes')
  report['K9']['max_abs_err_odd'] = max(errs_o)
  report['K9']['err'] = max(report['K9']['err'], max(errs_o))
  del xo, got, ref

  # K11: bench.py's mesh3d_fused mesh and config (cfg3f).
  print(f'K11 fused_fire_3d, {[3, *FUSED3D]} nodes, cfg3f')
  cfg3f = fused3d_config()
  nodes_c = int(np.prod(FUSED3D))
  x3f = torch.from_numpy(rng.randn(3, *FUSED3D).astype(np.float32)).to(dev)
  prev3f = torch.zeros_like(x3f)
  got, _, steps = cuda_mesh.relax_mesh_fused_3d(x3f, prev3f, cfg3f)
  ref, _, steps_p = cuda_mesh.relax_mesh_fused_3d_plain(x3f, prev3f, cfg3f)
  check(int(steps) == int(steps_p), f'K11 steps {int(steps)} vs {steps_p}')
  check(same_bits(got, cuda_mesh.relax_mesh_fused_3d(x3f, prev3f, cfg3f)[0]),
        'K11 does not repeat bit for bit')
  check(bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
        'K11 NaN pattern differs')
  err = float(torch.nan_to_num((got - ref).abs(), nan=0.0).max())
  print(f'  steps {int(steps)} (plain {steps_p}), max |dx| {err:.3g} px; '
        'a second launch repeats it bit for bit')
  check(err < MESH_TOL, f'K11 differs from the plain solver by {err} px')
  k11 = lambda: cuda_mesh.relax_mesh_fused_3d(x3f, prev3f, cfg3f)
  report['K11'] = dict(err=err, ms=cuda_ms(k11), plain_ms=wall_ms(
      lambda: cuda_mesh.relax_mesh_fused_3d_plain(x3f, prev3f, cfg3f)),
                       library_ms=None, steps=int(steps),
                       **least_time(3 * 3 * nodes_c * 4, int(steps) * nodes_c
                                    * FIRE3D_FLOPS_NODE_STEP))
  report['K11']['us_per_step'] = report['K11']['ms'] * 1e3 / int(steps)
  print(f'  kernel {report["K11"]["ms"]:.3f} ms (before the redesign '
        f'{K11_PRIOR_MS}), {report["K11"]["us_per_step"]:.3f} us a step, '
        f'plain {report["K11"]["plain_ms"]:.3f} ms, bound '
        f'{report["K11"]["bound_ms"]:.3f} ms')
  fire_odd_phase(dev, 3, np.random.RandomState(SEED + 12), FIRE_ODD[3])
  fire_grid_phase(dev, report, _build)

  k13_phase(dev, report)

  # Path (a): stitch_and_render_3d at bench.py's LICONN geometry.
  zdim, tile_yx, overlap = LICONN
  n3 = 2 * tile_yx - overlap
  print(f'path (a): stitch_and_render_3d, 2 x 2 tiles of {zdim} x {tile_yx}'
        f'^2, union {zdim} x {n3}^2')
  vol3 = texture3d((zdim, n3, n3), 9, dev)
  tiles, cx, cy, coarse = liconn_inputs(vol3, tile_yx, overlap)
  stride3 = (16, 16, 16)
  cfg_s3 = stitch3d.Stitch3dConfig(
      stride=stride3, patch_size=(32, 32, 32), flow_batch=64, margin=8,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=stride3,
          num_iters=400, max_iters=10000, stop_v_max=0.005, dt_max=100.0))
  stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg_s3)  # warm-up
  sync()
  _build.reset_launch_counts()
  timings = {}
  t0 = time.perf_counter()
  out = stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg_s3,
                                      timings=timings)
  sync()
  wall = time.perf_counter() - t0
  launches_a = dict(_build.launch_counts)
  lo_z, lo_yx = 8, 16
  sel = (slice(lo_z, zdim - lo_z), slice(lo_yx, n3 - lo_yx),
         slice(lo_yx, n3 - lo_yx))
  truth = vol3[sel]
  m = out['weights'][sel] > 0
  cnt = int(m.sum())
  rel = float(torch.where(m, (out['canvas'][sel] - truth).abs(),
                          torch.zeros_like(truth)).sum()
              / max(cnt, 1) / truth.std(correction=0))
  cov = cnt / truth.numel()
  mvox = zdim * n3 * n3 / wall / 1e6
  steps = out['solve_steps']
  print('  phase seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s, {mvox:.1f} Mvox/s, solve steps {steps} '
        f'({timings["solve"] / steps * 1e3:.3f} ms per step)')
  print(f'  rel_err {rel:.4f} (gate {STITCH_REL_ERR}), coverage {cov:.4f} '
        f'(gate {STITCH_COVERAGE})')
  print(f'  launches {launches_a}')
  check(bool(torch.isfinite(out['solved']).all()), 'stitch meshes not finite')
  check(rel <= STITCH_REL_ERR, f'stitch3d rel_err {rel}')
  check(cov >= STITCH_COVERAGE, f'stitch3d coverage {cov}')
  for k in ('force3d', 'warp_gather_3d'):
    check(launches_a[k] > 0, f'kernel {k} was not launched on path (a)')
  launches['force3d'] = launches_a['force3d']
  launches['warp_gather_3d'] = launches_a['warp_gather_3d']
  report['path_a'] = dict(wall_s=wall, mvox_s=mvox, solve_steps=steps,
                          rel_err=rel, coverage=cov, **timings)
  stitch_render_phase(dev, report, _build, tiles, out, vol3, sel, stride3,
                      cfg_s3.margin)

  # K9 at path (a)'s solve shape: the batched tile meshes [3, n, gz, gy,
  # gx] (batch and channel strides), moved off rest and with NaN nodes.
  solved = out['solved']
  xa = solved + torch.from_numpy(
      rng.randn(*solved.shape).astype(np.float32) * 2.0).to(dev)
  holes_a = torch.from_numpy(rng.rand(*solved.shape[1:]) < 0.01).to(dev)
  xa = torch.where(holes_a[None], torch.full_like(xa, float('nan')), xa)
  errs_a = []
  for prefer in (False, True):
    got = cuda_mesh.force_3d(xa, 0.1, stride3, prefer)
    ref = mesh.elastic_mesh_3d_plain(xa, 0.1, stride3, prefer)
    errs_a.append(float((got - ref).abs().max()))
    check(bool(torch.isfinite(got).all()), 'K9 force not finite (path a)')
  err_a = max(errs_a)
  # Its time per launch at that shape, beside its bound there: path (a)
  # launches K9 on these meshes, path (b) on the larger one timed above.
  nodes_a = xa[0].numel()
  ms_a = cuda_ms(lambda: cuda_mesh.force_3d(xa, 0.1, stride3), reps=20)
  bound_a = least_time(24 * nodes_a, FORCE3D_FLOPS_NODE * nodes_a)['bound_ms']
  print(f'K9 at path (a)\'s shape {list(xa.shape)}: max |df| '
        f'{errs_a[0]:.3g} (prefer_orig_order {errs_a[1]:.3g}); kernel '
        f'{ms_a:.4f} ms a call (before the redesign {K9_PRIOR_MS_TILE}), '
        f'bound {bound_a:.5f} ms')
  check(err_a < FORCE_TOL, f'K9 differs from the plain force by {err_a} '
        'on the tile meshes')
  report['K9']['max_abs_err_tile_meshes'] = err_a
  report['K9']['ms_tile_meshes'] = ms_a
  report['K9']['bound_ms_tile_meshes'] = bound_a
  report['K9']['err'] = max(report['K9']['err'], err_a)
  del out, tiles, vol3, truth, solved, xa, holes_a, got, ref

  # Path (b): relax_mesh with the 3d force, bench.py's mesh3d stage.
  print(f'path (b): relax_mesh + elastic_mesh_3d, {list(shape_b)}, '
        '200 steps')
  cfg3 = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0, 40.0),
      num_iters=200, max_iters=200, stop_v_max=0.0, dt_max=100.0)
  x3 = torch.from_numpy(rng.randn(*shape_b).astype(np.float32)).to(dev)
  prev3 = torch.zeros_like(x3)
  run_b = lambda: mesh.relax_mesh(x3, prev3, cfg3,
                                  mesh_force=mesh.elastic_mesh_3d)
  run_b()
  sync()
  _build.reset_launch_counts()
  t_b = wall_ms(run_b) / 1e3
  launches_b = dict(_build.launch_counts)
  glups_b = cfg3.num_iters * nodes_b / t_b / 1e9
  print(f'  {t_b:.3f} s, {glups_b:.2f} GLUPS, launches {launches_b}')
  check(launches_b['force3d'] > 0, 'K9 was not launched on path (b)')
  report['path_b'] = dict(seconds=t_b, glups=glups_b,
                          force3d_launches=launches_b['force3d'])
  del x3, prev3

  # Path (c): the fused 3d solver, bench.py's mesh3d_fused stage.
  print(f'path (c): relax_mesh_fused_3d, {[3, *FUSED3D]}, cfg3f')
  _build.reset_launch_counts()
  t_c = wall_ms(k11) / 1e3
  launches_c = dict(_build.launch_counts)
  glups_c = cfg3f.max_iters * nodes_c / t_c / 1e9
  print(f'  {t_c:.4f} s, {glups_c:.2f} GLUPS, launches {launches_c}')
  check(launches_c['fused_fire_3d'] > 0, 'K11 was not launched on path (c)')
  check(launches_c['fused_fire_grid'] == 0,
        'K11 took the grid-stride route on path (c)')
  launches['fused_fire_3d'] = launches_c['fused_fire_3d']
  report['path_c'] = dict(seconds=t_c, glups=glups_c)

  # Small input: path (a) at the CPU tests' geometry, card against CPU.
  vol_s = texture3d((24, 48, 80), 3, dev)
  tiles_s = {(0, 0): vol_s[:, :, :48].contiguous(),
             (1, 0): vol_s[:, :, 32:].contiguous()}
  cx_s = np.full((3, 1, 1, 2), np.nan)
  cx_s[:, 0, 0, 0] = (-16, 0, 0)
  cy_s = np.full((3, 1, 1, 2), np.nan)
  coarse_s = np.zeros((3, 1, 1, 2), np.float32)
  coarse_s[0, 0, 0, 1] = -16
  cfg_small = stitch3d.Stitch3dConfig(
      stride=(8, 8, 8), patch_size=(16, 16, 16), flow_batch=8, margin=2,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(8, 8, 8),
          num_iters=200, max_iters=5000, stop_v_max=0.01, dt_max=100.0))
  g_out = stitch3d.stitch_and_render_3d(tiles_s, cx_s, cy_s, coarse_s,
                                        cfg_small)
  c_out = stitch3d.stitch_and_render_3d(
      {k: v.cpu() for k, v in tiles_s.items()}, cx_s, cy_s, coarse_s,
      cfg_small)
  dm = float((g_out['solved'].cpu() - c_out['solved']).abs().max())
  both = (g_out['weights'].cpu() > 0) & (c_out['weights'] > 0)
  dc = (g_out['canvas'].cpu() - c_out['canvas']).abs()[both]
  print(f'small input (2 tiles of 24 x 48 x 48): mesh max |diff| vs CPU '
        f'{dm:.3g} px (bar {SMALL_MESH_TOL_3D}), canvas mean / max |diff| '
        f'{float(dc.mean()):.3g} / {float(dc.max()):.3g} (bar '
        f'{SMALL_CANVAS_TOL[0]} / {SMALL_CANVAS_TOL[1]}), steps '
        f'{g_out["solve_steps"]} / {c_out["solve_steps"]}')
  check(dm < SMALL_MESH_TOL_3D, 'small-input 3d meshes differ')
  check(float(dc.mean()) < SMALL_CANVAS_TOL[0]
        and float(dc.max()) < SMALL_CANVAS_TOL[1], 'small canvases differ')
  return launches


def small_montage_tiles():
  """tests/test_torch_montage.py's input: a 260^2 texture (seed 3, sigma
  0.1) cut into 2 x 2 tiles of 160 with 60 px overlap (host uint8)."""
  rng = np.random.RandomState(3)
  f = np.fft.rfft2(rng.rand(260, 260).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(260)[None, :] ** 2
                 + np.fft.fftfreq(260)[:, None] ** 2) / (2 * 0.1 ** 2)))
  img = np.fft.irfft2(f, s=(260, 260))
  img = ((img - img.min()) / np.ptp(img) * 255).astype(np.uint8)
  return {(tx, ty): img[ty * 100:ty * 100 + 160, tx * 100:tx * 100 + 160]
          for ty in range(2) for tx in range(2)}


def montage_inputs(dev):
  """bench.py's montage2d input: (source image, 3 x 3 tiles cut from it,
  MontageConfig)."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.pipeline import montage
  grid_t, tile_t, overlap_t = MONTAGE
  step_t = tile_t - overlap_t
  n_m = step_t * (grid_t - 1) + tile_t
  img = texture(N, dev)[:n_m, :n_m].contiguous()
  tiles = {(tx, ty): img[ty * step_t:ty * step_t + tile_t,
                         tx * step_t:tx * step_t + tile_t].contiguous()
           for ty in range(grid_t) for tx in range(grid_t)}
  cfg = montage.MontageConfig(
      stride=40, patch_size=160, coarse_overlaps=(360, 440),
      min_overlap=200, margin=16, flow_batch=256,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
          num_iters=1000, max_iters=20000, stop_v_max=0.005, dt_max=100.0))
  return img, tiles, cfg


def montage_error(canvas, mask, solved, key_to_idx, img, tile_t):
  """bench.py's montage2d measure: mean |canvas - source| over the
  rendered pixels of the interior, after the solve's gauge shift, and
  the share of the interior rendered."""
  i0 = key_to_idx[(0, 0)]
  sx, sy = (int(round(float(solved[c, i0, 0, 0]))) for c in (0, 1))
  n = img.shape[0]
  lo, hi = tile_t // 4, n - tile_t // 4
  truth = img[lo:hi, lo:hi]
  sel = (slice(lo + sy, hi + sy), slice(lo + sx, hi + sx))
  m = mask[sel]
  cnt = int(m.sum())
  err = float(torch.where(m, (canvas[sel] - truth).abs(),
                          torch.zeros_like(truth)).sum()) / max(cnt, 1)
  return err, cnt / truth.numel()


def k8_against_plain(k8_in, rng, label: str) -> float:
  """K8 against its plain version on a joint solve's recorded calls
  (`recorded_calls(...)['force_2d']`): the first and last positions, and
  the last ones moved by seeded 2 px noise with 1% NaN holes, so that
  every link carries a force; both force forms, NaN patterns equal.
  Returns the largest |difference|."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_mesh
  x_end, consts = k8_in[-1][0], k8_in[-1][1:3]
  noise = torch.from_numpy(rng.randn(*x_end.shape).astype(np.float32)
                           * 2.0).to(x_end.device)
  holes = torch.from_numpy(rng.rand(*x_end.shape[1:]) < 0.01).to(
      x_end.device)
  x_moved = torch.where(holes, torch.full_like(x_end, float('nan')),
                        x_end + noise)
  k8e, f_solve, f_moved = 0.0, 0.0, 0.0
  for x in (k8_in[0][0], x_end, x_moved):
    for prefer in (False, True):
      got = cuda_mesh.force_2d(x, *consts, prefer)
      ref = mesh.inplane_force_plain(x, *consts, prefer)
      check(torch.equal(torch.isnan(got), torch.isnan(ref)),
            f'K8 NaN pattern differs on {label}')
      k8e = max(k8e, float(torch.nan_to_num((got - ref).abs()).max()))
      size = float(torch.nan_to_num(ref.abs()).max())
      if x is x_moved:
        f_moved = size
      else:
        f_solve = max(f_solve, size)
  print(f'  K8 on {label} ({list(x_end.shape)}; largest force {f_solve:.3g} '
        f'at the first and last positions, {f_moved:.3g} moved): max |df| '
        f'{k8e:.3g} (bar {FORCE_TOL})')
  check(k8e < FORCE_TOL, f'K8 differs from the plain force by {k8e} on '
        f'{label}')
  return k8e


def montage_path(dev, report, _build, rng) -> dict:
  """Path (e): `montage_align_2d` at bench.py's montage2d geometry, its
  kernels on the inputs it gave them, and the whole path against the
  same run with its kernels swapped for their plain versions.

  Returns the kernels' launch counts from the timed run."""
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.pipeline import montage

  t_phase = time.perf_counter()
  grid_t, tile_t, overlap_t = MONTAGE
  img, tiles, cfg_m = montage_inputs(dev)
  n_m = img.shape[0]
  print(f'path (e): montage_align_2d, {grid_t} x {grid_t} tiles of '
        f'{tile_t}^2, {overlap_t} px overlap, canvas {n_m}^2')
  calls = {}
  with recorded_calls(calls):  # the warm-up, with K1/K4/K8's inputs kept
    montage.montage_align_2d(tiles, (grid_t, grid_t), cfg_m)
  sync()
  _build.reset_launch_counts()
  torch.cuda.reset_peak_memory_stats()
  timings = {}
  t0 = time.perf_counter()
  out = montage.montage_align_2d(tiles, (grid_t, grid_t), cfg_m,
                                 timings=timings)
  sync()
  wall = time.perf_counter() - t0
  launches_e = dict(_build.launch_counts)
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  solved, key_to_idx = out['solved'], out['key_to_idx']
  err_m, cov = montage_error(out['canvas'], out['mask'], solved, key_to_idx,
                             img, tile_t)
  steps = out['solve_steps']
  mpix = n_m * n_m / wall / 1e6
  print('  stage seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s, {mpix:.2f} Mpix/s; solve steps {steps} '
        f'({timings["solve"] / steps * 1e3:.3f} ms per step); peak memory '
        f'{peak_gb:.2f} GB')
  print(f'  error {err_m:.3f} (gate {MONTAGE_ERR}), coverage {cov:.4f} '
        f'(gate {MONTAGE_COVERAGE}), overflow {bool(out["overflow"])}, '
        f'offsets x {out["cx"][:, 0].tolist()} y {out["cy"][:, 0].tolist()}')
  print(f'  launches {launches_e}')
  check(bool(torch.isfinite(solved).all()), 'montage meshes not finite')
  check(err_m <= MONTAGE_ERR, f'montage error {err_m}')
  check(cov >= MONTAGE_COVERAGE, f'montage coverage {cov}')
  check(not bool(out['overflow']), 'montage render envelope overflow')
  for k in ('dense_flow_peaks', 'force2d', 'warp_gather', 'invert_section',
            'fill_invalid'):
    check(launches_e[k] > 0, f'kernel {k} was not launched on path (e)')

  # Path (e)'s kernels against their plain versions on the inputs this
  # path gave them (recorded in the warm-up call). K1: every overlap
  # strip pair at p = 160, s = 40.
  k1_in = calls['dense_flow_peaks']
  k1e = compare_flow(
      torch.cat([cuda_flow.dense_flow_peaks(*a).reshape(4, -1)
                 for a in k1_in], 1),
      torch.cat([dense_flow_peaks_plain(*a).reshape(4, -1) for a in k1_in],
                1), f'K1 on the {len(k1_in)} montage strips '
      f'({list(k1_in[0][0].shape)}, ...)')
  # K4: every tile's Lanczos render through its dense tile-local map.
  k4e = max(float((cuda_warp.shift_warp(*a) - shift_warp_plain(*a))
                  .abs().max()) for a in calls['warp_gather'])
  print(f'  K4 on the {len(calls["warp_gather"])} tile renders '
        f'({list(calls["warp_gather"][0][1].shape)}): max |diff| {k4e:.3g} '
        f'gray levels (bar {RENDER_TOL})')
  check(k4e < RENDER_TOL, f'K4 differs from the plain render by {k4e}')
  # K8: the joint solve's first and last positions (at rest, since the
  # cut is exact), and the last ones moved.
  k8e = k8_against_plain(calls['force_2d'], rng, 'the joint solve\'s mesh')
  del calls, k1_in

  # The whole path again with K1, K4 and K8 swapped for their plain
  # versions on the card.
  t0 = time.perf_counter()
  with plain_kernels():
    ref_out = montage.montage_align_2d(tiles, (grid_t, grid_t), cfg_m)
  sync()
  wall_plain = time.perf_counter() - t0
  dm_e = float(torch.nan_to_num((solved - ref_out['solved']).abs()).max())
  both = out['mask'] & ref_out['mask']
  mask_diff = int((out['mask'] != ref_out['mask']).sum())
  dc_e = (out['canvas'] - ref_out['canvas']).abs()[both]
  print(f'  against the plain kernels ({wall_plain:.1f} s): mesh max |diff| '
        f'{dm_e:.3g} px (bar {SMALL_MESH_TOL}), canvas mean / max |diff| '
        f'{float(dc_e.mean()):.3g} / {float(dc_e.max()):.3g} (bar '
        f'{SMALL_CANVAS_TOL_2D[0]} / {SMALL_CANVAS_TOL_2D[1]}) where both '
        f'masks are set, mask differs at {mask_diff} px, steps {steps} / '
        f'{ref_out["solve_steps"]}')
  check(np.array_equal(out['cx'], ref_out['cx'], equal_nan=True)
        and np.array_equal(out['cy'], ref_out['cy'], equal_nan=True),
        'montage coarse offsets differ from the plain run')
  check(torch.equal(torch.isnan(solved), torch.isnan(ref_out['solved'])),
        'montage mesh NaN pattern differs from the plain run')
  check(dm_e < SMALL_MESH_TOL, 'montage meshes differ from the plain run')
  check(mask_diff <= MONTAGE_MASK_SHARE * both.numel(),
        'montage mask differs from the plain run')
  check(float(dc_e.mean()) < SMALL_CANVAS_TOL_2D[0]
        and float(dc_e.max()) < SMALL_CANVAS_TOL_2D[1],
        'montage canvas differs from the plain run')
  check(bool(out['overflow']) == bool(ref_out['overflow']),
        'montage overflow differs from the plain run')
  report['K1']['max_abs_err_montage'] = k1e['err']
  report['K1']['stat_frac_montage'] = k1e['stat_frac']
  report['K4']['max_abs_err_montage'] = k4e
  report['K8']['max_abs_err_montage'] = k8e
  report['path_e'] = dict(wall_s=wall, mpix_s=mpix, solve_steps=steps,
                          s_per_step=timings['solve'] / steps, error=err_m,
                          coverage=cov, peak_gb=peak_gb,
                          k1_launches=launches_e['dense_flow_peaks'],
                          k4_launches=launches_e['warp_gather'],
                          k8_launches=launches_e['force2d'],
                          plain_wall_s=wall_plain, mesh_diff_plain=dm_e,
                          canvas_mean_diff_plain=float(dc_e.mean()),
                          canvas_max_diff_plain=float(dc_e.max()),
                          mask_diff_plain=mask_diff, **timings)
  del out, ref_out, both, dc_e, tiles, img
  torch.cuda.empty_cache()
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return launches_e


def montage_slice(dev, report, _build) -> dict:
  """K8 at bench.py's `mesh` shape, then paths (d) and (e), the small
  montage against the CPU and the drift-removal stack step.

  Returns K8's launch count from the montage path's run."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.pipeline import montage
  from sofima_tpu_torch.pipeline import stack_align

  rng = np.random.RandomState(SEED + 5)
  stride = (40.0, 40.0)
  nodes = MESH2D[0] * MESH2D[1]

  # K8: bench.py's mesh input [2, 1, 2048, 2048], NaN holes sprinkled in.
  t_phase = time.perf_counter()
  print(f'K8 force2d, [2, 1, {MESH2D[0]}, {MESH2D[1]}] nodes with NaN holes')
  xm = torch.from_numpy(rng.randn(2, 1, *MESH2D).astype(np.float32)).to(dev)
  holes = torch.from_numpy(rng.rand(*MESH2D) < 0.001).to(dev)
  xh = torch.where(holes, torch.full_like(xm, float('nan')), xm)
  errs = []
  for prefer in (False, True):
    got = cuda_mesh.force_2d(xh, 0.1, stride, prefer)
    check(same_bits(got, cuda_mesh.force_2d(xh, 0.1, stride, prefer)),
          'K8 does not repeat bit for bit')
    ref = mesh.inplane_force_plain(xh, 0.1, stride, prefer)
    check(bool(torch.isfinite(got).all()), 'K8 force not finite')
    errs.append(float((got - ref).abs().max()))
  err = max(errs)
  print(f'  max |df| {errs[0]:.3g} (prefer_orig_order {errs[1]:.3g}); a '
        'second launch repeats it bit for bit')
  check(err < FORCE_TOL, f'K8 differs from the plain force by {err}')
  k8 = lambda: cuda_mesh.force_2d(xm, 0.1, stride)
  report['K8'] = dict(err=err, ms=cuda_ms(k8, reps=20), plain_ms=wall_ms(
      lambda: mesh.inplane_force_plain(xm, 0.1, stride)), library_ms=None,
                      **least_time(16 * nodes, FORCE2D_FLOPS_NODE * nodes))
  print(f'  kernel {report["K8"]["ms"]:.4f} ms (before {K8_PRIOR_MS}), '
        f'plain {report["K8"]["plain_ms"]:.3f} ms, bound '
        f'{report["K8"]["bound_ms"]:.4f} ms ({report["K8"]["bound_by"]})')
  del xh, holes, got, ref
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')

  # Path (d): bench.py's mesh stage, velocity_verlet with the force.
  t_phase = time.perf_counter()
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=stride, num_iters=1000,
      max_iters=1000, stop_v_max=0.0, dt_max=100.0)
  vm = torch.zeros_like(xm)
  prev = torch.zeros_like(xm)
  report['path_d'] = {}
  launches_d = []
  for name, c in (('default', cfg),
                  ('prefer_orig_order', dataclasses.replace(
                      cfg, prefer_orig_order=True))):
    run = lambda c=c: mesh.velocity_verlet(xm, vm, prev, c, force_cap=1e6)
    sync()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    got = run()
    sync()
    t_d = time.perf_counter() - t0
    n_k8 = _build.launch_counts['force2d']
    with plain_kernels():
      ref = run()
    sync()
    d = float((got[0] - ref[0]).abs().max())
    glups = cfg.num_iters * nodes / t_d / 1e9
    print(f'path (d): velocity_verlet {name}, {list(xm.shape)}, '
          f'{cfg.num_iters} steps: {t_d:.3f} s, {glups:.2f} GLUPS, K8 '
          f'launches {n_k8}; nodes vs the plain force {d:.3g} px (bar '
          f'{VERLET_TOL})')
    check(n_k8 == cfg.num_iters + 1, f'K8 launches on path (d): {n_k8}')
    check(bool(torch.isfinite(got[0]).all()), 'path (d) nodes not finite')
    check(d < VERLET_TOL, f'path (d) differs from the plain run by {d}')
    launches_d.append(n_k8)
    report['path_d'][name] = dict(seconds=t_d, glups=glups,
                                  force2d_launches=n_k8, max_diff_plain=d)
  report['K8']['launches_path_d'] = launches_d
  del xm, vm, prev, got, ref
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')

  launches_e = montage_path(dev, report, _build, rng)

  # Path (e) small: the CPU tests' geometry, the card against the CPU.
  t_phase = time.perf_counter()
  tiles_s = small_montage_tiles()
  cfg_s = montage.MontageConfig(
      stride=20, patch_size=40, coarse_overlaps=(65, 75), min_overlap=10,
      margin=4, flow_batch=16, mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(20.0, 20.0),
          num_iters=400, max_iters=20000, stop_v_max=0.005, dt_max=100.0))
  g_out = montage.montage_align_2d(tiles_s, (2, 2), cfg_s)
  c_out = montage.montage_align_2d(tiles_s, (2, 2), cfg_s, device='cpu')
  dm = float((g_out['solved'].cpu() - c_out['solved']).abs().max())
  both = g_out['mask'].cpu() & c_out['mask']
  dc = (g_out['canvas'].cpu() - c_out['canvas']).abs()[both]
  print(f'small montage (2 x 2 tiles of 160^2): mesh max |diff| vs CPU '
        f'{dm:.3g} px (bar {SMALL_MESH_TOL_2D}), canvas mean / max |diff| '
        f'{float(dc.mean()):.3g} / {float(dc.max()):.3g} (bar '
        f'{SMALL_CANVAS_TOL_2D[0]} / {SMALL_CANVAS_TOL_2D[1]}), steps '
        f'{g_out["solve_steps"]} / {c_out["solve_steps"]}')
  check(np.array_equal(g_out['cx'], c_out['cx'], equal_nan=True)
        and np.array_equal(g_out['cy'], c_out['cy'], equal_nan=True),
        'small montage coarse offsets differ')
  check(dm < SMALL_MESH_TOL_2D, 'small montage meshes differ')
  check(float(dc.mean()) < SMALL_CANVAS_TOL_2D[0]
        and float(dc.max()) < SMALL_CANVAS_TOL_2D[1],
        'small montage canvases differ')
  report['montage_small'] = dict(mesh_max_diff=dm,
                                 canvas_mean_diff=float(dc.mean()),
                                 canvas_max_diff=float(dc.max()))

  # Drift removal: one align_step on a 480^2 pair takes the staged solver.
  n_s = 480
  base = texture(n_s, dev)
  pair = (base, torch.roll(base, (5, -4), (0, 1)).contiguous())
  cfg_dr = stack_align.StackAlignConfig(max_displacement=64, residual=8)
  cfg_dr = dataclasses.replace(cfg_dr, mesh=dataclasses.replace(
      cfg_dr.mesh, remove_drift=True))
  zero = torch.zeros(2, 1, n_s // STRIDE, n_s // STRIDE, device=dev)
  _build.reset_launch_counts()
  s_gpu, r_gpu, _ = stack_align.align_step(*pair, zero, cfg_dr)
  sync()
  dr = dict(_build.launch_counts)
  s_cpu, _, _ = stack_align.align_step(pair[0].cpu(), pair[1].cpu(),
                                       zero.cpu(), cfg_dr)
  d = float(torch.nan_to_num((s_gpu.cpu() - s_cpu).abs()).max())
  print(f'drift removal: align_step ({n_s}^2, remove_drift=True): K8 '
        f'launches {dr["force2d"]}, K3 {dr["fused_fire"]}; mesh vs CPU '
        f'{d:.3g} px (bar {SMALL_MESH_TOL})')
  check(dr['force2d'] > 0 and dr['fused_fire'] == 0,
        'drift removal did not take the staged solver with K8')
  check(d < SMALL_MESH_TOL, 'drift-removal mesh differs from the CPU')
  check(bool(torch.isfinite(r_gpu).all()), 'drift-removal render not finite')
  report['drift_removal'] = dict(k8_launches=dr['force2d'], mesh_diff=d)
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return launches_e['force2d']


def e2e_config():
  """examples/e2e_alignment.py's IntegrationConfig."""
  from sofima_tpu_torch import mesh
  return mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(STRIDE, STRIDE),
      num_iters=1000, max_iters=100000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1, prefer_orig_order=True)


def e2e_pair(dev):
  """Path (f)'s uint8 10k^2 pair: the seeded texture, and a copy deformed
  by e2e_alignment's smooth field (a linear resample, edge-clamped, cast
  to uint8 by truncation as e2e does)."""
  from sofima_tpu_torch.ops import cuda_warp
  pre = torch.clamp(texture(N, dev) + 0.5, 0, 255).to(torch.uint8)
  r = torch.arange(N, dtype=torch.float32, device=dev)
  y, x = r[:, None], r[None, :]
  dx = E2E_AMP * torch.sin(2 * np.pi * y / N) * torch.cos(np.pi * x / N)
  dy = E2E_AMP * torch.cos(2 * np.pi * x / N) * torch.sin(np.pi * y / N)
  coords = torch.stack([torch.clamp(y + dy, 0, N - 1),
                        torch.clamp(x + dx, 0, N - 1)])[None].contiguous()
  del dx, dy
  post = cuda_warp.shift_warp(pre.float()[None], coords, 'linear')[0]
  return pre, torch.clamp(post, 0, 255).to(torch.uint8)


def library_flow(pre, post, timings):
  """Path (f)'s flow and clean/reconcile phases (the library API)."""
  from sofima_tpu_torch import flow_field
  from sofima_tpu_torch import flow_utils
  from sofima_tpu_torch import map_utils
  from sofima_tpu_torch.utils.bounding_box import BoundingBox
  calc = flow_field.JAXMaskedXCorrWithStatsCalculator()
  kw = dict(patch_size=E2E_PATCH, step=STRIDE, batch_size=E2E_BATCH)
  t0 = time.perf_counter()
  flow = calc.flow_field(pre, post, **kw)
  half = lambda im: torch.nn.functional.avg_pool2d(im.float()[None, None],
                                                   2)[0, 0]
  flow_2x = calc.flow_field(half(pre), half(post), **kw)
  sync()
  t1 = time.perf_counter()
  clean = dict(min_peak_ratio=1.6, min_peak_sharpness=1.6, max_magnitude=40,
               max_deviation=10)
  f1 = flow_utils.clean_flow(flow[:, None], **clean)
  f2 = flow_utils.clean_flow(flow_2x[:, None], **clean)
  g, pad = N // STRIDE, E2E_PATCH // 2 // STRIDE

  def to_grid(f, n):
    out = np.full((2, 1, n, n), np.nan, np.float32)
    out[:, :, pad:pad + f.shape[2], pad:pad + f.shape[3]] = f
    return out

  box_1x = BoundingBox(start=(0, 0, 0), size=(g, g, 1))
  box_2x = BoundingBox(start=(0, 0, 0), size=(g // 2, g // 2, 1))
  full_1x = to_grid(f1, g)
  f2_hires = map_utils.resample_map(to_grid(f2, g // 2) * 2.0, box_2x,
                                    box_1x, 2 * STRIDE, STRIDE)
  final = flow_utils.reconcile_flows((full_1x, f2_hires), max_gradient=0,
                                     max_deviation=20, min_patch_size=0)
  pruned = flow_utils.reconcile_flows((full_1x, f2_hires), max_gradient=0,
                                      max_deviation=20,
                                      min_patch_size=MIN_PATCH)
  timings['flow'] = t1 - t0
  timings['clean_reconcile'] = time.perf_counter() - t1
  return dict(flow=flow, flow_2x=flow_2x, full_1x=full_1x, f2_hires=f2_hires,
              final=final, pruned=pruned)


def library_solve(final, dev, timings):
  """Path (f)'s solve phase: the fused FIRE solver (K3), e2e's config."""
  from sofima_tpu_torch.ops import cuda_mesh
  t0 = time.perf_counter()
  prev = torch.from_numpy(final).to(dev)
  solved, _, steps = cuda_mesh.relax_mesh_fused(torch.zeros_like(prev), prev,
                                                e2e_config())
  solved = solved.cpu().numpy()
  timings['solve'] = time.perf_counter() - t0
  return solved, int(steps)


def library_render(solved, post_np, timings):
  """Path (f)'s invert and render (K4, counted as K4p) phases."""
  from sofima_tpu_torch import map_utils
  from sofima_tpu_torch import warp
  from sofima_tpu_torch.utils.bounding_box import BoundingBox
  g = N // STRIDE
  box = BoundingBox(start=(0, 0, 0), size=(g, g, 1))
  img_box = BoundingBox(start=(0, 0, 0), size=(N, N, 1))
  t0 = time.perf_counter()
  inv = map_utils.invert_map(solved, box, box, STRIDE)
  inv = map_utils.fill_missing(inv, extrapolate=True)
  t1 = time.perf_counter()
  rendered = warp.warp_subvolume(post_np[None, None], img_box, inv, box,
                                 STRIDE, img_box, interpolation='lanczos')
  timings.update(invert=t1 - t0, render=time.perf_counter() - t1)
  return dict(inv=inv, rendered=rendered)


def library_slice(dev, report, _build) -> dict:
  """Path (f), the library-API alignment path (examples/e2e_alignment.py
  and the em_alignment notebook's 2x pass) at bench.py's section size,
  then K6 and K7 on that pair.

  Returns the launch counts of K6, K7, K12 and K4p from their paths."""
  from sofima_tpu_torch import flow_field
  from sofima_tpu_torch import warp
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_warp

  t_phase = time.perf_counter()
  pre, post = e2e_pair(dev)
  post_np = post.cpu().numpy()
  print(f'path (f): the library API on a {N}^2 pair deformed by '
        f'e2e_alignment\'s field ({E2E_AMP:g} px); calculator padfield, p = '
        f'{E2E_PATCH}, s = {STRIDE}, batch {E2E_BATCH}')
  # Warm-up call (the kernels' inputs recorded), then the measured one.
  calls = {}
  with recorded_calls(calls):
    library_render(library_solve(library_flow(pre, post, {})['final'], dev,
                                 {})[0], post_np, {})
  sync()
  _build.reset_launch_counts()
  timings = {}
  t0 = time.perf_counter()
  fl = library_flow(pre, post, timings)
  solved, steps = library_solve(fl['final'], dev, timings)
  out = library_render(solved, post_np, timings)
  sync()
  wall = time.perf_counter() - t0
  launches_f = dict(_build.launch_counts)
  rendered = out['rendered']
  calc = flow_field.JAXMaskedXCorrWithStatsCalculator()
  resid = calc.flow_field(pre, torch.from_numpy(rendered[0, 0]).to(dev),
                          patch_size=E2E_PATCH, step=STRIDE,
                          batch_size=E2E_BATCH)
  flow = fl['flow']
  before = float(np.nanmean(np.hypot(flow[0], flow[1])))
  after = float(np.nanmean(np.hypot(resid[0], resid[1])))
  inter = (slice(E2E_PATCH, -E2E_PATCH),) * 2
  pre_i = pre[inter].float()
  px_before = float((post[inter].float() - pre_i).abs().mean())
  px_after = float((torch.from_numpy(rendered[0, 0]).to(dev)[inter].float()
                    - pre_i).abs().mean())
  valid = {k: float(np.isfinite(fl[k][0]).mean())
           for k in ('full_1x', 'final', 'pruned')}
  dropped = int(np.isfinite(fl['final'][0]).sum()
                - np.isfinite(fl['pruned'][0]).sum())
  print('  phase seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s; flow grids {list(flow.shape)} and '
        f'{list(fl["flow_2x"].shape)}; valid 1x {valid["full_1x"]:.4f} -> '
        f'reconciled {valid["final"]:.4f}; min_patch_size {MIN_PATCH} drops '
        f'{dropped} nodes; solve {steps} steps')
  print(f'  mean |flow| before {before:.3f} px, after {after:.3f} px (gate '
        f'< {E2E_GATE} and < before / 5); interior pixel residual before '
        f'{px_before:.2f}, after {px_after:.2f} gray levels')
  print(f'  launches {launches_f}')
  check(tuple(rendered.shape) == (1, 1, N, N) and rendered.dtype == np.uint8,
        'path (f) render shape / type')
  check(bool(np.isfinite(solved).all()), 'path (f) mesh not finite')
  check(after < E2E_GATE and after < before / 5,
        f'path (f): residual flow {after} px (before {before})')
  check(px_after < px_before, 'path (f): the render did not align')
  check(launches_f['fused_fire'] > 0, 'K3 was not launched on path (f)')
  check(launches_f['warp_subvolume'] > 0,
        'K4 (warp_subvolume) was not launched on path (f)')

  # K3 on path (f)'s own solve inputs, capped at K3_STEPS steps, against
  # the plain FIRE solver (whose ~5 ms per step rules out all 9000).
  from sofima_tpu_torch.ops import cuda_mesh
  cfg_k3 = dataclasses.replace(e2e_config(), max_iters=K3_STEPS)
  prev = torch.from_numpy(fl['final']).to(dev)
  got3, _, st3 = cuda_mesh.relax_mesh_fused(torch.zeros_like(prev), prev,
                                            cfg_k3)
  ref3, _, st3p = cuda_mesh.relax_mesh_fused_plain(
      torch.zeros_like(prev[:, 0]), prev[:, 0], cfg_k3)
  k3_err = float(torch.nan_to_num((got3[:, 0] - ref3).abs(), nan=0.0).max())
  print(f'  K3 on path (f)\'s solve inputs, {int(st3)} steps (plain '
        f'{st3p}): nodes max |diff| {k3_err:.3g} px (bar {MESH_TOL})')
  check(int(st3) == int(st3p), f'path (f) K3 steps {int(st3)} vs {st3p}')
  check(bool(torch.equal(torch.isnan(got3[:, 0]), torch.isnan(ref3))),
        'path (f) K3 NaN pattern differs')
  check(k3_err < MESH_TOL, f'path (f) K3 differs from plain by {k3_err} px')
  # K3's own time on path (f)'s whole solve (its launch on the path).
  solve = lambda: cuda_mesh.relax_mesh_fused(torch.zeros_like(prev), prev,
                                             e2e_config())
  k3f_ms = cuda_ms(solve)
  report['K3'].update(path_f_ms=k3f_ms, path_f_steps=steps)
  print(f'  K3 on path (f)\'s whole solve: {steps} steps in {k3f_ms:.3f} ms '
        f'({k3f_ms * 1e3 / steps:.3f} us a step)')
  del prev, got3, ref3

  # The component labelling on the card against the CPU: the path's
  # pruned call (its flow is one component, so nothing drops), and the
  # same call on the 1x flow with HOLE_SHARE of its nodes dropped, which
  # leaves small islands to remove.
  from sofima_tpu_torch import flow_utils
  rec_kw = dict(max_gradient=0, max_deviation=20, min_patch_size=MIN_PATCH)
  holed = fl['full_1x'].copy()
  holed[:, np.random.RandomState(SEED).rand(*holed.shape[1:])
        < HOLE_SHARE] = np.nan
  flows = {'path': (fl['full_1x'], fl['f2_hires']), 'holed': (holed,)}
  rec_drop = {}
  for k, fs in flows.items():
    card = fl['pruned'] if k == 'path' else flow_utils.reconcile_flows(
        fs, **rec_kw)
    cpu = flow_utils.reconcile_flows(fs, device='cpu', **rec_kw)
    check(np.array_equal(card, cpu, equal_nan=True),
          f'reconcile_flows ({k}) differs between the card and the CPU')
    unpruned = flow_utils.reconcile_flows(fs, **dict(rec_kw,
                                                     min_patch_size=0))
    rec_drop[k] = int(np.isfinite(unpruned[0]).sum()
                      - np.isfinite(card[0]).sum())
  print(f'  reconcile_flows(min_patch_size={MIN_PATCH}) equals the CPU\'s; '
        f'nodes dropped: {rec_drop["path"]} on the path, '
        f'{rec_drop["holed"]} with {HOLE_SHARE:g} of the 1x nodes holed')
  check(rec_drop['holed'] > 0, 'the component pruning dropped nothing')
  del holed, flows

  # ndimage_warp 2d on the same inverse map, float32 input.
  post_f_np = post_np.astype(np.float32)
  inv2 = out['inv'][:, 0]
  nd_kw = dict(stride=(STRIDE, STRIDE), work_size=(ND_WORK, ND_WORK),
               overlap=(ND_OVERLAP, ND_OVERLAP), order=1)
  _build.reset_launch_counts()
  with recorded_calls(calls):
    t0 = time.perf_counter()
    nd = warp.ndimage_warp(post_f_np, inv2, **nd_kw)
    nd_s = time.perf_counter() - t0
  nd_launches = _build.launch_counts['ndimage_warp']
  with plain_kernels():
    nd_plain = warp.ndimage_warp(post_f_np, inv2, **nd_kw)
  nd_err = float(np.abs(nd - nd_plain).max())
  print(f'  ndimage_warp 2d (work {ND_WORK}, overlap {ND_OVERLAP}, linear): '
        f'{nd_s:.3f} s, {nd_launches} K4 launches; max |diff| vs its plain '
        f'version {nd_err:.3g} (bar {RENDER_TOL})')
  check(nd_launches > 0, 'K4 (ndimage_warp) was not launched')
  check(nd_err < RENDER_TOL, f'ndimage_warp differs from plain by {nd_err}')
  del nd, nd_plain, post_f_np

  # K4p: warp_subvolume's launches, on the inputs path (f) gave them.
  k4p_in = calls['warp_subvolume']
  img, coords, method = k4p_in[0]
  k4p = lambda: cuda_warp.shift_warp(img, coords, method)
  k4p_plain = lambda: shift_warp_plain(img, coords, method)
  err = max(float((cuda_warp.shift_warp(*a) - shift_warp_plain(*a)).abs()
                  .max()) for a in k4p_in)
  px = coords.shape[-1] * coords.shape[-2]
  report['K4p'] = dict(err=err, ms=cuda_ms(k4p),
                       plain_ms=wall_ms(k4p_plain),
                       library_ms=None, calls=len(k4p_in),
                       **least_time(16 * px, LANCZOS_FLOPS_PX * px))
  print(f'  K4p (warp_subvolume\'s K4 launch, {list(coords.shape)}, '
        f'{method}): max |diff| {err:.3g} (bar {RENDER_TOL}); kernel '
        f'{report["K4p"]["ms"]:.3f} ms (before {K4P_PRIOR_MS}), plain '
        f'{report["K4p"]["plain_ms"]:.1f} ms, bound '
        f'{report["K4p"]["bound_ms"]:.3f} ms')
  check(err < RENDER_TOL, f'K4p differs from the plain render by {err}')
  del img, coords, k4p_in

  # K12: ndimage_warp's launches, one per work box.
  k12_in = calls['ndimage_warp']
  err = ms = plain = lib = 0.0
  px = 0
  for im, cd, meth in k12_in:
    err = max(err, float((cuda_warp.shift_warp(im, cd, meth)
                          - shift_warp_plain(im, cd, meth)).abs().max()))
    # A box renders in ~40 us, about the host's time to issue one call:
    # K12_REPS calls per timing keep the first call's issue time (which
    # the events include) from weighing on the kernel or the library.
    ms += cuda_ms(lambda: cuda_warp.shift_warp(im, cd, meth), K12_REPS)
    plain += wall_ms(lambda: shift_warp_plain(im, cd, meth))
    h, w = im.shape[-2:]
    grid = torch.stack([cd[0, 1] * (2.0 / (w - 1)) - 1.0,
                        cd[0, 0] * (2.0 / (h - 1)) - 1.0], dim=-1)[None]
    lib += cuda_ms(lambda: torch.nn.functional.grid_sample(
        im[None], grid, mode='bilinear', padding_mode='zeros',
        align_corners=True), K12_REPS)
    px += cd.shape[-1] * cd.shape[-2]
  report['K12'] = dict(err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, boxes=len(k12_in),
                       **least_time(4 * N * N + 12 * px, LINEAR_FLOPS_PX * px))
  print(f'  K12 (ndimage_warp\'s K4 launches, {len(k12_in)} boxes of '
        f'<= {ND_WORK}^2, linear): max |diff| {err:.3g}; kernel {ms:.3f} ms '
        f'(before {K12_PRIOR_MS}), plain {plain:.1f} ms, bound '
        f'{report["K12"]["bound_ms"]:.3f} ms, '
        f'grid_sample {lib:.3f} ms (all boxes)')
  check(err < RENDER_TOL, f'K12 differs from the plain render by {err}')
  del calls, k12_in

  # The invert and render phases again with K4 and the fill swapped for
  # their plain versions, from the same mesh. The flow and clean phases
  # launch no kernel, and K3 was held above. `invert_map` launches none;
  # `fill_missing` the fill's kernels, so the inverse maps agree within
  # INVERT_TOL (NaNs exact) and the render tells K4 apart.
  t0 = time.perf_counter()
  with plain_kernels():
    ref = library_render(solved, post_np, {})
  sync()
  wall_plain = time.perf_counter() - t0
  dm = float(np.nanmax(np.abs(out['inv'] - ref['inv'])))
  nan_same = np.array_equal(np.isnan(out['inv']), np.isnan(ref['inv']))
  dr = np.abs(out['rendered'].astype(np.int16)
              - ref['rendered'].astype(np.int16))
  flips = float((dr > 0).mean())
  print(f'  against the plain render ({wall_plain:.1f} s): the inverse '
        f'maps max |diff| {dm:.3g} px (bar {INVERT_TOL}); render max |diff| '
        f'{int(dr.max())} gray level on {flips:.2e} of the pixels (bar 1 on '
        f'{RENDER_FLIP_SHARE})')
  check(nan_same and dm <= INVERT_TOL,
        'path (f) inverse maps differ from the plain fill')
  check(int(dr.max()) <= 1 and flips <= RENDER_FLIP_SHARE,
        'path (f) render differs from the plain run')
  report['path_f'] = dict(
      wall_s=wall, solve_steps=steps, flow_before_px=before,
      flow_after_px=after, gate_px=E2E_GATE, pixel_resid_before=px_before,
      pixel_resid_after=px_after, valid_1x=valid['full_1x'],
      valid_reconciled=valid['final'], min_patch_dropped=dropped,
      min_patch_dropped_holed=rec_drop['holed'],
      k3_launches=launches_f['fused_fire'], k3_steps_held=int(st3),
      k3_max_diff_plain=k3_err, k3_solve_ms=k3f_ms,
      k4p_launches=launches_f['warp_subvolume'],
      ndimage_warp_s=nd_s, k12_launches=nd_launches,
      ndimage_max_diff_plain=nd_err, plain_render_wall_s=wall_plain,
      render_flip_share_plain=flips, **timings)
  del out, ref, rendered, resid, fl
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')

  # K6 through the rectangular strip path, p = (160, 80), s = (40, 40).
  t_phase = time.perf_counter()
  pre_f, post_f = pre.float(), post.float()
  print(f'K6 patch_flow_peaks: dense_flow_field on the {N}^2 pair, p = '
        f'{K6_PATCH}, s = ({STRIDE}, {STRIDE}) (the strip path)')
  k6_calls = {}
  with recorded_calls(k6_calls):
    flow_field.dense_flow_field(pre_f, post_f, K6_PATCH, (STRIDE, STRIDE),
                                circular=True)
  sync()
  _build.reset_launch_counts()
  got = flow_field.dense_flow_field(pre_f, post_f, K6_PATCH, (STRIDE, STRIDE),
                                    circular=True)
  sync()
  k6_launches = _build.launch_counts['patch_flow_peaks']
  k6_dft = _build.launch_counts['patch_flow_peaks_dft']
  with plain_kernels():
    ref6 = flow_field.dense_flow_field(pre_f, post_f, K6_PATCH,
                                       (STRIDE, STRIDE), circular=True)
  k6 = compare_flow(got, ref6, 'K6')
  check(k6_launches > 0, 'K6 was not launched on the strip path')
  check(k6_dft == 0, f'K6 took the dense-DFT route {k6_dft} times on the '
        'strip path')
  p1, p2 = K6_PATCH

  def cut(img, rows, q1, q2):
    return img[:rows].unfold(0, q1, STRIDE).unfold(1, q2, STRIDE).reshape(
        -1, q1, q2).contiguous()

  # Timed on the strip path's own launches (recorded above), summed;
  # torch.fft's surfaces of the same pre-cut pairs (rfft2, the conjugate
  # product, irfft2, the roll; no means, no peaks) as the yardstick.
  k6_in = k6_calls['flow_peaks']
  check(all(same_bits(cuda_flow.flow_peaks(*a), cuda_flow.flow_peaks(*a))
            for a in k6_in), 'K6 does not repeat bit for bit')

  def fft6(a, b):
    return torch.roll(torch.fft.irfft2(
        torch.fft.rfft2(a) * torch.conj(torch.fft.rfft2(b)), s=(p1, p2)),
                      (p1 // 2, p2 // 2), dims=(1, 2))

  ms6 = sum(cuda_ms(lambda: cuda_flow.flow_peaks(*a)) for a in k6_in)
  plain6 = sum(wall_ms(lambda: cuda_flow.patch_flow_peaks_plain(*a))
               for a in k6_in)
  lib6 = sum(cuda_ms(lambda: fft6(a[0], a[1])) for a in k6_in)
  n6 = sum(a[0].shape[0] for a in k6_in)
  report['K6'] = dict(k6, ms=ms6, plain_ms=plain6, library_ms=lib6,
                      library='torch.fft rfft2 * conj(rfft2) -> irfft2 -> '
                      'roll (no means, no peaks)', pairs=n6,
                      timed_launches=len(k6_in),
                      **dict(zip(('threads', 'blocks_per_sm'),
                                 cuda_flow.patch_fft_config(p1, p2))),
                      **least_time(2 * n6 * p1 * p2 * 4 + 16 * n6,
                                   n6 * xcorr_flops(p1, p2)))
  print(f'  {k6_launches} launches on the path, all on the FFT route '
        f'({report["K6"]["threads"]} threads a block, '
        f'{report["K6"]["blocks_per_sm"]} blocks per SM), {n6} pairs; a '
        'second launch repeats each bit for bit')
  print(f'  summed over them: kernel {ms6:.3f} ms (before {K6_PRIOR_MS}), '
        f'plain {plain6:.1f} ms, bound {report["K6"]["bound_ms"]:.3f} ms '
        f'({report["K6"]["bound_by"]}); torch.fft surfaces alone '
        f'{lib6:.3f} ms')
  check(len(k6_in) == k6_launches, 'K6 launches differ between the runs')
  del k6_in, k6_calls, got, ref6

  # K6's dense-DFT route, for shapes the FFT route does not serve.
  n_d, (q1, q2) = K6_DFT_ROUTE
  a = cut(pre_f, q1 + 2 * STRIDE, q1, q2)[:n_d]
  b = cut(post_f, q1 + 2 * STRIDE, q1, q2)[:n_d]
  print(f'K6 dense-DFT route, {n_d} pairs of {q1} x {q2}')
  before = dict(_build.launch_counts)
  got = cuda_flow.flow_peaks(a, b)
  check(_build.launch_counts['patch_flow_peaks_dft']
        == before['patch_flow_peaks_dft'] + 1
        and _build.launch_counts['patch_flow_peaks']
        == before['patch_flow_peaks'],
        f'K6 at {q1} x {q2} did not take the dense-DFT route')
  check(same_bits(got, cuda_flow.flow_peaks(a, b)),
        'K6 (dense-DFT route) does not repeat bit for bit')
  rd = compare_flow(got.T, cuda_flow.patch_flow_peaks_plain(a, b).T,
                    'K6 dense-DFT route')
  report['K6'].update(dft_route_shape=[n_d, q1, q2],
                      dft_route_ms=cuda_ms(lambda: cuda_flow.flow_peaks(a, b)),
                      dft_route_plain_ms=wall_ms(
                          lambda: cuda_flow.patch_flow_peaks_plain(a, b)),
                      dft_route_err=rd['err'],
                      dft_route_stat_frac=rd['stat_frac'])
  print(f'  kernel {report["K6"]["dft_route_ms"]:.3f} ms, plain '
        f'{report["K6"]["dft_route_plain_ms"]:.3f} ms')
  del a, b, got

  # K7 on the first K7_ROWS grid rows of the p = 160, s = 40 pairs.
  p = E2E_PATCH
  rows = (K7_ROWS - 1) * STRIDE + p
  a, b = cut(pre_f, rows, p, p), cut(post_f, rows, p, p)
  n7 = a.shape[0]
  print(f'K7 corr_patches: {n7} pairs of {p}^2 ({K7_ROWS} grid rows, '
        f'{a.numel() * 4 / 1e9:.2f} GB per side)')
  _build.reset_launch_counts()
  got = cuda_flow.corr_patches(a, b)
  sync()
  k7_launches = _build.launch_counts['corr_patches']
  check(same_bits(got, cuda_flow.corr_patches(a, b)),
        'K7 does not repeat bit for bit')
  ref7 = cuda_flow.corr_patches_plain(a, b)
  diff = (got - ref7).abs()
  rel = float((diff.amax(dim=(1, 2))
               / ref7.abs().amax(dim=(1, 2)).clamp(min=1e-30)).max())
  err = float(diff.max())
  print(f'  surfaces: max |diff| {err:.3g}, {rel:.3g} of each surface\'s max '
        f'(bar {SURFACE_TOL}); a second launch repeats it bit for bit')
  check(rel < SURFACE_TOL, f'K7 differs from plain by {rel} (relative)')
  del diff, ref7

  def lib7():
    fa = torch.fft.rfft2(a - a.mean(dim=(1, 2), keepdim=True))
    fb = torch.fft.rfft2(b - b.mean(dim=(1, 2), keepdim=True))
    return torch.roll(torch.fft.irfft2(fa * torch.conj(fb), s=(p, p)),
                      (p // 2, p // 2), dims=(1, 2))

  lib_err = float((lib7() - got).abs().max())
  report['K7'] = dict(err=err, max_rel_err=rel,
                      ms=cuda_ms(lambda: cuda_flow.corr_patches(a, b)),
                      plain_ms=wall_ms(
                          lambda: cuda_flow.corr_patches_plain(a, b)),
                      library_ms=cuda_ms(lib7),
                      library='torch.fft rfft2 * conj(rfft2) -> irfft2 -> roll',
                      library_max_abs_diff=lib_err, pairs=n7,
                      **least_time(3 * n7 * p * p * 4, n7 * xcorr_flops(p)))
  print(f'  kernel {report["K7"]["ms"]:.3f} ms (before {K7_PRIOR_MS}), plain '
        f'{report["K7"]["plain_ms"]:.1f} ms, bound '
        f'{report["K7"]["bound_ms"]:.3f} ms ({report["K7"]["bound_by"]}), '
        f'torch.fft chain {report["K7"]["library_ms"]:.3f} ms (library_max'
        f'_abs_diff {lib_err:.3g})')
  check(k7_launches == 1, 'K7 launches')
  del a, b, got

  # K7 over the shared-memory budget (three launches through global
  # scratch) and at a prime, rectangular size, against its plain version.
  extra = {}
  for n_x, q1, q2 in K7_EXTRA:
    rows = q1 + 2 * STRIDE
    a, b = cut(pre_f, rows, q1, q2)[:n_x], cut(post_f, rows, q1, q2)[:n_x]
    check(a.shape[0] == n_x, f'K7 extra: {a.shape[0]} pairs of {q1} x {q2}')
    got = cuda_flow.corr_patches(a, b)
    check(same_bits(got, cuda_flow.corr_patches(a, b)),
          f'K7 ({q1} x {q2}) does not repeat bit for bit')
    ref7 = cuda_flow.corr_patches_plain(a, b)
    rel_x = float(((got - ref7).abs().amax(dim=(1, 2))
                   / ref7.abs().amax(dim=(1, 2)).clamp(min=1e-30)).max())
    check(rel_x < SURFACE_TOL,
          f'K7 ({q1} x {q2}) differs from plain by {rel_x} (relative)')
    route = 'scratch' if int(_build.library().corr_fft_smem_bytes(
        q1, q2)) > cuda_flow._MAX_SMEM_BYTES else 'shared'
    extra[f'{q1}x{q2}'] = dict(
        pairs=n_x, route=route, max_rel_err=rel_x,
        ms=cuda_ms(lambda: cuda_flow.corr_patches(a, b)))
    print(f'  {n_x} pairs of {q1} x {q2} ({route} route): {rel_x:.3g} of '
          f'each surface\'s max, repeats bit for bit; kernel '
          f'{extra[f"{q1}x{q2}"]["ms"]:.3f} ms')
    del a, b, got, ref7
  report['K7']['extra_sizes'] = extra
  del pre_f, post_f, pre, post
  torch.cuda.empty_cache()
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return dict(patch_flow_peaks=k6_launches, corr_patches=k7_launches,
              ndimage_warp=nd_launches,
              warp_subvolume=launches_f['warp_subvolume'])


def stitch_api_inputs(dev, geometry):
  """Path (g)'s input: (source image, jittered tiles, true coarse offsets).

  bench.py's montage2d grid of `geometry` (grid, tile, overlap) cut from
  the seeded texture, each tile moved by its own integer jitter of at
  most STITCH_API_JITTER px (tile (0, 0) by none, the first column and
  row only forward, the last only back, so every tile stays in the
  source), and tile (1, 1)'s content displaced by a Gaussian bump of
  non-integer amplitude centred in its left overlap (bilinear resampling
  of the source), so that the fine flow there is not zero. The true
  offsets are those of the integer cut: [2, 1, grid, grid] XY arrays
  for the x and y neighbour pairs, NaN where no pair is."""
  grid_t, tile_t, overlap_t = geometry
  step_t = tile_t - overlap_t
  n = step_t * (grid_t - 1) + tile_t
  img = texture(N, dev)[:n, :n].contiguous()
  rng = np.random.RandomState(SEED + 13)
  j = STITCH_API_JITTER

  def draw(i):
    lo = 0 if i == 0 else -j
    hi = 0 if i == grid_t - 1 else j
    return int(rng.randint(lo, hi + 1))

  jit = {(tx, ty): (draw(ty), draw(tx))
         for ty in range(grid_t) for tx in range(grid_t)}
  jit[(0, 0)] = (0, 0)
  tiles = {}
  for (tx, ty), (jy, jx) in jit.items():
    y0, x0 = ty * step_t + jy, tx * step_t + jx
    tiles[(tx, ty)] = img[y0:y0 + tile_t, x0:x0 + tile_t].contiguous()
  amp_x, amp_y, sigma = STITCH_API_BUMP
  sigma *= tile_t
  (jy, jx) = jit[(1, 1)]
  ys = torch.arange(tile_t, device=dev, dtype=torch.float32)[:, None]
  xs = torch.arange(tile_t, device=dev, dtype=torch.float32)[None, :]
  bump = torch.exp(-((ys - tile_t / 2) ** 2 + (xs - overlap_t / 2) ** 2)
                   / (2 * sigma ** 2))
  src_y = ys + (step_t + jy) + amp_y * bump
  src_x = xs + (step_t + jx) + amp_x * bump
  pos = torch.stack([src_x / (n - 1), src_y / (n - 1)], dim=-1) * 2 - 1
  tiles[(1, 1)] = torch.nn.functional.grid_sample(
      img[None, None], pos[None], mode='bilinear',
      align_corners=True)[0, 0].contiguous()
  true = []
  for dx, dy in ((1, 0), (0, 1)):
    conn = np.full((2, 1, grid_t, grid_t), np.nan)
    for ty in range(grid_t - dy):
      for tx in range(grid_t - dx):
        (ay, ax), (by, bx) = jit[(tx, ty)], jit[(tx + dx, ty + dy)]
        conn[:, 0, ty, tx] = (bx - ax - overlap_t * dx, by - ay - overlap_t * dy)
    true.append(conn)
  return img, tiles, true[0], true[1]


def stitch_api_config():
  """examples/e2e_stitching.py's joint-solve configuration."""
  from sofima_tpu_torch import mesh
  return mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(20, 20), num_iters=400,
      max_iters=20000, stop_v_max=0.005, dt_max=100.0)


def stitch_api_chain(tiles, grid_t: int, tile_t: int, overlaps,
                     min_overlap: int, timings: dict | None = None):
  """examples/e2e_stitching.py's steps through the port's library API on
  the tiles' device: the sequential coarse search, interpolation of
  failed pairs, tile placement, the padfield fine flow at the
  reference's defaults (patch 120, stride 20, batch 256), packing, the
  joint solve (mesh.relax_mesh with K8, targets from compute_target_mesh
  batched over the tiles as stitch_elastic.TargetMeshPlan) and the render
  (warp.render_tiles, K4 under 'warp_subvolume')."""
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch import stitch_elastic
  from sofima_tpu_torch import stitch_rigid
  from sofima_tpu_torch import warp
  timings = {} if timings is None else timings
  dev = next(iter(tiles.values())).device
  stride = (20, 20)
  t0 = time.perf_counter()
  cx, cy = stitch_rigid.compute_coarse_offsets(
      (grid_t, grid_t), tiles, overlaps_xy=(overlaps, overlaps),
      min_overlap=min_overlap)
  raw = (cx.copy(), cy.copy())
  cx = stitch_rigid.interpolate_missing_offsets(cx, axis=-1)
  cy = stitch_rigid.interpolate_missing_offsets(cy, axis=-2)
  timings['coarse'] = time.perf_counter() - t0
  t0 = time.perf_counter()
  coarse = stitch_rigid.optimize_coarse_mesh(cx, cy, device=dev)
  sync()
  timings['place'] = time.perf_counter() - t0
  t0 = time.perf_counter()
  fine_x, off_x = stitch_elastic.compute_flow_map(tiles, cx[:, 0], axis=0)
  fine_y, off_y = stitch_elastic.compute_flow_map(tiles, cy[:, 0], axis=1)
  sync()
  timings['fine_flow'] = time.perf_counter() - t0
  t0 = time.perf_counter()
  fx, fy, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
      (cx[:, 0], fine_x, off_x), (cy[:, 0], fine_y, off_y), list(tiles),
      coarse[:, 0], stride, tile_shape=(tile_t, tile_t))
  x0 = torch.from_numpy(x0).to(dev)
  prev_fn = stitch_elastic.TargetMeshPlan(nbors, fx, fy, stride,
                                          x0.shape[-2:])
  solved, _, steps = mesh.relax_mesh(x0, None, stitch_api_config(),
                                     prev_fn=prev_fn)
  sync()
  timings['solve'] = time.perf_counter() - t0
  t0 = time.perf_counter()
  maps = {k: solved[:, i:i + 1] for k, i in key_to_idx.items()}
  canvas, mask = warp.render_tiles(tiles, maps, stride=stride, margin=4)
  timings['render'] = time.perf_counter() - t0
  flows = sum(int(torch.isfinite(f[0]).sum())
              for f in list(fine_x.values()) + list(fine_y.values()))
  return dict(raw=raw, cx=cx, cy=cy, coarse=coarse, x0=x0, solved=solved,
              key_to_idx=key_to_idx, steps=int(steps), canvas=canvas,
              mask=mask, flows=flows, fine_x=fine_x)


def stitch_api_path(dev, report, _build) -> None:
  """Path (g): examples/e2e_stitching.py's chain through the port's
  public API at bench.py's montage2d geometry, on a jittered cut with
  one tile's content displaced, against its gates; K4 and K8 against
  their plain versions on the inputs recorded in the run (the renders
  of two tiles, the bumped one among them; the joint solve's positions);
  then the whole chain against the same run with K4 and K8 swapped for
  their plain versions: meshes within 0.01 * stride, the canvas within
  path (e)'s mean bar and a max bar derived from the measured mesh gap
  (see `chain_canvas_max_bar`)."""
  t_phase = time.perf_counter()
  grid_t, tile_t, overlap_t = MONTAGE
  img, tiles, true_x, true_y = stitch_api_inputs(dev, MONTAGE)
  n_m = img.shape[0]
  print(f'path (g): examples/e2e_stitching.py\'s chain (library API), '
        f'{grid_t} x {grid_t} tiles of {tile_t}^2, {overlap_t} px overlap, '
        f'jitter <= {STITCH_API_JITTER} px, tile (1, 1) bumped by '
        f'{STITCH_API_BUMP[:2]} px')
  print(f'  {smi()}')
  args = (grid_t, tile_t, STITCH_API_OVERLAPS, STITCH_API_MIN_OVERLAP)
  from sofima_tpu_torch.ops import cuda_warp
  _build.reset_launch_counts()
  timings, calls = {}, {}
  with recorded_calls(calls):  # K4's and K8's inputs kept
    t0 = time.perf_counter()
    out = stitch_api_chain(tiles, *args, timings=timings)
    wall = time.perf_counter() - t0
  launches = dict(_build.launch_counts)
  print('  phase seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items())
        + f'; wall {wall:.3f} s, solve steps {out["steps"]}')
  print(f'  launches {launches}')
  check(launches['force2d'] > 0, 'K8 was not launched on path (g)')
  check(launches['warp_subvolume'] > 0, 'K4 was not launched on path (g)')

  # Coarse offsets: the known jitter, and the batched search's.
  bx, by = stitch_rigid_batched(tiles, args)
  for got, want, b, name in ((out['raw'][0], true_x, bx, 'x'),
                             (out['raw'][1], true_y, by, 'y')):
    print(f'  coarse {name} offsets {got[:, 0].tolist()}')
    check(np.array_equal(got, want, equal_nan=True),
          f'path (g) coarse {name} offsets differ from the cut\'s '
          f'{want[:, 0].tolist()}')
    check(np.array_equal(got, b, equal_nan=True),
          f'path (g) coarse {name} offsets differ from the batched search')
  solved = out['solved']
  move = float(torch.nan_to_num((solved - out['x0']).abs()).max())
  print(f'  fine flow: {out["flows"]} finite vectors; largest node move '
        f'in the joint solve {move:.3f} px (at least {STITCH_API_MOVE})')
  check(bool(torch.isfinite(solved).all()), 'path (g) meshes not finite')
  check(move >= STITCH_API_MOVE, 'path (g)\'s joint solve stayed at rest')
  canvas = torch.from_numpy(out['canvas']).to(dev)
  mask = torch.from_numpy(out['mask']).to(dev)
  err, cov = montage_error(canvas, mask, solved, out['key_to_idx'], img,
                           tile_t)
  print(f'  error {err:.3f} (gate {MONTAGE_ERR}), coverage {cov:.4f} (gate '
        f'{MONTAGE_COVERAGE})')
  check(err <= MONTAGE_ERR, f'path (g) montage error {err}')
  check(cov >= MONTAGE_COVERAGE, f'path (g) montage coverage {cov}')
  # K4 on the renders of tile (0, 0) and the bumped tile (1, 1): two
  # calls a tile (image and margin mask), in the tiles' order.
  k4_in = calls['warp_subvolume']
  check(len(k4_in) == 2 * len(tiles), 'path (g): K4 calls per tile')
  picks = [2 * i + c for i in (0, list(tiles).index((1, 1))) for c in (0, 1)]
  k4e = max(float((cuda_warp.shift_warp(*k4_in[i], counter='warp_subvolume')
                   - shift_warp_plain(*k4_in[i])).abs().max())
            for i in picks)
  print(f'  K4 on {len(picks)} of the {len(k4_in)} tile renders '
        f'({list(k4_in[0][1].shape)}): max |diff| {k4e:.3g} gray levels '
        f'(bar {RENDER_TOL})')
  check(k4e < RENDER_TOL, f'path (g): K4 differs from plain by {k4e}')
  # K8: the solve's first positions (each tile's regular grid) and last
  # ones (bent by the fine flow), and the last ones moved.
  k8e = k8_against_plain(calls['force_2d'], np.random.RandomState(SEED + 15),
                         'path (g)\'s joint solve')
  del calls, k4_in

  # The whole chain again with K4 and K8 swapped for their plain versions.
  t0 = time.perf_counter()
  with plain_kernels():
    ref = stitch_api_chain(tiles, *args)
  wall_plain = time.perf_counter() - t0
  dm = float(torch.nan_to_num((solved - ref['solved']).abs()).max())
  ref_canvas = torch.from_numpy(ref['canvas']).to(dev)
  ref_mask = torch.from_numpy(ref['mask']).to(dev)
  both = mask & ref_mask
  mask_diff = int((mask != ref_mask).sum())
  dc = (canvas - ref_canvas).abs()[both]
  grad, max_bar = chain_canvas_max_bar(tiles, dm)
  print(f'  against the plain kernels ({wall_plain:.1f} s): mesh max |diff| '
        f'{dm:.3g} px (bar {SMALL_MESH_TOL_2D}), canvas mean / max |diff| '
        f'{float(dc.mean()):.3g} / {float(dc.max()):.3g} (bar '
        f'{SMALL_CANVAS_TOL_2D[0]} / {max_bar:.3g} = {grad:.3g} gray '
        f'levels/px x the mesh gap + {RENDER_TOL}) where both masks are set, '
        f'mask differs at {mask_diff} px, steps {out["steps"]} / '
        f'{ref["steps"]}')
  check(all(np.array_equal(a, b, equal_nan=True)
            for a, b in zip(out['raw'], ref['raw'])),
        'path (g) coarse offsets differ from the plain run')
  check(torch.equal(torch.isnan(solved), torch.isnan(ref['solved'])),
        'path (g) mesh NaN pattern differs from the plain run')
  check(dm < SMALL_MESH_TOL_2D, 'path (g) meshes differ from the plain run')
  check(mask_diff <= MONTAGE_MASK_SHARE * both.numel(),
        'path (g) mask differs from the plain run')
  check(float(dc.mean()) < SMALL_CANVAS_TOL_2D[0]
        and float(dc.max()) < max_bar,
        'path (g) canvas differs from the plain run')
  report['K8']['launches_path_g'] = launches['force2d']
  report['K8']['max_abs_err_path_g'] = k8e
  report['K4p']['launches_path_g'] = launches['warp_subvolume']
  report['path_g'] = dict(
      wall_s=wall, solve_steps=out['steps'], error=err, coverage=cov,
      largest_move_px=move, fine_flow_vectors=out['flows'], k4_err=k4e,
      k8_launches=launches['force2d'],
      k4_launches=launches['warp_subvolume'], plain_wall_s=wall_plain,
      mesh_diff_plain=dm, canvas_mean_diff_plain=float(dc.mean()),
      canvas_max_diff_plain=float(dc.max()), canvas_max_bar=max_bar,
      tile_gradient=grad, mask_diff_plain=mask_diff, canvas=[n_m, n_m],
      **timings)
  del out, ref, canvas, mask, ref_canvas, ref_mask, both, dc, tiles, img
  torch.cuda.empty_cache()
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')


def chain_canvas_max_bar(tiles, mesh_gap: float) -> tuple[float, float]:
  """The largest canvas difference two renders of the same tiles may
  show when their meshes differ by at most `mesh_gap` px: a pixel's
  sampling position moves by at most `mesh_gap` along each axis, so its
  value moves by at most (|d/dx| + |d/dy|) * mesh_gap. The slope `g` is
  the tiles' largest one-pixel difference along x plus that along y (the
  texture is band-limited well below the pixel rate, so its interpolant
  is no steeper); the bar is g * mesh_gap plus the render bar
  RENDER_TOL. Returns (g, bar)."""
  gx = max(float((t[:, 1:] - t[:, :-1]).abs().max()) for t in tiles.values())
  gy = max(float((t[1:] - t[:-1]).abs().max()) for t in tiles.values())
  return gx + gy, (gx + gy) * mesh_gap + RENDER_TOL


def stitch_rigid_batched(tiles, args):
  """compute_coarse_offsets_batched on path (g)'s tiles and search grid."""
  from sofima_tpu_torch import stitch_rigid
  grid_t, _, overlaps, min_overlap = args
  return stitch_rigid.compute_coarse_offsets_batched(
      (grid_t, grid_t), tiles, overlaps_xy=(overlaps, overlaps),
      min_overlap=min_overlap)


def padfield3d_phase(dev, report) -> None:
  """compute_flow_map3d(flow_mode='padfield', mask_map=...) on the x pair
  of path (a)'s LICONN tiles cut to PADFIELD3D_ROWS rows, on the card and
  on the CPU: integer peaks equal, statistics by share; both timed."""
  from sofima_tpu_torch import stitch_elastic
  t_phase = time.perf_counter()
  zdim, tile_yx, overlap = LICONN
  n3 = 2 * tile_yx - overlap
  rows = PADFIELD3D_ROWS
  vol3 = texture3d((zdim, n3, n3), 9, dev)
  tiles, cx, _, _ = liconn_inputs(vol3, tile_yx, overlap)
  del vol3
  pair = {k: tiles[k][:, :rows].contiguous()[None] for k in ((0, 0), (1, 0))}
  masks = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in pair.items()}
  masks[(0, 0)][:, 20:26] = True                       # an invalid slab
  masks[(1, 0)][:, :, 40:120, :48] = True              # a box in the overlap
  kw = dict(tile_shape=(tile_yx, rows, zdim), offset_map=cx[:, :, :1],
            axis=0, patch_size=(32, 32, 32), stride=(16, 16, 16),
            batch_size=64, flow_mode='padfield')
  print(f'3d padfield: compute_flow_map3d(flow_mode=\'padfield\', '
        f'mask_map=...), path (a)\'s x pair cut to {zdim} x {rows} x '
        f'{tile_yx}, patch 32^3, stride 16')

  def run(device):
    on = {k: v.to(device) for k, v in pair.items()}
    mk = {k: v.to(device) for k, v in masks.items()}
    sync()
    t0 = time.perf_counter()
    flows, offs = stitch_elastic.compute_flow_map3d(on, mask_map=mk, **kw)
    sync()
    return flows[(0, 0)], offs, (time.perf_counter() - t0) * 1e3

  run(dev)  # warm-up (cuFFT plans)
  got, offs, ms_card = run(dev)
  ref, offs_cpu, ms_cpu = run('cpu')
  check(offs == offs_cpu, '3d padfield offsets differ from the CPU')
  n_nodes = int(torch.isfinite(ref[0]).sum())
  r = compare_flow(got.cpu(), ref, f'3d padfield flow ({list(ref.shape)})',
                   fraction=STAT_FRACTION_MASKED, dim=3)
  check(0 < n_nodes < ref[0].numel(), '3d padfield: no node estimated, or '
        'the masks deselected none')
  print(f'  card {ms_card:.1f} ms, CPU {ms_cpu:.1f} ms; {n_nodes} nodes '
        f'estimated of {ref[0].numel()}')
  report['padfield3d'] = dict(shape=list(ref.shape), nodes=n_nodes,
                              ms=ms_card, cpu_ms=ms_cpu, **r)
  del tiles, pair, masks, got, ref
  torch.cuda.empty_cache()
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')


def stitch_api_slice(dev, report, _build) -> None:
  """The tile-stitching library API: path (g) and the 3d padfield phase."""
  stitch_api_path(dev, report, _build)
  padfield3d_phase(dev, report)


def proc_stack(dev):
  """Path (h)'s [PROC_Z, PROC_N, PROC_N] float32 stack (numpy): the seeded
  texture, then copies warped by z x e2e_pipeline.py's smooth field (a
  linear resample, edge-clamped), section 1 zeroed in a central
  PROC_BLANK^2 square (missing data: a patch inside it correlates to
  exactly 0, a NaN row on the kernel and the plain version alike); and
  the square's [y0, y1) x [x0, x1) bounds."""
  from sofima_tpu_torch.ops import cuda_warp
  n = PROC_N
  tex = texture(n, dev)
  r = torch.arange(n, dtype=torch.float32, device=dev)
  y, x = r[:, None], r[None, :]
  dx = PROC_AMP * torch.sin(2 * np.pi * y / n) * torch.cos(np.pi * x / n)
  dy = PROC_AMP * torch.cos(2 * np.pi * x / n) * torch.sin(np.pi * y / n)
  sections = [tex]
  for z in range(1, PROC_Z):
    coords = torch.stack([torch.clamp(y + z * dy, 0, n - 1),
                          torch.clamp(x + z * dx, 0, n - 1)])[None]
    sections.append(cuda_warp.shift_warp(tex[None], coords.contiguous(),
                                         'linear')[0])
  stack = torch.stack(sections).cpu().numpy()
  b0 = (n - PROC_BLANK) // 2
  stack[1, b0:b0 + PROC_BLANK, b0:b0 + PROC_BLANK] = 0.0
  return stack, (b0, b0 + PROC_BLANK)


def processor_chain(stack, dev, timings):
  """examples/e2e_pipeline.py's chain through `runner.process_volume` with
  the em_2d defaults (patch 160, stride 40, batch 1024), each processor on
  work boxes of its own suggested size: EstimateFlow at 1x and on the 2x
  area-downsampled stack, ReconcileAndFilterFlows fusing the 2x flow,
  EstimateMissingFlow (device waves), ReconcileAndFilterFlows with
  reconcile_missing_flows_config, RelaxMesh sequential in z (solved
  sections kept in memory), InvertMap and WarpByMap (Lanczos). Returns
  every stage's volume (numpy)."""
  from sofima_tpu_torch.processor import flow as flow_proc
  from sofima_tpu_torch.processor import maps as maps_proc
  from sofima_tpu_torch.processor import mesh as mesh_proc
  from sofima_tpu_torch.processor import runner
  from sofima_tpu_torch.processor import warp as warp_proc
  from sofima_tpu_torch.processor.defaults import em_2d
  from sofima_tpu_torch.utils.bounding_box import BoundingBox
  from sofima_tpu_torch.utils.subvolume import Subvolume
  from sofima_tpu_torch.utils.volume import InMemoryVolume

  def stage(name, fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    timings[name] = time.perf_counter() - t0
    return out

  image_vol = InMemoryVolume(stack[None], fill_value=0.0)
  half = stack.reshape(PROC_Z, PROC_N // 2, 2, PROC_N // 2, 2).mean(
      axis=(2, 4), dtype=np.float64).astype(np.float32)
  half_vol = InMemoryVolume(half[None], pixel_size=(2, 2, 1), fill_value=0.0)
  flow_cfg = em_2d.estimate_flow_config()
  flow_1x = stage('flow_1x', lambda: runner.process_volume(
      flow_proc.EstimateFlow(flow_cfg, device=dev), image_vol))
  flow_2x = stage('flow_2x', lambda: runner.process_volume(
      flow_proc.EstimateFlow(flow_cfg, device=dev), half_vol))
  rec_cfg = dataclasses.replace(em_2d.reconcile_flows_config(),
                                flow_volinfos=[flow_2x])
  clean = stage('reconcile', lambda: runner.process_volume(
      flow_proc.ReconcileAndFilterFlows(rec_cfg, flow_1x, device=dev),
      flow_1x))
  miss_cfg = dataclasses.replace(em_2d.estimate_missing_flow_config(),
                                 image_volinfo=image_vol)
  missing = stage('missing_flow', lambda: runner.process_volume(
      flow_proc.EstimateMissingFlow(miss_cfg, device=dev), clean))
  final = stage('reconcile_missing', lambda: runner.process_volume(
      flow_proc.ReconcileAndFilterFlows(
          em_2d.reconcile_missing_flows_config(), missing, device=dev),
      missing))

  gy, gx = final.data.shape[2:]
  solved = {0: np.zeros((2, 1, gy, gx), np.float32)}

  class MemRelax(mesh_proc.RelaxMesh):

    def _load_stitched_tile(self, output_dir, box):
      z = int(box.start[2])
      return solved[z].copy() if z in solved else None

  relax_cfg = dataclasses.replace(em_2d.relax_mesh_config({
      'integration_config': {'stride': (STRIDE, STRIDE), 'k0': 0.1,
                             'num_iters': 500},
      'block_starts': [0]}), flows=[mesh_proc.FlowVolume(delta_z=1,
                                                        volume=final)])

  def relax():
    proc = MemRelax(relax_cfg, device=dev)
    for z in range(1, PROC_Z):
      out = proc.process(Subvolume(np.zeros((2, 1, gy, gx), np.float32),
                                   BoundingBox(start=(0, 0, z),
                                               size=(gx, gy, 1))))
      solved[z] = out.data.astype(np.float32)
    return InMemoryVolume(np.concatenate([solved[z] for z in range(PROC_Z)],
                                         axis=1))

  solved_vol = stage('relax', relax)
  inv_vol = stage('invert', lambda: runner.process_volume(
      maps_proc.InvertMap(maps_proc.InvertMap.Config(
          stride=float(STRIDE), crop_output=False, input_volume=solved_vol),
                          device=dev), solved_vol))
  warp_cfg = dataclasses.replace(
      em_2d.warp_config({'stride': float(STRIDE),
                         'interpolation': 'lanczos'}),
      map_volinfo=inv_vol, data_volinfo=image_vol)
  rendered = stage('warp', lambda: runner.process_volume(
      warp_proc.WarpByMap(warp_cfg, device=dev), image_vol))
  return dict(flow_1x=flow_1x.data, flow_2x=flow_2x.data, clean=clean.data,
              missing=missing.data, final=final.data, solved=solved_vol.data,
              inv=inv_vol.data, rendered=rendered.data[0])


def processor_slice(dev, report, _build, keep=None) -> dict:
  """Path (h): the em_2d processor pipeline (examples/e2e_pipeline.py's
  chain) on the card, its gates, and K1, K8 and K4p against their plain
  versions on the inputs the path gave them.

  Returns the kernels' launch counts from the path's run; `keep`, if
  given, receives the stack and the 1x EstimateFlow output (path (j)'s
  multi-process runner is held against them)."""
  from sofima_tpu_torch import flow_field
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_warp

  t_phase = time.perf_counter()
  stack, (b0, b1) = proc_stack(dev)
  print(f'path (h): the em_2d processor pipeline on {PROC_Z} x {PROC_N}^2 '
        f'(sections warped by z x a {PROC_AMP:g} px field, a {PROC_BLANK}^2 '
        f'zeroed square in section 1), patch 160, stride {STRIDE}')
  calls, timings = {}, {}
  _build.reset_launch_counts()
  with recorded_calls(calls, keep={'force_2d': 2, 'warp_subvolume': 16,
                                   'dense_flow_peaks': 24}):
    t0 = time.perf_counter()
    out = processor_chain(stack, dev, timings)
    sync()
    wall = time.perf_counter() - t0
  launches_h = dict(_build.launch_counts)
  if keep is not None:
    keep.update(stack=stack, flow_1x=out['flow_1x'])
  print('  stage seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s; launches {launches_h}')
  for k in ('dense_flow_peaks', 'force2d', 'warp_subvolume'):
    check(launches_h[k] > 0, f'kernel {k} was not launched on path (h)')

  # e2e_pipeline.py's gate (section 1 against section 0 on the interior,
  # a patch's margin); the later sections' residuals are printed beside.
  rendered, sel = out['rendered'], np.s_[160:-160, 160:-160]
  res = []
  for z in range(1, PROC_Z):
    before = float(np.abs(stack[z] - stack[0])[sel].mean())
    after = float(np.abs(rendered[z] - stack[0])[sel].mean())
    res.append((before, after))
  print('  residual against section 0 before / after: ' + ', '.join(
      f'z={z} {b:.2f} / {a:.2f}' for z, (b, a) in enumerate(res, 1)))
  check(res[0][1] < 0.5 * res[0][0], f'path (h): residual {res[0][1]} '
        f'against {res[0][0]} before (e2e_pipeline.py\'s gate)')

  # The chunked flow against one whole-section call (no seams): node i of
  # the whole call is the processor's node i + 2 (its patch centred at
  # i * 40 + 80). The runner back-shifts the last work box of a row to
  # end at the volume's edge (+ context), as the reference's runner does;
  # where PROC_N + 160 - 1280 is not a multiple of the stride, that box
  # starts off the node grid and writes its patches (centred up to a
  # stride away) from node `aligned` on (ROADMAP.md Queue 3, records on
  # the reference side), so the comparison covers the nodes before it.
  flow = out['flow_1x']
  box = 160 * 8
  last = PROC_N + 160 - box  # the back-shifted box's output start, px
  aligned = last // STRIDE if last % STRIDE else flow.shape[-1]
  pre_t = torch.from_numpy(stack).to(dev)
  whole = torch.stack([flow_field.dense_flow_field(
      pre_t[z - 1], pre_t[z], (160, 160), (STRIDE, STRIDE), circular=True)
                       for z in range(1, PROC_Z)])
  g = min(whole.shape[-1], aligned - 2)
  whole = whole[..., :g, :g]
  chunked = torch.from_numpy(flow[:, 1:, 2:2 + g, 2:2 + g].copy()).to(dev)
  seams = compare_flow(chunked.reshape(4, -1, g),
                       whole.permute(1, 0, 2, 3).reshape(4, -1, g),
                       f'chunked EstimateFlow against whole-section K1 '
                       f'({PROC_Z - 1} x {g}^2 nodes before the off-grid '
                       f'last box at node {aligned})')
  del pre_t, whole, chunked

  # Section 2's hole: the nodes whose patch lies inside section 1's blank
  # square and that are NaN after reconcile (the 2x flow refills some),
  # then refilled from Δz = 2 by EstimateMissingFlow.
  half = 160 // 2
  i0, i1 = -(-(b0 + half) // STRIDE), (b1 - half) // STRIDE + 1
  hole = np.isnan(out['clean'][0, 2, i0:i1, i0:i1])
  miss = out['missing'][:, 2, i0:i1, i0:i1]
  filled = (np.isfinite(miss[0]) & (miss[2] == 2))[hole]
  share = float(filled.mean()) if hole.any() else 0.0
  print(f'  section 2\'s hole: {int(hole.sum())} of {hole.size} nodes inside '
        f'the blank NaN after reconcile; refilled from Δz = 2: {share:.3f} '
        f'(gate {PROC_FILLED}); final flow valid '
        f'{float(np.isfinite(out["final"][0, 1:]).mean()):.3f}')
  check(int(hole.sum()) >= 4, 'path (h): section 2\'s hole was not invalid')
  check(share >= PROC_FILLED,
        'path (h): section 2\'s hole was not refilled from Δz = 2')
  check(bool(np.isfinite(out['solved']).all()), 'path (h): meshes not finite')

  # K1, K8 and K4p against their plain versions on the inputs path (h)
  # gave them: K1 on the first work items' section pairs, K8 on the last
  # section's first and last solve positions, K4p on the first renders
  # (and the last).
  k1_in = calls['dense_flow_peaks']
  k1h = compare_flow(
      torch.cat([cuda_flow.dense_flow_peaks(*a).reshape(4, -1)
                 for a in k1_in], 1),
      torch.cat([dense_flow_peaks_plain(*a).reshape(4, -1) for a in k1_in],
                1), f'K1 on {len(k1_in)} of path (h)\'s section pairs '
      f'({list(k1_in[0][0].shape)}, ...)')
  k8h = k8_against_plain(calls['force_2d'], np.random.RandomState(SEED + 21),
                         'path (h)\'s last solve')
  k4h = max(float((cuda_warp.shift_warp(*a) - shift_warp_plain(*a))
                  .abs().max()) for a in calls['warp_subvolume'])
  print(f'  K4p on {len(calls["warp_subvolume"])} of path (h)\'s renders '
        f'({list(calls["warp_subvolume"][0][1].shape)}, ...): max |diff| '
        f'{k4h:.3g} gray levels (bar {RENDER_TOL})')
  check(k4h < RENDER_TOL, f'K4p differs from the plain render by {k4h}')
  del calls, k1_in
  report['K1']['max_abs_err_path_h'] = k1h['err']
  report['K1']['stat_frac_path_h'] = k1h['stat_frac']
  report['K1']['launches_path_h'] = launches_h['dense_flow_peaks']
  report['K8']['max_abs_err_path_h'] = k8h
  report['K8']['launches_path_h'] = launches_h['force2d']
  report['K4p']['max_abs_err_path_h'] = k4h
  report['K4p']['launches_path_h'] = launches_h['warp_subvolume']
  report['path_h'] = dict(
      wall_s=wall, residual_before_after=res, seams_stat_frac=seams[
          'stat_frac'], seams_nodes=3 * g * g, off_grid_node=aligned,
      hole_nodes=int(hole.sum()), hole_refilled=share,
      k1_launches=launches_h['dense_flow_peaks'],
      k8_launches=launches_h['force2d'],
      k4p_launches=launches_h['warp_subvolume'], **timings)
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return launches_h


def dec_affine(scale: float | None = None) -> np.ndarray:
  """Path (i)'s known affine as WarpAffine takes it: [2, 3], xy rows
  (rotation about the origin, then the shift); `scale` overrides its
  scale (1.0: the euclidean pair's)."""
  deg, s, (tx, ty) = DEC_AFFINE
  s = s if scale is None else scale
  c, n = s * np.cos(np.deg2rad(deg)), s * np.sin(np.deg2rad(deg))
  return np.array([[c, -n, tx], [n, c, ty]])


def dec_field(pos):
  """Path (h)'s smooth field (PROC_AMP px) at pixel positions `pos`
  (tensors broadcasting to [y, x]) of a PROC_N^2 section: (dx, dy)."""
  n = PROC_N
  y, x = pos
  return (PROC_AMP * torch.sin(2 * np.pi * y / n) * torch.cos(np.pi * x / n),
          PROC_AMP * torch.cos(2 * np.pi * x / n) * torch.sin(np.pi * y / n))


def dec_field3d(dev):
  """Path (i)'s smooth 3d field (DEC_3D_AMP px) on DEC_3D's grid, as a
  relative coordinate map [3, z, y, x] with (x, y, z) channels."""
  d, h, w = DEC_3D
  z, y, x = torch.meshgrid(*[torch.arange(k, dtype=torch.float32, device=dev)
                             for k in DEC_3D], indexing='ij')
  a = DEC_3D_AMP
  return torch.stack([
      a * torch.sin(2 * np.pi * y / h) * torch.cos(np.pi * z / d),
      a * torch.cos(2 * np.pi * x / w) * torch.sin(np.pi * z / d),
      0.5 * a * torch.sin(np.pi * x / w) * torch.sin(np.pi * y / h)])


def dec_inputs(dev) -> dict:
  """Path (i)'s inputs: path (h)'s sections 0 and 1 ([x, y] numpy, as the
  decorators read them), bench's mask at their size, path (a)'s tile
  volume (texture3d) and its copy moved by `dec_field3d` (the field's
  linear resample, edge-clamped; [x, y, z] numpy), and rolled copies."""
  from sofima_tpu_torch.ops import interp
  stack, _ = proc_stack(dev)
  vol = texture3d(DEC_3D, 9, dev)
  field = dec_field3d(dev)
  grid = torch.meshgrid(*[torch.arange(k, dtype=torch.float32, device=dev)
                          for k in DEC_3D], indexing='ij')
  coords = torch.stack([grid[0] + field[2], grid[1] + field[1],
                        grid[2] + field[0]])
  del grid
  moved = interp.sample(vol, coords, 'linear', mode='nearest')
  del coords
  xyz = lambda t: t.permute(2, 1, 0).cpu().numpy()
  out = dict(
      sec0=stack[0].T.copy(), sec1=stack[1].T.copy(),
      mask=bench_mask(PROC_N, dev).cpu().numpy().T.copy(),
      rolled=np.roll(stack[0], DEC_ROLL, (0, 1)).T.copy(),
      vol=xyz(vol), moved3=xyz(moved),
      rolled3=xyz(torch.roll(vol, DEC_ROLL3, (0, 1, 2))),
      field3=field.cpu().numpy())
  del stack, vol, moved, field
  torch.cuda.empty_cache()
  return out


def dec_flow_share(flow, field, sign: float) -> float:
  """The share of the finite nodes of a padded flow ([c, ...] numpy) whose
  x/y[/z] lie within DEC_FLOW_PX of `sign` x the known field at the
  nodes (`field` [dim, ...])."""
  dim = len(field)
  ok = np.isfinite(flow[:dim]).all(0)
  err = np.zeros(ok.shape, bool)
  for c in range(dim):
    err |= np.abs(np.nan_to_num(flow[c]) - sign * field[c]) > DEC_FLOW_PX
  return float((ok & ~err).sum() / max(int(ok.sum()), 1))


def dec_corner_px(got, truth, size) -> float:
  """Largest distance between the images of the corners of a `size` (x, y)
  image under two [2, 3] xy transforms."""
  w, h = size
  corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1],
                      [w - 1, h - 1, 1]], np.float64).T
  return float(np.linalg.norm((np.asarray(got) - truth) @ corners,
                              axis=0).max())


def timed(timings: dict, name: str, fn):
  """`fn()`, its wall (device synchronized) into `timings[name]`."""
  sync()
  t0 = time.perf_counter()
  out = fn()
  sync()
  timings[name] = time.perf_counter() - t0
  return out


def dec_kernel_chunks(dev, d, timings) -> dict:
  """The chunk functions of path (i) that launch kernels on the card: the
  circular OptimFlow (K1), the masked one (K5), MeshRelaxFlowFilter 2d
  (K8) and 3d (K9), WarpAffine 2d on both known affines (K12) and 3d
  (K13). Numpy out; each stage's wall into `timings`."""
  from sofima_tpu_torch.decorators import flow as dflow
  from sofima_tpu_torch.decorators import warp as dwarp

  def stage(name, fn):
    return timed(timings, name, fn)

  flow_kw = dict(patch_zyx=(160, 160), step_zyx=(STRIDE, STRIDE),
                 batch_size=1024, pad=True, device=dev, mode='circular_dft')
  return dict(
      circular=stage('flow_circular', lambda: dflow._optim_flow(
          d['sec1'], d['sec0'], **flow_kw)),
      masked=stage('flow_masked', lambda: dflow._optim_flow(
          d['sec1'], d['sec0'], input_mask=d['mask'], fixed_mask=d['mask'],
          **flow_kw)),
      mesh2d=stage('relax_2d', lambda: dflow._mesh_relax_flow(
          d['clean2d'], device=dev, **d['cfg2d'])),
      warp_affine=stage('warp_affine_2d', lambda: dwarp._warp_affine(
          d['sec0'], dec_affine(), device=dev)),
      warp_euclid=stage('warp_euclid_2d', lambda: dwarp._warp_affine(
          d['sec0'], dec_affine(1.0), device=dev)),
      mesh3d=stage('relax_3d', lambda: dflow._mesh_relax_flow(
          d['clean3d'], device=dev, **d['cfg3d'])),
      warp3d=stage('warp_affine_3d', lambda: dwarp._warp_affine(
          d['vol'], d['m3'], device=dev)))


def decorator_slice(dev, report, _build) -> dict:
  """Path (i): the decorator layer's chunk functions (what each decorator's
  read_fn computes; the card has no tensorstore, so `decorate` itself is
  not run) on path (h)'s sections and path (a)'s tile volume, the
  registration ops against the CPU, the checkpointing relaxer's resume,
  and the kernels of the path against their plain versions (the path run
  again under `plain_kernels`).

  Returns the kernels' launch counts from the path's run."""
  import tempfile
  from sofima_tpu_torch.decorators import affine as daffine
  from sofima_tpu_torch.decorators import flow as dflow
  from sofima_tpu_torch.decorators import maps as dmaps
  from sofima_tpu_torch.decorators import warp as dwarp
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.ops import registration
  from sofima_tpu_torch.processor.defaults import em_2d
  from sofima_tpu_torch.pipeline import stitch3d
  from sofima_tpu_torch.utils import checkpoint

  t_phase = time.perf_counter()
  d = dec_inputs(dev)
  print(f'path (i): the decorator layer\'s chunk functions on path (h)\'s '
        f'sections 0 and 1 ({PROC_N}^2, patch 160, stride {STRIDE}, batch '
        f'1024, padded) and path (a)\'s tile volume {DEC_3D} moved by a '
        f'{DEC_3D_AMP:g} px field; {smi()}')
  timings, gates = {}, {}

  def stage(name, fn):
    return timed(timings, name, fn)

  def gate(name, value, ok, bar):
    gates[name] = value
    print(f'  {name}: {value:.6g} (bar {bar})')
    check(ok, f'path (i): {name} {value} (bar {bar})')

  cfg2d = dataclasses.asdict(em_2d.relax_mesh_config().integration_config)
  cfg3d = dataclasses.asdict(stitch3d.Stitch3dConfig().mesh_cfg)
  clean_kw = dict(min_peak_ratio=1.6, min_peak_sharpness=1.6,
                  max_magnitude=40, max_deviation=10, device=dev)
  rec_kw = dict(max_gradient=0, max_deviation=20, min_patch_size=400,
                device=dev)
  flow_kw = dict(patch_zyx=(160, 160), step_zyx=(STRIDE, STRIDE),
                 batch_size=1024, pad=True, device=dev)
  th = np.deg2rad(0.5)
  d['m3'] = np.array([[np.cos(th), -np.sin(th), 0, 2.5],
                      [np.sin(th), np.cos(th), 0, -1.25], [0, 0, 1, 0.75]])

  _build.reset_launch_counts()
  t0 = time.perf_counter()
  # The flows: padfield (the default; torch.fft, no kernel), then cleaned
  # and reconciled at the em_2d defaults; the 3d padfield flow, cleaned.
  flow_pf = stage('flow_padfield', lambda: dflow._optim_flow(
      d['sec1'], d['sec0'], **flow_kw))
  # The reconcile filter squeezes singleton dims, as the reference's does,
  # so a single section cannot pass it: it takes the cleaned padfield flow
  # with a second section, the cleaned padfield flow at 2x the stride
  # (every other node, upsampled by repetition), and section 0 goes on.
  clean = stage('clean', lambda: dflow._clean_flow(flow_pf, **clean_kw))
  coarse = np.repeat(np.repeat(clean[:, :, ::2, ::2], 2, 2), 2, 3)[
      :, :, :clean.shape[2], :clean.shape[3]]
  d['clean2d'] = stage('reconcile', lambda: dflow._reconcile_flow(
      np.concatenate([clean, coarse], 1), **rec_kw))[:, :1].copy()
  flow3 = stage('flow_padfield_3d', lambda: dflow._optim_flow(
      d['moved3'], d['vol'], (32, 32, 32), (16, 16, 16), 64, True,
      device=dev))
  d['clean3d'] = dflow._clean_flow(flow3, **clean_kw)
  d['cfg2d'], d['cfg3d'] = cfg2d, cfg3d
  out = dec_kernel_chunks(dev, d, timings)
  mesh2d = out['mesh2d']
  # The maps: a translation's dense map (MakeAffineCoordMap's chunk) and
  # ComposeCoordMaps' chunk of the solved mesh with it.
  shift = np.array([[1, 0, 0, 2.5], [0, 1, 0, -1.5], [0, 0, 1, 0]])
  g = mesh2d.shape[-1]
  aff_map = stage('make_affine_map', lambda: dmaps.map_utils.make_affine_map(
      shift, dmaps.BoundingBox(start=(0, 0, 0), size=(g, g, 1)), (1, 1, 1)))
  composed = stage('compose_maps', lambda: dmaps._compose_coord_maps(
      mesh2d, aff_map[:2].astype(np.float32), device=dev,
      start1=(0, 0, 0), start2=(0, 0, 0), stride1=float(STRIDE),
      stride2=float(STRIDE)))
  # ECC on the known affines (the crop both sections fill), the
  # translations of rolled copies, WarpCoordMap by the 3d field.
  m = DEC_MARGIN
  crop = np.s_[m:-m, m:-m]
  fix_c = d['sec0'][crop]
  shift_m = np.eye(3)
  shift_m[:2, 2] = m
  ecc = {}
  for motion, warped, scale in (('affine', out['warp_affine'], None),
                                ('euclidean', out['warp_euclid'], 1.0)):
    truth = (np.linalg.inv(shift_m) @ np.vstack([dec_affine(scale),
                                                 [0, 0, 1]]) @ shift_m)[:2]
    got = stage(f'ecc_{motion}', lambda: daffine._optim_affine_sections(
        [(fix_c, warped[crop])], motion=motion, device=dev)[..., 0])
    ecc[motion] = (got, truth, warped[crop])
    gate(f'ecc_{motion}_corner_px', dec_corner_px(got, truth, fix_c.shape),
         dec_corner_px(got, truth, fix_c.shape) < DEC_CORNER_PX,
         DEC_CORNER_PX)
  t2 = stage('translation_2d', lambda: daffine._optim_translation(
      d['sec0'], d['rolled'], device=dev))
  t3 = stage('translation_3d', lambda: daffine._optim_translation(
      d['vol'], d['rolled3'], device=dev))
  want2 = -np.asarray(DEC_ROLL[::-1], np.float64)
  want3 = -np.asarray(DEC_ROLL3[::-1], np.float64)
  check(np.array_equal(t2[:, 2], want2) and np.array_equal(t2[:, :2],
                                                          np.eye(2)),
        f'path (i): 2d translation {t2[:, 2]}, want {want2}')
  check(np.array_equal(t3[:, 3], want3) and np.array_equal(t3[:, :3],
                                                          np.eye(3)),
        f'path (i): 3d translation {t3[:, 3]}, want {want3}')
  print(f'  translations exact: 2d {t2[:, 2].tolist()}, 3d '
        f'{t3[:, 3].tolist()}')
  warped3 = stage('warp_coord_map_3d', lambda: dwarp._warp_coord_map(
      d['vol'], d['field3'], device=dev))
  # Checkpoint: one run to convergence, one stopped at a snapshot and
  # resumed; K8 must repeat its bits for the resume to.
  x_in = torch.from_numpy(np.ascontiguousarray(d['clean2d'])).to(dev)
  f_a = cuda_mesh.force_2d(x_in, 0.1, (STRIDE, STRIDE))
  k8_bits = same_bits(f_a, cuda_mesh.force_2d(x_in, 0.1, (STRIDE, STRIDE)))
  # Path (h)'s relax settings (e2e_pipeline's k0 and chunk).
  cfg_ck = dataclasses.replace(em_2d.relax_mesh_config().integration_config,
                               k0=0.1, num_iters=500)
  x0 = np.zeros_like(d['clean2d'])
  prev2d = d['clean2d']

  def relax(path, cfg):
    return checkpoint.CheckpointingRelaxer(
        path, cfg, save_every=DEC_SAVE_EVERY, device=dev).run(x0, prev2d)

  with tempfile.TemporaryDirectory() as tmp:
    whole, steps = stage('checkpoint_whole', lambda: relax(
        os.path.join(tmp, 'a.npz'), cfg_ck))
    per_save = DEC_SAVE_EVERY * cfg_ck.num_iters
    stop = max(per_save, (steps // 2) // per_save * per_save)
    path = os.path.join(tmp, 'b.npz')
    stage('checkpoint_stopped', lambda: relax(
        path, dataclasses.replace(cfg_ck, max_iters=stop)))
    snap_step = int(checkpoint.load_solver_state(path)['step'])
    resumed, steps_r = stage('checkpoint_resumed', lambda: relax(path,
                                                                  cfg_ck))
  wall = time.perf_counter() - t0
  launches = dict(_build.launch_counts)
  names = {'K1': 'dense_flow_peaks', 'K5': 'masked_flow_peaks',
           'K8': 'force2d', 'K9': 'force3d', 'K12': 'ndimage_warp',
           'K13': 'warp_gather_3d'}
  counts = {k: launches[v] for k, v in names.items()}
  counts['K5'] += launches['masked_flow_pure']
  print(f'  wall {wall:.3f} s; stage seconds: ' + ', '.join(
      f'{k} {v:.3f}' for k, v in timings.items()))
  print(f'  launches on path (i): {counts} (K5 dense route '
        f'{launches["masked_flow_peaks"]}, pure route '
        f'{launches["masked_flow_pure"]})')
  for k, n in counts.items():
    check(n > 0, f'kernel {k} was not launched on path (i)')

  # Gates on what came out.
  n = PROC_N
  k_nodes = flow_pf.shape[-1]
  pos = torch.arange(k_nodes, dtype=torch.float32) * STRIDE
  fx, fy = dec_field((pos[:, None], pos[None, :]))
  field2 = np.stack([fx.numpy(), fy.numpy()])
  for name, f in (('padfield', flow_pf), ('circular', out['circular']),
                  ('masked', out['masked'])):
    share = dec_flow_share(f[:, 0], field2, -1.0)
    gate(f'flow_{name}_share', share, share >= DEC_FLOW_SHARE,
         DEC_FLOW_SHARE)
  pos3 = [torch.arange(k, dtype=torch.float32) * 16 for k in flow3.shape[1:]]
  f3 = dec_field3d('cpu')
  idx = np.ix_(*[np.minimum(p.long().numpy(), s - 1)
                 for p, s in zip(pos3, DEC_3D)])
  field3 = np.stack([f3[c].numpy()[idx] for c in range(3)])
  share3 = dec_flow_share(flow3, field3, -1.0)
  print(f'  3d padfield flow {list(flow3.shape)}: {share3:.4f} of the finite '
        f'nodes within {DEC_FLOW_PX} px of the field (not gated)')
  # Composed with a translation's map, the mesh moves by the translation
  # wherever it stays on the grid (compose_maps_fast clamps at the edge:
  # the inner nodes, the mesh moving less than a stride), up to the f32
  # rounding of absolute coordinates of up to PROC_N px (DEC_COMPOSE_PX).
  inner2 = np.s_[:, :, 1:-1, 1:-1]
  valid = (np.isfinite(composed[inner2]).all(0)
           & np.isfinite(mesh2d[inner2]).all(0))
  comp_err = float(np.abs(composed[inner2] - mesh2d[inner2] - np.array(
      [2.5, -1.5])[:, None, None, None])[:, valid].max())
  gate('compose_translation_err', comp_err, comp_err < DEC_COMPOSE_PX,
       DEC_COMPOSE_PX)
  inner = np.s_[5:-5, 5:-5, 5:-5]
  wcm = float(np.abs(warped3 - d['moved3'])[inner].max())
  gate('warp_coord_map_3d_err', wcm, wcm < 1e-2, 1e-2)
  check(bool(np.isfinite(mesh2d).all() and np.isfinite(out['mesh3d']).all()),
        'path (i): meshes not finite')
  print(f'  K8 repeats its bits: {k8_bits}; checkpoint: {steps} steps whole, '
        f'stopped at {snap_step}, resumed to {steps_r}')
  check(snap_step == stop and steps_r == steps,
        f'path (i): checkpoint steps {snap_step} / {steps_r}, want {stop} / '
        f'{steps}')
  ck_err = float((whole - resumed).abs().max())
  if k8_bits:
    check(same_bits(whole, resumed), 'path (i): the resumed relaxation '
          'differs from the whole one')
  gate('checkpoint_resume_px', ck_err, ck_err < 1e-5, 1e-5)

  # Registration on the card against the CPU: ECC on a centre crop,
  # both translations.
  c0 = (fix_c.shape[0] - DEC_ECC_CROP) // 2
  sub = np.s_[c0:c0 + DEC_ECC_CROP, c0:c0 + DEC_ECC_CROP]
  ecc_cpu = 0.0
  for motion, (_, _, mov_c) in ecc.items():
    got = registration.optim_transform(fix_c[sub], mov_c[sub], motion=motion,
                                       device=dev)[1]
    ref = registration.optim_transform(fix_c[sub], mov_c[sub], motion=motion,
                                       device='cpu')[1]
    ecc_cpu = max(ecc_cpu, float(np.abs(got - ref).max()))
  gate('ecc_card_vs_cpu', ecc_cpu, ecc_cpu < 1e-3, 1e-3)
  for name, (fix, mov, got) in (('2d', (d['sec0'], d['rolled'], t2)),
                                ('3d', (d['vol'], d['rolled3'], t3))):
    ref = daffine._optim_translation(fix, mov, device='cpu')
    check(np.array_equal(got, ref), f'path (i): {name} translation differs '
          f'from the CPU')
  print('  translations equal on the card and the CPU')

  # The kernels against their plain versions: the path's kernel chunks
  # again with every kernel swapped (nothing may launch), on the same
  # inputs.
  plain_t = {}
  before = dict(_build.launch_counts)
  with plain_kernels():
    plain = dec_kernel_chunks(dev, d, plain_t)
  check(dict(_build.launch_counts) == before,
        'path (i): a kernel launched under plain_kernels')
  errs = {}
  for name, key in (('K1', 'circular'), ('K5', 'masked')):
    r = compare_flow(torch.from_numpy(out[key][:, 0]).reshape(4, -1),
                     torch.from_numpy(plain[key][:, 0]).reshape(4, -1),
                     f'{name} (OptimFlow {key}) against plain')
    errs[name] = r
  for name, key in (('K8', 'mesh2d'), ('K9', 'mesh3d')):
    e = float(np.abs(out[key] - plain[key]).max())
    errs[name] = dict(err=e)
    gate(f'{name}_mesh_vs_plain_px', e, e < VERLET_TOL, VERLET_TOL)
  for name, keys in (('K12', ('warp_affine', 'warp_euclid')),
                     ('K13', ('warp3d',))):
    e = max(float(np.abs(out[k] - plain[k]).max()) for k in keys)
    errs[name] = dict(err=e)
    gate(f'{name}_render_vs_plain', e, e < 1e-3 * 255, 1e-3 * 255)
  print(f'  plain run stage seconds: ' + ', '.join(
      f'{k} {v:.3f}' for k, v in plain_t.items()))
  for key, r in errs.items():
    report[key]['max_abs_err_path_i'] = r['err']
    report[key]['launches_path_i'] = counts[key]
  report['path_i'] = dict(
      wall_s=wall, plain_s=sum(plain_t.values()), launches=counts,
      checkpoint_steps=steps, checkpoint_stop=stop, k8_same_bits=k8_bits,
      **gates, **timings)
  del d, out, plain
  torch.cuda.empty_cache()
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return launches


def stitch_render_phase(dev, report, _build, tiles, out, vol3, sel,
                        stride3, margin) -> None:
  """StitchAndRender3dTiles (the LICONN notebook's render processor) on
  path (a)'s tiles and solved meshes, written to an .npz in a temporary
  directory, through `runner.process_volume`: path (a)'s rel_err and
  coverage gates, and K13 against its plain version on recorded inputs."""
  import tempfile
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.processor import runner
  from sofima_tpu_torch.processor import warp as warp_proc
  from sofima_tpu_torch.utils.volume import InMemoryVolume
  zdim, ny, nx = vol3.shape
  key_to_idx = out['key_to_idx']
  ids = {key: i for i, key in enumerate(sorted(key_to_idx))}
  grid_x = max(tx for tx, _ in ids) + 1
  grid_y = max(ty for _, ty in ids) + 1
  tile_map = [[ids[(tx, ty)] for tx in range(grid_x)]
              for ty in range(grid_y)]
  by_id = {ids[key]: t.cpu().numpy() for key, t in tiles.items()}

  class Tiles(warp_proc.StitchAndRender3dTiles):

    def _open_tile_volume(self, tile_id):
      return by_id[tile_id]

  calls = {}
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, 'meshes.npz')
    np.savez(path, x=out['solved'].cpu().numpy(),
             key_to_idx=np.array(dict(key_to_idx)))
    Tiles.reset_caches()
    proc = Tiles(tile_map=tile_map, tile_mesh_path=path, stride=stride3,
                 margin=margin, work_size=(nx // 4, ny // 4, zdim),
                 device=dev)
    canvas = InMemoryVolume(np.zeros((1, zdim, ny, nx), np.float32))
    _build.reset_launch_counts()
    with recorded_calls(calls, keep={'shift_warp_3d': 8}):
      t0 = time.perf_counter()
      img = runner.process_volume(proc, canvas,
                                  subvolume_size=(nx // 2, ny // 2, zdim))
      sync()
      wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    Tiles.reset_caches()
  render = torch.from_numpy(img.data[0]).to(dev)[sel]
  truth = vol3[sel]
  m = render != 0
  cnt = int(m.sum())
  rel = float(torch.where(m, (render - truth).abs(),
                          torch.zeros_like(truth)).sum()
              / max(cnt, 1) / truth.std(correction=0))
  cov = cnt / truth.numel()
  k13 = max(float((cuda_warp.shift_warp_3d(*a) - cuda_warp.shift_warp_3d_plain(
      a[0], a[1], a[2], a[3:9], a[9:12])).abs().max())
            for a in calls['shift_warp_3d'])
  print(f'3d render processor (StitchAndRender3dTiles) on path (a)\'s tiles '
        f'and meshes: {wall:.3f} s, rel_err {rel:.4f} (gate '
        f'{STITCH_REL_ERR}), coverage {cov:.4f} (gate {STITCH_COVERAGE}); '
        f'K13 on {len(calls["shift_warp_3d"])} recorded renders: max |diff| '
        f'{k13:.3g} (bar {RENDER_TOL}); launches {launches}')
  check(launches['warp_gather_3d'] > 0,
        'K13 was not launched by StitchAndRender3dTiles')
  check(rel <= STITCH_REL_ERR, f'3d render processor rel_err {rel}')
  check(cov >= STITCH_COVERAGE, f'3d render processor coverage {cov}')
  check(k13 < RENDER_TOL, f'K13 differs from plain by {k13} (processor)')
  report['K13']['max_abs_err_processor'] = k13
  report['K13']['launches_processor'] = launches['warp_gather_3d']
  report['render3d_processor'] = dict(
      wall_s=wall, rel_err=rel, coverage=cov,
      k13_launches=launches['warp_gather_3d'])


def per_axis_phase(dev) -> None:
  """K1, K2, K5 and K6 with per-axis peak windows (PER_AXIS) against their
  plain versions, and a sequence of equal entries repeating the scalar
  call bit for bit (the kernels take the windows; nothing routes a
  sequence to the plain version)."""
  from sofima_tpu_torch.ops import cuda_flow
  md, pr = PER_AXIS
  n = 2048
  pre = texture(n, dev)
  post = torch.roll(pre, (5, -7), (0, 1)).contiguous()
  valid = (~bench_mask(n, dev)).to(torch.float32)
  gm = (n - (160 - 40)) // 40
  geo = cuda_flow.targeted_geometry((n, n), (80, 80), (40, 40))
  offs = torch.zeros((geo['nrsteps'], geo['ngroups'], 2), dtype=torch.int32)
  offs += torch.tensor([5, -7], dtype=torch.int32)
  rng = np.random.RandomState(SEED + 22)
  ys = torch.from_numpy(rng.randint(8, n - 168, 512)).to(dev)
  xs = torch.from_numpy(rng.randint(8, n - 88, 512)).to(dev)
  a1 = torch.arange(160, device=dev)[None, :, None]
  a2 = torch.arange(80, device=dev)[None, None, :]

  def cut(dy, dx):
    return pre[ys[:, None, None] + dy + a1,
               xs[:, None, None] + dx + a2].contiguous()

  pa, pb = cut(0, 0), cut(-5, 7)
  k2 = lambda a, b, o, **w: cuda_flow.dense_flow_peaks_targeted(
      a, b, o, (80, 80), (40, 40), max_offset=16, peak_crop=32, **w)
  cases = {  # kernel, plain version (on the card; K2's on the CPU)
      'K1': (lambda **w: cuda_flow.dense_flow_peaks(pre, post, (160, 160),
                                                    (40, 40), **w),
             lambda **w: dense_flow_peaks_plain(pre, post, (160, 160),
                                                (40, 40), **w)),
      'K2': (lambda **w: k2(pre, post, offs.to(dev), **w),
             lambda **w: k2(pre.cpu(), post.cpu(), offs, **w).to(dev)),
      'K5': (lambda **w: cuda_flow.masked_dense_flow_peaks(
          pre, post, valid, valid, (160, 160), (40, 40), **w),
             lambda min_distance=2, peak_radius=5: (
                 cuda_flow.masked_flow_peaks_plain(
                     pre, post, valid, valid, (gm, gm), 160, (40, 40), None,
                     min_distance, 0.5, peak_radius))),
      'K6': (lambda **w: cuda_flow.flow_peaks(pa, pb, **w).T,
             lambda **w: cuda_flow.patch_flow_peaks_plain(pa, pb, **w).T),
  }
  print(f'per-axis peak windows min_distance={md}, peak_radius={pr}: K1, K2, '
        'K5, K6 against their plain versions')
  for name, (kernel, plain) in cases.items():
    compare_flow(kernel(min_distance=md, peak_radius=pr),
                 plain(min_distance=md, peak_radius=pr), f'{name} per-axis',
                 STAT_FRACTION_MASKED if name in ('K5', 'K6')
                 else STAT_FRACTION)
    check(same_bits(kernel(), kernel(min_distance=(2, 2),
                                     peak_radius=(5, 5))),
          f'{name}: (2, 2) / (5, 5) windows differ from the scalar call')
  del pre, post, valid, pa, pb


def shard_configs():
  """Path (j)'s solver configs: bench.py's `mesh` stage (2d), the same
  with drift removal, and path (b)'s (3d)."""
  from sofima_tpu_torch import mesh
  cfg2 = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
      num_iters=1000, max_iters=1000, stop_v_max=0.0, dt_max=100.0)
  cfg3 = dataclasses.replace(cfg2, stride=(40.0, 40.0, 40.0), num_iters=200,
                             max_iters=200)
  return cfg2, dataclasses.replace(cfg2, remove_drift=True), cfg3


def shard_meshes() -> dict:
  """Path (j)'s seeded meshes (numpy): the 2d mesh, the 2d mesh with
  SHARD_NAN_ROWS NaN rows added (and its `prev`, 0.1 px from it) and the
  3d mesh. Every rank and the smoke run make the same."""
  rng = np.random.RandomState(SEED + 30)
  x2 = rng.randn(2, 1, *MESH2D).astype(np.float32)
  xd = rng.randn(2, 1, MESH2D[0] + 1, MESH2D[1]).astype(np.float32)
  xd[:, :, -SHARD_NAN_ROWS:] = np.nan
  prevd = xd + 0.1 * rng.randn(*xd.shape).astype(np.float32)
  x3 = rng.randn(3, *MESH3D).astype(np.float32)
  return dict(x2=x2, xd=xd, prevd=prevd, x3=x3)


def shard_starts() -> np.ndarray:
  """`sharded_flow_step`'s patch starts: a block of SHARD_STEP_STARTS
  nodes of the p = 160, s = 40 grid in the middle of the pair."""
  side = int(np.sqrt(SHARD_STEP_STARTS))
  g = N // 2 + STRIDE * np.arange(side)
  yy, xx = np.meshgrid(g, g, indexing='ij')
  return np.stack([yy.ravel(), xx.ravel()], -1).astype(np.int64)


def path_j_rank(workdir: str, cases) -> dict:
  """One rank of a path (j) job, in a child process that
  sofima_tpu_torch.parallel.launch started, the default group joined
  through `distributed.initialize` (none for one rank): runs `cases` on the pair and the stack the smoke run saved in
  `workdir`, each behind a barrier, timed and with its launches counted
  on its own. Returns, per case, the wall, the launches, a digest of the
  result and (rank 0) the result."""
  import hashlib
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.parallel import distributed as pdist
  from sofima_tpu_torch.parallel import mesh_sharding as ms
  from sofima_tpu_torch.processor import flow as flow_proc
  from sofima_tpu_torch.processor import runner
  from sofima_tpu_torch.processor.defaults import em_2d
  from sofima_tpu_torch.utils.volume import InMemoryVolume

  _build.library()
  dev = torch.device('cuda', torch.cuda.current_device())
  world, rank = pdist.process_count(), pdist.process_index()
  cfg2, cfg_drift, cfg3 = shard_configs()
  meshes = shard_meshes()
  pair = np.load(os.path.join(workdir, 'pair.npy'))

  def on_card(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev, torch.float32)

  pre, post = on_card(pair[0]), on_card(pair[1])
  x2, x3 = on_card(meshes['x2']), on_card(meshes['x3'])
  xd, prevd = on_card(meshes['xd']), on_card(meshes['prevd'])

  def solve(x, prev, cfg, grid, dim):
    dmesh = ms.make_mesh_2d(1, world) if grid else ms.make_mesh(world)
    return lambda: ms.relax_mesh_sharded(
        x, torch.zeros_like(x) if prev is None else prev, cfg, dmesh,
        dim=dim)

  def flow(rows, masked):
    kw = {}
    if masked:
      mask = bench_mask(N, dev)
      kw = dict(pre_mask=mask, post_mask=mask)
    return lambda: ms.dense_flow_field_sharded(
        ms.make_mesh(world), pre[:rows], post[:rows], (160, 160),
        (STRIDE, STRIDE), circular=True, **kw)

  def flow_step():
    run = ms.sharded_flow_step(ms.make_mesh(world))
    starts = torch.from_numpy(shard_starts()).to(dev)
    return lambda: run(pre, post, starts, (160, 160))

  def distributed_runner():
    stack = np.load(os.path.join(workdir, 'proc_stack.npy'))
    image_vol = InMemoryVolume(stack[None], fill_value=0.0)
    proc = flow_proc.EstimateFlow(em_2d.estimate_flow_config(), device=dev)
    size, channels = runner.output_geometry(proc, image_vol.meta)
    writes = []

    class Recording(InMemoryVolume):

      def write(self, data, box):
        writes.append((tuple(box.start), tuple(box.size), data.copy()))
        super().write(data, box)

    out = Recording(np.full((channels,) + size[::-1], np.nan, np.float32))

    def run():
      pdist.process_volume_distributed(proc, image_vol, output_volume=out)
      return writes
    return run

  make = dict(
      solve2d_y=lambda: solve(x2, None, cfg2, False, 2),
      solve2d_grid=lambda: solve(x2, None, cfg2, True, 2),
      solve2d_pad_drift=lambda: solve(xd, prevd, cfg_drift, False, 2),
      solve3d_y=lambda: solve(x3, None, cfg3, False, 3),
      solve3d_grid=lambda: solve(x3, None, cfg3, True, 3),
      flow_circular=lambda: flow(N, False),
      flow_masked=lambda: flow(N, True),
      flow_cut=lambda: flow(SHARD_FLOW_ROWS, False),
      flow_step=flow_step, runner=distributed_runner)
  out = {}
  for name in cases:
    fn = make[name]()
    pdist.barrier()
    sync()
    before = dict(_build.launch_counts)
    t0 = time.perf_counter()
    res = fn()
    sync()
    wall = time.perf_counter() - t0
    row = dict(wall_s=wall, launches={
        k: v - before[k] for k, v in _build.launch_counts.items()
        if v != before[k]})
    if isinstance(res, tuple):  # a solve: (x, e_kin history, steps)
      row.update(steps=res[2], e_kin=float(res[1][-1]))
      res = res[0]
    if isinstance(res, torch.Tensor):
      res = res.cpu().numpy()
      row['digest'] = hashlib.sha1(res.tobytes()).hexdigest()
    if rank == 0 or name == 'runner':
      row['value'] = res
    out[name] = row
  return dict(rank=rank, world=world, cases=out)


def sharded_slice(dev, report, pair, proc_stack, flow_1x) -> dict:
  """Path (j): the sharded solves, the sharded flow and the multi-process
  runner, as jobs of child processes (one rank, then two gloo ranks
  sharing the card), held against the one-rank solvers and flow in this
  process, and path (h)'s one-process EstimateFlow (`flow_1x`).

  `pair` is the stack path's first section pair (uint8), `proc_stack`
  path (h)'s stack. Returns the kernels' launch counts, summed over
  every rank of both jobs."""
  import tempfile
  from sofima_tpu_torch import flow_field
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.parallel import launch
  from sofima_tpu_torch.utils.bounding_box import BoundingBox
  from sofima_tpu_torch.utils.volume import InMemoryVolume

  t_phase = time.perf_counter()
  print(f'path (j): relax_mesh_sharded (2d {list(MESH2D)}, 1000 steps; 3d '
        f'{list(MESH3D)}, 200 steps), dense_flow_field_sharded and '
        f'sharded_flow_step on the stack path\'s first {N}^2 pair, '
        f'process_volume_distributed on path (h)\'s stack; 1 rank (no '
        f'process group), then 2 gloo ranks sharing the card')
  target = f'{os.path.abspath(__file__)}:path_j_rank'
  jobs, job_walls = {}, {}
  with tempfile.TemporaryDirectory(prefix='path_j') as workdir:
    np.save(os.path.join(workdir, 'pair.npy'), pair)
    np.save(os.path.join(workdir, 'proc_stack.npy'), proc_stack)
    for world, backend, cases in ((1, 'nccl', SHARD_ONE_RANK),
                                  (2, 'gloo', SHARD_TWO_RANKS)):
      t0 = time.perf_counter()
      jobs[world] = launch.run(target, world, backend, args=(workdir, cases),
                               workdir=workdir, timeout=SHARD_TIMEOUT)
      job_walls[world] = time.perf_counter() - t0
      print(f'  {world} rank(s), {backend if world > 1 else "no group"}: '
            f'job wall {job_walls[world]:.1f} s '
            f'(start-up and input loading included)')
      for name in cases:
        walls = [r['cases'][name]['wall_s'] for r in jobs[world]]
        steps = jobs[world][0]['cases'][name].get('steps')
        print(f'    {name}: wall {max(walls):.3f} s'
              + ('' if steps is None else f', {steps} steps, final e_kin '
                 f'{jobs[world][0]["cases"][name]["e_kin"]:.6g}')
              + f', launches {jobs[world][0]["cases"][name]["launches"]}')
        digests = {r['cases'][name].get('digest') for r in jobs[world]}
        check(len(digests) == 1,
              f'path (j) {name}: the ranks returned different results')

  # The one-rank references, in this process.
  cfg2, cfg_drift, cfg3 = shard_configs()
  meshes = {k: torch.from_numpy(v).to(dev) for k, v in shard_meshes().items()}
  one, one_walls = {}, {}

  def reference(name, fn):
    sync()
    t0 = time.perf_counter()
    one[name] = fn()
    sync()
    one_walls[name] = time.perf_counter() - t0

  x2, x3 = meshes['x2'], meshes['x3']
  reference('solve2d', lambda: mesh.relax_mesh_fused(x2, torch.zeros_like(x2),
                                                     cfg2))
  reference('solve2d_pad_drift', lambda: mesh.relax_mesh_fused(
      meshes['xd'], meshes['prevd'], cfg_drift))
  reference('solve3d', lambda: mesh.relax_mesh_fused(
      x3, torch.zeros_like(x3), cfg3, mesh_force=mesh.elastic_mesh_3d))
  pre = torch.from_numpy(pair[0]).to(dev, torch.float32)
  post = torch.from_numpy(pair[1]).to(dev, torch.float32)
  mask = bench_mask(N, dev)
  flow = lambda rows, **kw: flow_field.dense_flow_field(
      pre[:rows], post[:rows], (160, 160), (STRIDE, STRIDE), circular=True,
      **kw)
  reference('flow_circular', lambda: flow(N))
  reference('flow_masked', lambda: flow(N, pre_mask=mask, post_mask=mask))
  reference('flow_cut', lambda: flow(SHARD_FLOW_ROWS))
  reference('flow_step', lambda: flow_field.batched_xcorr_peaks(
      pre, post, None, None, (160, 160),
      torch.from_numpy(shard_starts()).to(dev), mean=None))
  print('  one rank in this process: ' + ', '.join(
      f'{k} {v:.3f} s' for k, v in one_walls.items()))

  # Which kernel each case must launch, by launch counter.
  needs = dict(solve2d='force2d', solve3d='force3d',
               flow_circular='dense_flow_peaks', flow_cut='dense_flow_peaks',
               flow_masked='masked_flow', runner='dense_flow_peaks')
  errs, launches = {}, {}
  for world, ranks in jobs.items():
    for r in ranks:
      for row in r['cases'].values():
        for k, v in row['launches'].items():
          launches[k] = launches.get(k, 0) + v
    for name, row in ranks[0]['cases'].items():
      label = f'path (j) {name}, {world} rank(s)'
      need = next((v for k, v in needs.items() if name.startswith(k)), None)
      if need == 'masked_flow':
        n = sum(row['launches'].get(k, 0)
                for k in ('masked_flow_peaks', 'masked_flow_pure'))
      else:
        n = row['launches'].get(need, 1 if need is None else 0)
      check(n > 0, f'{label}: kernel {need} was not launched')
      if name.startswith('solve'):
        ref_name = 'solve2d_pad_drift' if 'drift' in name else name[:7]
        ref_x, _, ref_steps = one[ref_name]
        ref_x = ref_x.cpu().numpy()
        val = row['value']
        nan_same = bool((np.isnan(val) == np.isnan(ref_x)).all())
        err = float(np.nanmax(np.abs(val - ref_x)))
        print(f'  {label}: max |dx| {err:.3g} px against relax_mesh_fused '
              f'(bar {MESH_TOL}), {row["steps"]} steps against {ref_steps}, '
              f'NaN pattern equal: {nan_same}; wall {row["wall_s"]:.3f} s '
              f'against {one_walls[ref_name]:.3f} s on one rank')
        check(row['steps'] == ref_steps, f'{label}: steps differ')
        check(nan_same, f'{label}: NaN pattern differs')
        check(err < MESH_TOL, f'{label}: {err} px from relax_mesh_fused')
        errs[f'{name}_{world}'] = err
        continue
      if name == 'runner':
        # Every rank's writes replayed in the work boxes' global order
        # (the round robin of partition_work) rebuild the one-process
        # output.
        merged = InMemoryVolume(np.full(flow_1x.shape, np.nan, np.float32))
        writes = [r['cases'][name]['value'] for r in ranks]
        for k in range(max(len(w) for w in writes)):
          for w in writes:
            if k < len(w):
              start, size, data = w[k]
              merged.write(data, BoundingBox(start=start, size=size))
        print(f'  {label}: {[len(w) for w in writes]} work boxes by rank')
        val = torch.from_numpy(merged.data)
        ref = torch.from_numpy(np.ascontiguousarray(flow_1x))
        val, ref = (t.reshape(t.shape[0], -1, t.shape[-1]).to(dev)
                    for t in (val, ref))
      else:
        val = torch.from_numpy(row['value']).to(dev)
        ref = one[name]
        if name == 'flow_step':
          val, ref = val.T.contiguous(), ref.T.contiguous()
      against = 'path (h)' if name == 'runner' else 'one rank'
      errs[f'{name}_{world}'] = compare_flow(
          val, ref, f'{label} against {against}')['err']
  report['path_j'] = dict(
      job_walls_s=job_walls, one_rank_walls_s=one_walls, max_abs_err=errs,
      case_walls_s={f'{name}_{world}': max(r['cases'][name]['wall_s']
                                           for r in ranks)
                    for world, ranks in jobs.items()
                    for name in ranks[0]['cases']},
      launches=launches)
  print(f'  launches summed over the ranks: {launches}')
  print(f'  phase {time.perf_counter() - t_phase:.1f} s')
  return launches


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from sofima_tpu_torch.ops import _build

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = smi()
  print(card)
  print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
        f'cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}')
  t_start = time.perf_counter()
  _build.library()
  print(f'kernel build + load: {_build.build_seconds:.2f} s')
  print(_build.build_log.strip())
  for kernel in ('force3d_kernel', 'grid_fire_kernel'):
    for row in compiler_report(_build.build_log, kernel):
      print(f'compiler report: {row}')
  report = {}
  launches, stack = stack_slice(dev, report, _build)
  pair = stack[:2].cpu().numpy()  # path (j)'s sharded flow
  torch.cuda.empty_cache()
  masked = masked_warm_slice(dev, report, _build, stack)
  # K5's launches: both of its kernels, each route's count beside them.
  launches['masked_flow_peaks'] = (masked['masked_flow_peaks']
                                   + masked['masked_flow_pure'])
  report['K5']['launches_dense'] = masked['masked_flow_peaks']
  report['K5']['launches_pure'] = masked['masked_flow_pure']
  del stack
  torch.cuda.empty_cache()
  launches.update(stitch_slice(dev, report, _build))
  torch.cuda.empty_cache()
  launches['force2d'] = montage_slice(dev, report, _build)
  torch.cuda.empty_cache()
  launches.update(library_slice(dev, report, _build))
  torch.cuda.empty_cache()
  stitch_api_slice(dev, report, _build)
  torch.cuda.empty_cache()
  per_axis_phase(dev)
  torch.cuda.empty_cache()
  path_h = {}
  processor_slice(dev, report, _build, path_h)
  torch.cuda.empty_cache()
  decorator_slice(dev, report, _build)
  torch.cuda.empty_cache()
  launches_j = sharded_slice(dev, report, pair, path_h['stack'],
                             path_h['flow_1x'])
  del pair, path_h
  # Path (j)'s launches, summed over its ranks, stand beside their
  # kernels' rows (K5's both routes under its row); `launches` stays this
  # process's own count.
  for key, names in (('K1', ('dense_flow_peaks',)),
                     ('K5', ('masked_flow_peaks', 'masked_flow_pure')),
                     ('K8', ('force2d',)), ('K9', ('force3d',))):
    report[key]['launches_path_j'] = sum(launches_j.get(k, 0)
                                         for k in names)
  print(f'total {time.perf_counter() - t_start:.1f} s')

  kernels = []
  meta = [
      ('K1', 'dense_flow_peaks', 'sofima_tpu_torch/csrc/flow_peaks.cu',
       'sofima_tpu/ops/pallas_flow.py:732'),
      ('K2', 'targeted_flow_peaks', 'sofima_tpu_torch/csrc/flow_peaks.cu',
       'sofima_tpu/ops/pallas_flow.py:797'),
      ('K5', 'masked_flow_peaks', 'sofima_tpu_torch/csrc/masked_flow.cu',
       'sofima_tpu/ops/pallas_flow.py:876'),
      ('K3', 'fused_fire', 'sofima_tpu_torch/csrc/fire.cu',
       'sofima_tpu/ops/pallas_mesh.py:852'),
      ('K4', 'warp_gather', 'sofima_tpu_torch/csrc/warp.cu',
       'sofima_tpu/ops/pallas_warp.py:206'),
      ('K8', 'force2d', 'sofima_tpu_torch/csrc/force2d.cu',
       'sofima_tpu/ops/pallas_mesh.py:85'),
      ('K9', 'force3d', 'sofima_tpu_torch/csrc/force3d.cu',
       'sofima_tpu/ops/pallas_mesh.py:259'),
      ('K11', 'fused_fire_3d', 'sofima_tpu_torch/csrc/fire.cu',
       'sofima_tpu/ops/pallas_mesh.py:1215'),
      ('K13', 'warp_gather_3d', 'sofima_tpu_torch/csrc/warp3d.cu',
       'sofima_tpu/ops/pallas_warp.py:692'),
      ('K6', 'patch_flow_peaks', 'sofima_tpu_torch/csrc/patch_corr.cu',
       'sofima_tpu/ops/pallas_flow.py:202'),
      ('K7', 'corr_patches', 'sofima_tpu_torch/csrc/corr_fft.cu',
       'sofima_tpu/ops/pallas_flow.py:75'),
      ('K12', 'ndimage_warp', 'sofima_tpu_torch/csrc/warp.cu',
       'sofima_tpu/ops/pallas_warp.py:60'),
      ('K4p', 'warp_subvolume', 'sofima_tpu_torch/csrc/warp.cu',
       'sofima_tpu/ops/pallas_warp.py:440'),
      ('INV', 'invert_section', 'sofima_tpu_torch/csrc/invert.cu',
       'sofima_tpu/map_utils.py _invert_section, sofima_tpu/ops/fill.py '
       'fill_invalid (XLA; no Pallas kernel)'),
  ]
  main_keys = ('err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
  for key, name, src, rep in meta:
    r = report[key]
    # For K1/K2/K5, max_abs_err is the integer x/y peaks; the sharpness
    # and ratio agreement follows as stat_frac / stat_max_rel /
    # stat_max_abs.
    extra = {k: v for k, v in r.items() if k not in main_keys}
    kernels.append(dict(name=name, route='cuda', source=src, replaces=rep,
                        launches=launches[name], max_abs_err=r['err'],
                        ms=r['ms'], plain_ms=r['plain_ms'],
                        bound_ms=r['bound_ms'], bound_by=r['bound_by'],
                        library_ms=r['library_ms'], **extra))
  paths = {k: report[k] for k in ('stack_cold', 'path_masked', 'stack_warm',
                                   'refresh', 'path_a', 'path_b', 'path_c',
                                   'path_d', 'path_e', 'montage_small',
                                   'drift_removal', 'path_f', 'path_g',
                                   'padfield3d', 'path_h',
                                   'render3d_processor', 'path_i',
                                   'path_j')}
  print(json.dumps({'paths': paths}))
  print(smi())
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
