"""Where the time goes in sofima_tpu_torch's paths.

Run from the repository root on a machine with one CUDA card:

    python3 profile_stack.py              # stack alignment
    python3 profile_stack.py --warm       # the same, warm_start=True
    python3 profile_stack.py --masked     # masked coarse-to-fine flow
    python3 profile_stack.py --stitch3d   # 3d tile stitching
    python3 profile_stack.py --montage    # 2d tile montage

Stack alignment: chip_smoke.py's synthetic 10k^2 stack through
`align_stack_pipelined` at bench.py's headline configuration (cold, or
with `warm_start`). Masked flow: `coarse_to_fine_flow` on the stack's
first pair with bench.py's `flow_masked` mask, as chip_smoke.py runs it.
3d
stitching: chip_smoke.py's LICONN input (bench.py's geometry) through
`stitch_and_render_3d`, plus one `mesh.relax_mesh` of its joint solve on
its own, under the profiler, to count the device launches per solver
step. 2d montage: chip_smoke.py's input (bench.py's montage2d geometry)
through `montage_align_2d`, and one 100-step chunk of each of its two
solves (tile placement, joint solve) under the profiler. Each
mode runs once to warm up, then RUNS timed calls (wall and
per-phase seconds, the device synchronized at each phase end), then one
call under torch.profiler. It prints the device time summed over all
kernels of the profiled call, the device's busy share (that sum over
the mean wall of the timed calls; the path runs on one stream, so
kernels do not overlap), the device time of each hand-written kernel
and of everything else (with its largest device ops), and the peak
device memory. The profiler's full
table goes to OUT.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# The hand-written kernels by their CUDA function names (csrc/*.cu); K1
# and K2 are `flow_fft_kernel` (FFT route) or `flow_peaks_kernel` (dense
# route).
KERNELS = ('flow_fft_kernel', 'flow_peaks_kernel', 'fused_fire_kernel',
           'warp_gather_kernel')
KERNELS_MASKED = ('masked_pure_kernel', 'masked_flow_kernel',
                  'warp_gather_kernel')
KERNELS_3D = ('force3d_kernel', 'warp3d_kernel')
KERNELS_MONTAGE = ('flow_fft_kernel', 'flow_peaks_kernel', 'force2d_kernel',
                   'warp_gather_kernel')
SECTIONS = 4    # as chip_smoke.py's main path
RUNS = 3
TOP_OPS = 8     # other device ops listed by time
OUT = os.path.join('build', 'profile_stack.txt')  # git-ignored
OUT_3D = os.path.join('build', 'profile_stitch3d.txt')
OUT_MASKED = os.path.join('build', 'profile_masked.txt')
OUT_MONTAGE = os.path.join('build', 'profile_montage.txt')


def _device_us(evt) -> float:
  t = getattr(evt, 'self_device_time_total', None)
  return float(evt.self_cuda_time_total if t is None else t)


def main(warm: bool = False) -> int:
  import dataclasses
  import chip_smoke
  from sofima_tpu_torch.pipeline import stack_align

  dev = torch.device('cuda', 0)
  n = chip_smoke.N
  stack = chip_smoke.make_stack(chip_smoke.texture(n, dev), SECTIONS)
  cfg = dataclasses.replace(chip_smoke.headline_config(), warm_start=warm)
  pixels = (SECTIONS - 1) * n * n
  run = lambda **kw: stack_align.align_stack_pipelined(
      stack, cfg, out_dtype=torch.uint8, **kw)
  run()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  walls = []
  for i in range(RUNS):
    timings = {}
    t0 = time.perf_counter()
    run(timings=timings)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    print(f'run {i + 1}: wall {walls[-1]:.3f} s, '
          f'{pixels / walls[-1] / 1e6:.1f} Mpix/s; phases '
          + ', '.join(f'{k} {v:.3f}' for k, v in timings.items()))
  peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
  summarize(run, walls, KERNELS, OUT)
  print(f'peak device memory {peak_gb:.2f} GB')
  return 0


def masked_main() -> int:
  """chip_smoke.py's masked coarse-to-fine run on the stack's first pair."""
  import chip_smoke
  from sofima_tpu_torch import flow_field

  dev = torch.device('cuda', 0)
  n = chip_smoke.N
  stack = chip_smoke.make_stack(chip_smoke.texture(n, dev), 2)
  pre, post = stack[0].float(), stack[1].float()
  del stack
  mask = chip_smoke.bench_mask(n, dev)
  run = lambda: flow_field.coarse_to_fine_flow(
      pre, post, pre_mask=mask, post_mask=mask, max_displacement=128,
      residual=16)
  run()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  walls = []
  for i in range(RUNS):
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    print(f'run {i + 1}: wall {walls[-1]:.3f} s, '
          f'{n * n / walls[-1] / 1e6:.1f} Mpix/s')
  peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
  summarize(run, walls, KERNELS_MASKED, OUT_MASKED)
  print(f'peak device memory {peak_gb:.2f} GB')
  return 0


def device_events(fn):
  """(profiler, device events, wall s) of one call of `fn`."""
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  events = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
  if not events:
    raise RuntimeError('the profiler recorded no device events')
  return prof, events, wall


def summarize(fn, walls, kernels, out):
  """Profiles one call of `fn` and prints the device-time breakdown."""
  prof, events, prof_wall = device_events(fn)
  total_ms = sum(_device_us(e) for e in events) / 1e3
  mean_wall = sum(walls) / len(walls)
  print(f'profiled call: wall {prof_wall:.3f} s (with the profiler on); '
        f'device time {total_ms:.1f} ms over {sum(e.count for e in events)} '
        f'device events')
  print(f'busy share {total_ms / 1e3 / mean_wall:.3f} of the timed calls\' '
        f'mean wall {mean_wall:.3f} s')
  rest = total_ms
  for name in kernels:
    hits = [e for e in events if name in e.key]
    ms = sum(_device_us(e) for e in hits) / 1e3
    rest -= ms
    print(f'  {name}: {ms:.1f} ms in {sum(e.count for e in hits)} launches')
  print(f'  everything else: {rest:.1f} ms; its largest device ops:')
  others = [e for e in events if not any(name in e.key for name in kernels)]
  for e in sorted(others, key=_device_us, reverse=True)[:TOP_OPS]:
    print(f'    {_device_us(e) / 1e3:.1f} ms in {e.count} launches: '
          f'{e.key[:90]}')
  os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
  with open(out, 'w') as f:
    f.write(prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=60))
  print(f'profiler table: {out}')


def stitch3d_main() -> int:
  """Path (a) of chip_smoke.py: phases, device time, launches per step."""
  import numpy as np
  import chip_smoke
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch import stitch_elastic
  from sofima_tpu_torch.pipeline import stitch3d

  dev = torch.device('cuda', 0)
  zdim, tile_yx, overlap = chip_smoke.LICONN
  n3 = 2 * tile_yx - overlap
  vol = chip_smoke.texture3d((zdim, n3, n3), 9, dev)
  tiles, cx, cy, coarse = chip_smoke.liconn_inputs(vol, tile_yx, overlap)
  del vol
  cfg = stitch3d.Stitch3dConfig(
      stride=(16, 16, 16), patch_size=(32, 32, 32), flow_batch=64, margin=8,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(16, 16, 16),
          num_iters=400, max_iters=10000, stop_v_max=0.005, dt_max=100.0))
  run = lambda: stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg)
  run()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  walls = []
  voxels = zdim * n3 * n3
  for i in range(RUNS):
    timings = {}
    t0 = time.perf_counter()
    out = stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg,
                                        timings=timings)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    print(f'run {i + 1}: wall {walls[-1]:.3f} s, '
          f'{voxels / walls[-1] / 1e6:.1f} Mvox/s, solve steps '
          f'{out["solve_steps"]}; phases '
          + ', '.join(f'{k} {v:.3f}' for k, v in timings.items()))
  peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
  summarize(run, walls, KERNELS_3D, OUT_3D)
  print(f'peak device memory {peak_gb:.2f} GB')

  # The joint solve alone, set up as stitch_and_render_3d sets it up.
  views = {k: stitch3d._TileView(t) for k, t in tiles.items()}
  flows = [stitch_elastic.compute_flow_map3d(
      views, tile_shape=(tile_yx, tile_yx, zdim), offset_map=off, axis=ax,
      patch_size=cfg.patch_size, stride=cfg.stride) for ax, off in
           ((0, cx), (1, cy))]
  fx, fy, x0, nbors, _ = stitch_elastic.aggregate_arrays(
      (cx[:, 0], *flows[0]), (cy[:, 0], *flows[1]), list(tiles),
      np.asarray(coarse)[:, 0], cfg.stride, (zdim, tile_yx, tile_yx))
  x0 = torch.from_numpy(x0).to(dev)
  plan = stitch_elastic.TargetMeshPlan(nbors, fx, fy, cfg.stride,
                                       x0.shape[-3:])
  steps = []
  _, events, wall = device_events(lambda: steps.append(mesh.relax_mesh(
      x0, None, cfg.mesh_cfg, prev_fn=plan,
      mesh_force=mesh.elastic_mesh_3d)[2]))
  launches = sum(e.count for e in events)
  busy_ms = sum(_device_us(e) for e in events) / 1e3
  print(f'solve alone: {steps[0]} steps, {launches} device launches '
        f'({launches / steps[0]:.1f} per step), device time {busy_ms:.1f} ms '
        f'in a profiled wall of {wall:.3f} s')
  return 0


def montage_main() -> int:
  """Path (e) of chip_smoke.py: stages, device time, launches per step."""
  import dataclasses
  import chip_smoke
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch import stitch_elastic
  from sofima_tpu_torch import stitch_rigid
  from sofima_tpu_torch.pipeline import montage

  dev = torch.device('cuda', 0)
  grid = chip_smoke.MONTAGE[0]
  img, tiles, cfg = chip_smoke.montage_inputs(dev)
  pixels = img.numel()
  del img
  run = lambda **kw: montage.montage_align_2d(tiles, (grid, grid), cfg, **kw)
  run()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  walls = []
  for i in range(RUNS):
    timings = {}
    t0 = time.perf_counter()
    out = run(timings=timings)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    print(f'run {i + 1}: wall {walls[-1]:.3f} s, '
          f'{pixels / walls[-1] / 1e6:.2f} Mpix/s, solve steps '
          f'{out["solve_steps"]}; stages '
          + ', '.join(f'{k} {v:.3f}' for k, v in timings.items()))
  peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
  summarize(run, walls, KERNELS_MONTAGE, OUT_MONTAGE)
  print(f'peak device memory {peak_gb:.2f} GB')

  # Device launches per step of the two solves, each run for one
  # 100-step chunk under the profiler (a whole solve records hundreds of
  # thousands of events, too many to reduce in reasonable time).
  cx, cy, coarse = out['cx'], out['cy'], out['coarse']
  cx_t, cy_t = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in (cx, cy))
  place_cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.0, k=0.1, stride=(1, 1), num_iters=100,
      max_iters=100, stop_v_max=0.001, dt_max=100)
  solve_counted(lambda: mesh.relax_mesh(
      torch.zeros_like(cx_t), None, place_cfg,
      mesh_force=lambda x, *a: stitch_rigid.elastic_tile_mesh(x, cx_t, cy_t)),
                'placement solve')
  stride = (cfg.stride, cfg.stride)
  patch = (cfg.patch_size, cfg.patch_size)
  flows = [stitch_elastic.compute_flow_map(
      tiles, off[:, 0], axis=ax, patch_size=patch, stride=stride,
      flow_mode=cfg.flow_mode) for ax, off in ((0, cx), (1, cy))]
  fx, fy, x0, nbors, _ = stitch_elastic.aggregate_arrays(
      (cx[:, 0], *flows[0]), (cy[:, 0], *flows[1]), list(tiles),
      coarse[:, 0], stride, next(iter(tiles.values())).shape)
  x0 = torch.from_numpy(x0).to(dev)
  plan = stitch_elastic.TargetMeshPlan(nbors, fx, fy, stride, x0.shape[-2:])
  solve_cfg = dataclasses.replace(cfg.mesh_cfg, num_iters=100, max_iters=100)
  solve_counted(lambda: mesh.relax_mesh(x0, None, solve_cfg, prev_fn=plan),
                'joint solve')
  return 0


def solve_counted(run, name):
  """Device launches and time per step of one `relax_mesh` chunk."""
  steps = []
  _, events, wall = device_events(lambda: steps.append(run()[2]))
  launches = sum(e.count for e in events)
  busy_ms = sum(_device_us(e) for e in events) / 1e3
  print(f'{name}, {steps[0]} steps: {launches} device launches '
        f'({launches / steps[0]:.1f} per step), device time {busy_ms:.1f} ms '
        f'in a profiled wall of {wall:.3f} s')


def setup() -> bool:
  """Checks for the card, prints its name and power limit, builds."""
  if not torch.cuda.is_available():
    print('profile_stack: CUDA is not available', file=sys.stderr)
    return False
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from sofima_tpu_torch.ops import _build
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  _build.library()
  return True


if __name__ == '__main__':
  if not setup():
    sys.exit(2)
  args = sys.argv[1:]
  if '--stitch3d' in args:
    sys.exit(stitch3d_main())
  if '--montage' in args:
    sys.exit(montage_main())
  sys.exit(masked_main() if '--masked' in args else main('--warm' in args))
