"""Where the time goes in sofima_tpu_torch's stack-alignment path.

Run from the repository root on a machine with one CUDA card:

    python3 profile_stack.py

It builds chip_smoke.py's synthetic 10k^2 stack and runs
`align_stack_pipelined` at bench.py's headline configuration: once to
warm up, then RUNS timed calls (wall and per-phase seconds, the device
synchronized at each phase end), then one call under torch.profiler. It
prints the device time summed over all kernels of the profiled call, the
device's busy share (that sum over the mean wall of the timed calls; the
path runs on one stream, so kernels do not overlap), the device time of
each hand-written kernel and of everything else, and the peak device
memory. The profiler's full table goes to OUT.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# The hand-written kernels by their CUDA function names (csrc/*.cu).
KERNELS = ('flow_peaks_kernel', 'fused_fire_kernel', 'warp_gather_kernel')
SECTIONS = 4    # as chip_smoke.py's main path
RUNS = 3
OUT = os.path.join('build', 'profile_stack.txt')  # git-ignored


def _device_us(evt) -> float:
  t = getattr(evt, 'self_device_time_total', None)
  return float(evt.self_cuda_time_total if t is None else t)


def main() -> int:
  if not torch.cuda.is_available():
    print('profile_stack: CUDA is not available', file=sys.stderr)
    return 2
  root = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, root)
  import chip_smoke
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.pipeline import stack_align

  dev = torch.device('cuda', 0)
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip())
  _build.library()
  n = chip_smoke.N
  stack = chip_smoke.make_stack(chip_smoke.texture(n, dev), SECTIONS)
  cfg = chip_smoke.headline_config()
  pixels = (SECTIONS - 1) * n * n

  stack_align.align_stack_pipelined(stack, cfg, out_dtype=torch.uint8)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats(dev)
  walls = []
  for i in range(RUNS):
    timings = {}
    t0 = time.perf_counter()
    stack_align.align_stack_pipelined(stack, cfg, out_dtype=torch.uint8,
                                      timings=timings)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    print(f'run {i + 1}: wall {walls[-1]:.3f} s, '
          f'{pixels / walls[-1] / 1e6:.1f} Mpix/s; phases '
          + ', '.join(f'{k} {v:.3f}' for k, v in timings.items()))
  peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    t0 = time.perf_counter()
    stack_align.align_stack_pipelined(stack, cfg, out_dtype=torch.uint8)
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
  events = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
  if not events:
    raise RuntimeError('the profiler recorded no device events')
  total_ms = sum(_device_us(e) for e in events) / 1e3
  mean_wall = sum(walls) / len(walls)
  print(f'profiled call: wall {prof_wall:.3f} s (with the profiler on); '
        f'device time {total_ms:.1f} ms over {sum(e.count for e in events)} '
        f'device events')
  print(f'busy share {total_ms / 1e3 / mean_wall:.3f} of the timed calls\' '
        f'mean wall {mean_wall:.3f} s')
  rest = total_ms
  for name in KERNELS:
    hits = [e for e in events if name in e.key]
    ms = sum(_device_us(e) for e in hits) / 1e3
    rest -= ms
    print(f'  {name}: {ms:.1f} ms in {sum(e.count for e in hits)} launches')
  print(f'  everything else: {rest:.1f} ms')
  print(f'peak device memory {peak_gb:.2f} GB')
  os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
  with open(OUT, 'w') as f:
    f.write(prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=60))
  print(f'profiler table: {OUT}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
