"""One run of one cell: set-up, warm-up, the measured window, the
metrics, the correctness check. Everything particular to a cell is
found by name (spec.py): the driver runs the program, the inputs module
makes what it is handed, the check module compares what the window
produced with the plain reference, and each metric has a reader.

A driver module has `prepare(device)` (the program's build), `spans()`
(a context manager that labels the traced window's layers) and a
`Driver(cfg, mix, inputs, seed, device)` with `warm_up()`,
`layer_walls()` (the program's own phase clock, run untraced before a
traced window, or None) and `window(seconds) -> Window`.

A traced run's window lasts the traffic mix's `trace_seconds` where it
sets one and that is shorter than `--seconds`: the profiler's trace of a
host-paced window holds some 30 000 device operations a second, and
stopping and reading it takes about twice the window's length.
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import torch

from port_bench.harness import spec as spec_lib
from port_bench.harness import trace as trace_lib
from port_bench.harness.window import Window


@dataclasses.dataclass
class Context:
  """What a metric's reader reads."""
  cfg: dict
  mix: dict
  n: int
  sections: int = 0                 # moving sections the window finished
  setup_s: float = 0.0
  window: Window | None = None
  timings: dict = dataclasses.field(default_factory=dict)  # phase -> s
  timing_sections: int = 0          # sections the phase clock covered
  trace: trace_lib.Trace | None = None

  def kernel_count(self, names) -> int:
    return sum(1 for k in self.trace.kernels
               if trace_lib.short_name(k.name) in names)

  def kernel_seconds(self, names) -> float:
    return sum(k.seconds for k in self.trace.kernels
               if trace_lib.short_name(k.name) in names)


def log(msg: str) -> None:
  print(f'port_bench: {msg}', file=sys.stderr, flush=True)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
  """(correct, {name: {'value', 'limit'}}): each value at most its limit
  (NaN fails); every limit needs its value."""
  table = {k: {'value': values[k], 'limit': limits[k]} for k in limits}
  ok = all(v['value'] <= v['limit'] for v in table.values())
  return ok, table


def _read(readers, ctx) -> dict:
  out = {}
  for m, reader in readers:
    value = reader.read(ctx)
    if value is not None:
      out[m['name']] = {'value': value, 'unit': m['unit']}
  return out


def run(cell: spec_lib.Cell, seed: int, seconds: float, traced: bool,
        device, t_start: float, control: bool = False) -> dict:
  """One run -> the result line's dict (its `checks` last). `t_start`:
  the process's start on the perf_counter clock."""
  driver_lib = spec_lib.driver(cell)
  device = torch.device(device)
  t = time.perf_counter()
  log(f'run starts {t - t_start:.3f} s after the process')
  if device.type == 'cuda':
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    log(f'cuda up {time.perf_counter() - t:.3f} s')
  t = time.perf_counter()
  driver_lib.prepare(device)
  log(f'program prepared {time.perf_counter() - t:.3f} s')
  cfg, mix = cell.config, cell.traffic
  t = time.perf_counter()
  inputs = spec_lib.inputs(cell).make(mix, cfg, seed, device)
  if device.type == 'cuda':
    torch.cuda.synchronize(device)
  log(f'inputs made {time.perf_counter() - t:.3f} s')
  driver = driver_lib.Driver(cfg, mix, inputs, seed, device)
  t = time.perf_counter()
  driver.warm_up()
  log(f'warm-up {time.perf_counter() - t:.3f} s')
  ctx = Context(cfg, mix, int(cfg['section_px']))
  if traced:
    walls = driver.layer_walls()
    if walls is not None:
      ctx.timings, ctx.timing_sections = walls
  gc.collect()  # the window starts from a collected heap, and later
  gc.freeze()   # collections skip what set-up left
  prof = None
  if traced:
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
  if device.type == 'cuda':
    torch.cuda.synchronize(device)
  ctx.setup_s = time.perf_counter() - t_start
  if traced:
    seconds = min(seconds, mix.get('trace_seconds', seconds))
    with driver_lib.spans(), torch.profiler.record_function(trace_lib.WINDOW):
      win = driver.window(seconds)
    t = time.perf_counter()
    prof.stop()
    log(f'profiler stopped {time.perf_counter() - t:.3f} s')
  else:
    win = driver.window(seconds)
  gc.unfreeze()
  peak = (torch.cuda.max_memory_allocated(device)
          if device.type == 'cuda' else 0)
  ctx.window, ctx.sections = win, win.sections
  steps = win.latencies or win.call_seconds
  log(f'setup {ctx.setup_s:.3f} s, window {win.wall:.3f} s, '
      f'{win.sections} sections, steps {len(steps)}: median '
      f'{statistics.median(steps):.4f} s, max {max(steps):.4f} s')
  breakdown, dev_info = None, {}
  if traced:
    t = time.perf_counter()
    ctx.trace = trace_lib.read(prof)
    log(f'trace read {time.perf_counter() - t:.3f} s, '
        f'{len(ctx.trace.ops)} device ops')
    del prof
    metrics = _read([(m, spec_lib.metric_reader(m['name']))
                     for m in cell.per_layer], ctx)
    breakdown = ctx.trace.breakdown
    dev_info = {'busy_s': ctx.trace.busy_s, 'window_s': ctx.trace.window_s}
  else:
    metrics = _read([(m, spec_lib.end_to_end_reader(m['name']))
                     for m in cell.end_to_end], ctx)
  kept = win.kept
  del driver, ctx
  if device.type == 'cuda':
    torch.cuda.empty_cache()
  t = time.perf_counter()
  values = spec_lib.check(cell).judge(inputs, kept, cfg, mix,
                                      control=control)
  log(f'check {time.perf_counter() - t:.3f} s over sections {kept.zs}')
  correct, table = verdict(values, cell.limits)
  failed = 0 if correct else len(kept.zs)
  if device.type == 'cuda':
    dev_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
                'count': 1, 'memory_peak_bytes': int(peak), **dev_info}
  else:
    dev_info = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0, **dev_info}
  out = {'correct': correct, 'attempted': win.sections, 'failed': failed,
         'metrics': metrics, 'device': dev_info}
  if breakdown is not None:
    out['breakdown'] = breakdown
  out['checks'] = table
  return out
