"""Traffic mode `block`, offline alignment: `align_stack_pipelined` on a
device-resident block of sections, calls back to back (cycling the
blocks) for the window. A call started before the window's end is
waited for and counted. Kept for the check: the outputs of one of the
first calls, drawn from the seed, at the block's first moving section
and at sections drawn from the seed.

In traced runs the layer walls come from the entry's own phase clock
(`timings=`, which synchronizes at each phase) over `phase_calls` calls
made before the traced window, without the profiler; the traced window
runs as the untraced one does.
"""

from __future__ import annotations

import time

import torch

from port_bench.checks.stack_align import Kept
from port_bench.drivers import _stack
from port_bench.harness.window import Window

prepare = _stack.prepare
spans = _stack.layer_spans


class Driver:

  def __init__(self, cfg: dict, mix: dict, inputs, seed: int, device,
               entry=None):
    if entry is None:
      from sofima_tpu_torch.pipeline import stack_align as entry
    self.fn = entry.align_stack_pipelined
    self.blocks, self.mix, self.device = inputs, mix, device
    self.cfg = _stack.stack_config(cfg)
    self.out_dtype = getattr(torch, mix['out_dtype']) if mix.get(
        'out_dtype') else None
    self.keep_call = _stack.drawn_call(mix, seed)
    self.zs = _stack.checked_sections(mix, seed)

  def _call(self, b, timings=None):
    out = self.fn(self.blocks[b], self.cfg, self.out_dtype, timings=timings)
    _stack.sync(self.device)
    return out

  def warm_up(self) -> None:
    self._call(0)

  def layer_walls(self):
    """(phase -> seconds, moving sections) over `phase_calls` calls."""
    timings, z_dim = {}, self.blocks.shape[1]
    calls = self.mix['phase_calls']
    for c in range(calls):
      tim = {}
      self._call(c % self.blocks.shape[0], tim)
      for k, v in tim.items():
        timings[k] = timings.get(k, 0.0) + v
    return timings, calls * (z_dim - 1)

  def window(self, seconds: float) -> Window:
    n_blocks, z_dim = self.blocks.shape[:2]
    calls, kept = [], None
    t0 = time.perf_counter()
    c = 0
    while time.perf_counter() - t0 < seconds:
      b = c % n_blocks
      t_call = time.perf_counter()
      out = self._call(b)
      calls.append(time.perf_counter() - t_call)
      if c <= self.keep_call:  # the drawn call, or the last if fewer ran
        kept = (b,) + tuple(out)
      del out
      c += 1
    t_end = time.perf_counter()
    b, rendered, solved, overflow = kept
    meshes = solved[:, :, 0]
    keep = Kept(
        block=b, zs=self.zs,
        mesh_prev={z: meshes[z - 1] if z > 1 else torch.zeros_like(meshes[0])
                   for z in self.zs},
        mesh={z: meshes[z] for z in self.zs},
        rendered={z: rendered[z] for z in self.zs},
        overflow={None: bool(overflow)}, meshes_all=meshes)
    return Window(t0, t_end, len(calls) * (z_dim - 1), [], calls, keep)
