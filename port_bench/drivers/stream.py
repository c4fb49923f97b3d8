"""Traffic mode `stream`, online alignment during acquisition:
`align_step` on one section at a time, each handed the previous section
and its mesh once the last one has returned (a closed loop, one section
in flight); each block's first section is its anchor. Each section's
latency runs from its hand-over to its synchronized return. Kept for the
check: the first block's first moving section and sections drawn from
the seed, as the window produced them."""

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
    self.fn = entry.align_step
    self.blocks, self.device = inputs, device
    self.stride = int(cfg['stride'])
    self.cfg = _stack.stack_config(cfg)
    self.keep_at = {z - 1 for z in _stack.checked_sections(mix, seed)}

  def _mesh0(self):
    g = self.blocks.shape[-1] // self.stride
    return torch.zeros((2, 1, g, g), dtype=torch.float32,
                       device=self.blocks.device)

  def warm_up(self) -> None:
    mesh = self._mesh0()
    for z in (1, 2):
      mesh, _, _ = self.fn(self.blocks[0, z - 1], self.blocks[0, z], mesh,
                           self.cfg)
    _stack.sync(self.device)

  def layer_walls(self):
    return None  # align_step has no phase clock

  def window(self, seconds: float) -> Window:
    n_blocks, z_dim = self.blocks.shape[:2]
    lat = []
    kept = Kept(block=0, zs=[], mesh_prev={}, mesh={}, rendered={},
                overflow={})
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
      b, z = divmod(i, z_dim - 1)
      b, z = b % n_blocks, z + 1
      prev = self._mesh0() if z == 1 else mesh
      t_sec = time.perf_counter()
      mesh, rendered, overflow = self.fn(self.blocks[b, z - 1],
                                         self.blocks[b, z], prev, self.cfg)
      _stack.sync(self.device)
      lat.append(time.perf_counter() - t_sec)
      if i in self.keep_at:  # i < z_dim - 1: the first block
        kept.zs.append(z)
        kept.mesh_prev[z] = prev[:, 0]
        kept.mesh[z] = mesh[:, 0]
        kept.rendered[z] = rendered
        kept.overflow[z] = bool(overflow)
      i += 1
    t_end = time.perf_counter()
    return Window(t0, t_end, len(lat), lat, [], kept)
