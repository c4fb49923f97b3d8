"""Kernel K3, the fused FIRE mesh solver: CUDA wrapper and plain twin.

Twin of sofima_tpu/ops/pallas_mesh.py `relax_mesh_fused_pallas` (Pallas
body `_fused_fire_kernel` with `_roll_force_2d`). The CUDA kernel is
csrc/fire.cu: one cooperative launch runs the whole chunked convergence
loop with the state in device memory. It takes any grid size (the
Pallas kernel's VMEM bound, and the pipeline's size fallback, do not
apply here).

Contract, as the reference's: [2, 1, gy, gx] state, FIRE required;
returns (x, e_kin history [min(max_chunks, 128)], steps). Nodes outside
the grid or with NaN positions carry no springs. Drift removal is in
neither the kernel nor its plain version: `remove_drift=True` raises
NotImplementedError on every device rather than run another solver.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from sofima_tpu_torch import mesh as mesh_lib
from sofima_tpu_torch.ops import _build

MAX_HISTORY = 128


def roll_force_2d(xp: torch.Tensor, k: float, stride,
                  prefer_orig_order: bool) -> torch.Tensor:
  """8-neighbour in-plane force on a NaN-ring-padded [2, Y, X] array.

  Twin of pallas_mesh._roll_force_2d: neighbours come from circular
  rolls, and the NaN guard ring makes the wraparound inert.
  """
  sx, sy = float(stride[0]), float(stride[1])
  acc0 = torch.zeros(xp.shape[1:], dtype=torch.float32, device=xp.device)
  acc1 = torch.zeros_like(acc0)
  for ey in (-1, 0, 1):
    for ex in (-1, 0, 1):
      if ex == 0 and ey == 0:
        continue
      nbor = torch.roll(xp, shifts=(-ey, -ex), dims=(1, 2))
      l0x = float(np.float32(sx * ex))
      l0y = float(np.float32(sy * ey))
      l0 = float(np.hypot(l0x, l0y))
      k_eff = k if (ex == 0 or ey == 0) else k / np.sqrt(2.0)
      d0 = nbor[0] - xp[0] + l0x
      d1 = nbor[1] - xp[1] + l0y
      dd = d0 * d0 + d1 * d1
      inv_l = torch.rsqrt(torch.clamp(dd, min=0.0))
      if prefer_orig_order:
        fac0 = float(ex) * torch.sign(d0) if ex != 0 else 1.0
        fac1 = float(ey) * torch.sign(d1) if ey != 0 else 1.0
        f0 = k_eff * (1.0 - l0 * fac0 * inv_l) * d0
        f1 = k_eff * (1.0 - l0 * fac1 * inv_l) * d1
      else:
        coef = k_eff * (1.0 - l0 * inv_l)
        f0, f1 = coef * d0, coef * d1
      fin = torch.isfinite(dd)
      acc0 = acc0 + torch.where(fin, f0, torch.zeros_like(f0))
      acc1 = acc1 + torch.where(fin, f1, torch.zeros_like(f1))
  return torch.stack([acc0, acc1])


def _max_chunks(config) -> int:
  return min(int(math.ceil(config.max_iters / config.num_iters)), MAX_HISTORY)


def relax_mesh_fused_plain(x: torch.Tensor, prev: torch.Tensor | None,
                           config: mesh_lib.IntegrationConfig):
  """Plain PyTorch version of the fused solver on [2, gy, gx] state."""
  pad = (1, 1, 1, 1)
  xp = torch.nn.functional.pad(x.to(torch.float32), pad, value=float('nan'))
  pp = None if prev is None else torch.nn.functional.pad(
      prev.to(torch.float32), pad, value=float('nan'))
  force, _, fire_step = mesh_lib._make_step_fns(
      config, lambda xx, k, s, po: roll_force_2d(xx, k, s, po))
  a0 = force(xp, pp, torch.tensor(config.start_cap, dtype=torch.float32,
                                  device=xp.device))
  state = mesh_lib.fire_state0(xp, a0, config)

  def v_stats(v):
    v_sq = v[0] * v[0] + v[1] * v[1]
    return torch.sum(v_sq), torch.sqrt(torch.max(v_sq))

  state, e_hist, steps = mesh_lib.run_chunks(
      state, fire_step, pp, config, _max_chunks(config), v_stats)
  return state[0][:, 1:-1, 1:-1], e_hist, steps


def _launch(x, prev, config):
  _build.require_cuda('relax_mesh_fused', *([x] if prev is None
                                            else [x, prev]))
  lib = _build.library()
  lib.fused_fire_max_blocks.argtypes = [ctypes.c_int]
  lib.fused_fire_max_blocks.restype = ctypes.c_int
  lib.fused_fire_threads.restype = ctypes.c_int
  fn = lib.fused_fire_launch
  fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
                 + [ctypes.c_float] * 5 + [ctypes.c_int]
                 + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
                 + [ctypes.c_void_p])
  fn.restype = ctypes.c_int
  _, gy, gx = x.shape
  n = gy * gx
  dev = x.device
  max_blocks = lib.fused_fire_max_blocks(dev.index or 0)
  if max_blocks <= 0:
    raise RuntimeError('cooperative launch unavailable on this device')
  nblocks = max(1, min(max_blocks, -(-n // lib.fused_fire_threads())))
  xw = x.clone()
  v = torch.empty_like(xw)
  a = torch.empty_like(xw)
  part = torch.empty(3 * nblocks, dtype=torch.float32, device=dev)
  max_chunks = _max_chunks(config)
  ehist = torch.full((max_chunks,), float('nan'), dtype=torch.float32,
                     device=dev)
  steps = torch.zeros(1, dtype=torch.int32, device=dev)
  c = config
  rc = fn(xw.data_ptr(), _build.ptr(prev), v.data_ptr(), a.data_ptr(),
          part.data_ptr(), ehist.data_ptr(), steps.data_ptr(), gy, gx,
          nblocks, c.dt, c.gamma, c.k0, c.k, float(c.k / np.sqrt(2.0)),
          float(c.stride[0]), float(c.stride[1]), c.num_iters, max_chunks,
          c.stop_v_max, c.f_alpha, c.f_inc, c.f_dec, c.alpha, c.n_min,
          float(np.float32(c.dt_max * c.dt)), c.start_cap, c.final_cap,
          c.cap_scale, c.cap_upscale_every, int(c.prefer_orig_order),
          _build.stream_of(x))
  _build.launch_counts['fused_fire'] += 1
  _build.check(rc, 'fused_fire')
  return xw, ehist, steps[0]


def relax_mesh_fused(x: torch.Tensor, prev: torch.Tensor | None,
                     config: mesh_lib.IntegrationConfig):
  """Fused FIRE relaxation -> (x, e_kin history, steps).

  CPU tensors take the plain version; CUDA tensors launch the kernel.
  """
  if not config.fire:
    raise NotImplementedError('relax_mesh_fused requires FIRE.')
  if config.remove_drift:
    raise NotImplementedError(
        'drift removal is not in the fused solver (ROADMAP.md Queue 1, '
        'item 8: drift removal inside the fused kernel)')
  if x.ndim != 4 or x.shape[:2] != (2, 1):
    raise ValueError('[2, 1, gy, gx] state expected')
  x = x[:, 0].to(torch.float32).contiguous()
  prev = None if prev is None else prev[:, 0].to(torch.float32).contiguous()
  if x.device.type == 'cpu':
    out, ehist, steps = relax_mesh_fused_plain(x, prev, config)
  else:
    out, ehist, steps = _launch(x, prev, config)
  return out[:, None], ehist, steps
