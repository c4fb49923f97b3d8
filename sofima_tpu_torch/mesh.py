"""Elastic spring-mesh relaxation, plain PyTorch (subset).

Twin of sofima_tpu/mesh.py. Ported: `IntegrationConfig`, `_make_step_fns`
(velocity Verlet + FIRE, the k0 springs to `prev`, the force cap and its
upscaling, drift removal), `inplane_force` and `relax_mesh_fused` (the
chunked convergence loop; `lax.while_loop` becomes a Python loop with
one host read per chunk). The stack-alignment solve runs the fused CUDA
kernel instead (ops.cuda_mesh); this module is its plain reference and
the solver for configurations that kernel does not take.

Positions are relative: node (i, j) with value (dx, dy) sits at
(i*stride + dx, j*stride + dy). Arrays are [2, ..., y, x] (channels x, y).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence

import numpy as np
import torch

INPLANE_LINK_DIRECTIONS: tuple[tuple[int, int], ...] = (
    (1, 0), (0, 1), (1, 1), (-1, 1))


@dataclasses.dataclass(frozen=True)
class IntegrationConfig:
  """Parameters for the numerical integration of the mesh state.

  Same fields and defaults as sofima_tpu.mesh.IntegrationConfig.
  """

  dt: float                # time step
  gamma: float             # damping constant
  k0: float                # inter-section (zero-length) spring constant
  k: float                 # intra-section spring constant
  stride: tuple[float, ...]  # grid spacing (XY[Z])
  num_iters: int           # steps per chunk
  max_iters: int           # upper bound on total steps
  stop_v_max: float        # terminate when all |v| < this (and cap final)

  fire: bool = True
  f_alpha: float = 0.99
  f_inc: float = 1.1
  f_dec: float = 0.5
  alpha: float = 0.1
  n_min: int = 5
  dt_max: float = 10.0     # max dt, in units of `dt`

  start_cap: float = 1e6
  final_cap: float = 1e6
  cap_scale: float = 1.1
  cap_upscale_every: int = 100

  prefer_orig_order: bool = False
  remove_drift: bool = False

  def __post_init__(self):
    object.__setattr__(self, 'stride', tuple(self.stride))

  def to_json(self) -> str:
    return json.dumps({f.name: (list(v) if isinstance(v, tuple) else v)
                       for f in dataclasses.fields(self)
                       for v in [getattr(self, f.name)]})

  @classmethod
  def from_json(cls, text: str) -> 'IntegrationConfig':
    return cls(**json.loads(text))


def _link_slices(direction_yx: Sequence[int], ndim: int):
  """Slices and pads of a shifted-difference stencil over the last 2 axes."""
  hi = [slice(None)] * ndim
  lo = [slice(None)] * ndim
  pad_hi = [0, 0] * 2
  pad_lo = [0, 0] * 2
  # torch pad order: (x_left, x_right, y_left, y_right).
  for k, e in enumerate(direction_yx):
    axis = ndim - 2 + k
    p = 2 * (1 - k)
    if e == 1:
      hi[axis], lo[axis] = slice(1, None), slice(None, -1)
      pad_hi[p], pad_lo[p + 1] = 1, 1
    elif e == -1:
      hi[axis], lo[axis] = slice(None, -1), slice(1, None)
      pad_hi[p + 1], pad_lo[p] = 1, 1
  return tuple(hi), tuple(lo), pad_hi, pad_lo


def inplane_force(x: torch.Tensor, k: float, stride: Sequence[float],
                  prefer_orig_order: bool = False) -> torch.Tensor:
  """In-plane forces of a 2d spring mesh ([2, ..., y, x] positions).

  Spring families: axis links (k) and diagonals (k/sqrt(2)).
  """
  if len(stride) != 2:
    raise ValueError('stride must be 2D (XY).')
  k_diag = k / np.sqrt(2.0)
  total = torch.zeros_like(x)
  for direction, k_eff in zip(INPLANE_LINK_DIRECTIONS,
                              (k, k, k_diag, k_diag)):
    l0_vec = torch.tensor([stride[c] * direction[c] for c in range(2)],
                          dtype=torch.float32, device=x.device)
    l0_vec = l0_vec.reshape((2,) + (1,) * (x.ndim - 1))
    l0 = float(np.linalg.norm(np.asarray(
        [stride[c] * direction[c] for c in range(2)], np.float32)))
    hi, lo, pad_hi, pad_lo = _link_slices(direction[::-1], x.ndim)
    dx = x[hi] - x[lo] + l0_vec
    length = torch.linalg.vector_norm(dx, dim=0)
    if prefer_orig_order:
      factor = torch.stack([
          direction[c] * torch.sign(dx[c]) if direction[c] != 0
          else torch.ones_like(dx[c]) for c in range(2)])
      f = -k_eff * (1.0 - l0 * factor / length) * dx
    else:
      f = -k_eff * (1.0 - l0 / length) * dx
    f = torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
    total = (total + torch.nn.functional.pad(f, pad_hi)
             - torch.nn.functional.pad(f, pad_lo))
  return total


def _nanmean(v: torch.Tensor, dims) -> torch.Tensor:
  ok = ~torch.isnan(v)
  s = torch.where(ok, v, torch.zeros_like(v)).sum(dim=dims, keepdim=True)
  return s / ok.sum(dim=dims, keepdim=True)


def _make_step_fns(config: IntegrationConfig, mesh_force):
  """Builds the force, velocity-Verlet and FIRE step functions.

  FIRE state: (x, v, a, dt, alpha, n_pos, cap), scalars as 0-d tensors so
  a step never reads the device back.
  """

  def force(x, prev, cap):
    a = mesh_force(x, config.k, config.stride, config.prefer_orig_order)
    if prev is not None:
      a = a + torch.clamp(-config.k0 * torch.nan_to_num(x - prev),
                          -cap, cap)
    return a

  def vv_step(state, dt, cap, prev):
    x, v, a = state
    x = x + dt * v + (0.5 * dt * dt) * a
    a_new = force(x, prev, cap)
    damp_in = 1.0 / (1.0 + 0.5 * dt * config.gamma)
    damp_out = 1.0 - 0.5 * dt * config.gamma
    v = damp_in * (v * damp_out + 0.5 * dt * (a + a_new))
    return x, v, a_new

  def fire_step(state, prev):
    x, v, a, dt, alpha, n_pos, cap = state
    x, v, a = vv_step((x, v, a), dt, cap, prev)
    a_norm = torch.linalg.vector_norm(a, dim=0, keepdim=True) + 1e-6
    v_norm = torch.linalg.vector_norm(v, dim=0, keepdim=True)
    power = torch.sum(a * v)
    v = v + alpha * (a / a_norm * v_norm - v)

    uphill = power < 0
    n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
    grow = (~uphill) & (n_pos > config.n_min)
    dt_cap = torch.tensor(config.dt_max * config.dt, dtype=torch.float32,
                          device=dt.device)
    dt = torch.where(uphill, dt * config.f_dec,
                     torch.where(grow, torch.minimum(dt * config.f_inc,
                                                     dt_cap), dt))
    alpha = torch.where(uphill, torch.full_like(alpha, config.alpha),
                        torch.where(grow, alpha * config.f_alpha, alpha))
    up = (~uphill) & (n_pos > 0) & (n_pos % config.cap_upscale_every == 0)
    cap = torch.clamp(torch.where(up, config.cap_scale * cap, cap),
                      max=config.final_cap)
    v = v * (~uphill)

    if config.remove_drift:
      dims = tuple(range(1, x.ndim))
      present = torch.isfinite(x)
      x = x - _nanmean(x, dims)
      v = torch.where(present,
                      v - _nanmean(torch.where(present, v, torch.nan), dims),
                      torch.zeros_like(v))
    return x, v, a, dt, alpha, n_pos, cap

  return force, vv_step, fire_step


def fire_state0(x: torch.Tensor, a0: torch.Tensor, config: IntegrationConfig):
  """Initial FIRE state: zero velocity, config dt / alpha / start_cap."""
  f32 = dict(dtype=torch.float32, device=x.device)
  return (x, torch.zeros_like(x), a0, torch.tensor(config.dt, **f32),
          torch.tensor(config.alpha, **f32),
          torch.tensor(0, dtype=torch.int32, device=x.device),
          torch.tensor(config.start_cap, **f32))


def run_chunks(state, fire_step, prev, config: IntegrationConfig,
               max_chunks: int, v_stats):
  """The chunked convergence loop shared by the plain solvers.

  `v_stats(v)` -> (e_kin, v_max) 0-d tensors. Stops after two consecutive
  converged chunk boundaries (v_max < stop_v_max with the cap at its
  final value); the cap escalates when velocities converged first.
  Returns (state, e_kin history [max_chunks], steps).
  """
  e_hist = torch.full((max_chunks,), float('nan'), dtype=torch.float32,
                      device=state[0].device)
  chunk, streak = 0, 0
  while streak < 2 and chunk < max_chunks:
    for _ in range(config.num_iters):
      state = fire_step(state, prev)
    e_kin, v_max = v_stats(state[1])
    e_hist[chunk] = e_kin
    cap = state[-1]
    v_max, cap_f = float(v_max), float(cap)
    streak = streak + 1 if (v_max < config.stop_v_max
                            and cap_f >= config.final_cap) else 0
    if v_max < config.stop_v_max and cap_f < config.final_cap:
      cap = torch.clamp(cap * config.cap_scale, max=config.final_cap)
    state = state[:-1] + (cap,)
    chunk += 1
  return state, e_hist, chunk * config.num_iters


def relax_mesh_fused(x: torch.Tensor, prev: torch.Tensor | None,
                     config: IntegrationConfig, mesh_force=inplane_force):
  """Relaxes the mesh until convergence.

  Returns (x, e_kin history [max_chunks], steps executed).
  """
  if not config.fire:
    raise NotImplementedError('relax_mesh_fused requires FIRE.')
  force, _, fire_step = _make_step_fns(config, mesh_force)
  max_chunks = int(math.ceil(config.max_iters / config.num_iters))
  x = x.to(torch.float32)
  a0 = force(x, prev, torch.tensor(config.start_cap, dtype=torch.float32,
                                   device=x.device))
  state = fire_state0(x, a0, config)

  def v_stats(v):
    v_mag = torch.linalg.vector_norm(v, dim=0)
    return torch.sum(v_mag ** 2), torch.max(v_mag)

  state, e_hist, steps = run_chunks(state, fire_step, prev, config,
                                    max_chunks, v_stats)
  return state[0], e_hist, steps
