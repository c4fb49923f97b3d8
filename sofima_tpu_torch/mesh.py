"""Elastic spring-mesh relaxation, plain PyTorch (subset).

Twin of sofima_tpu/mesh.py. Ported: `IntegrationConfig`, the generic
spring stencil `_spring_force` with `inplane_force` (2d, 8 neighbours;
on a CUDA tensor it launches kernel K8, ops.cuda_mesh.force_2d)
and `elastic_mesh_3d` (3d, 26 neighbours; on a CUDA tensor it launches
kernel K9, ops.cuda_mesh.force_3d), `_make_step_fns` (velocity Verlet +
FIRE, the k0 springs to `prev` or to `prev_fn(x)`, the force cap and its
upscaling, drift removal), `velocity_verlet` (one chunk of steps),
`relax_mesh` (the host-driven chunked loop) and `relax_mesh_fused` (the
two-streak convergence loop; `lax.while_loop` becomes a Python loop with
one host read per chunk). The stack-alignment solve runs the fused CUDA
kernel K3 instead (ops.cuda_mesh), unless drift removal asks for this
staged `relax_mesh_fused`; it is also K3's plain reference.

Positions are relative: node (i, j) with value (dx, dy) sits at
(i*stride + dx, j*stride + dy). Arrays are [2|3, ..., (z,) y, x]
(channels x, y[, z]).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence

import numpy as np
import torch

from sofima_tpu_torch import placement

# 13 link directions (xyz components) covering the 26-neighbourhood of a
# node modulo inversion: 3 nearest, 6 next-nearest, 4 corner links.
MESH_LINK_DIRECTIONS: tuple[tuple[int, int, int], ...] = tuple(
    (dx, dy, dz)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dz, dy, dx) > (0, 0, 0))  # one representative per +- pair

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


def _link_slices(direction_zyx: Sequence[int], ndim: int, spatial: int):
  """Slices and pads of a shifted-difference stencil over trailing axes.

  For a link from node i to node i+e: `hi` selects nodes i+e, `lo`
  nodes i; `pad_hi` / `pad_lo` (torch.nn.functional.pad order) scatter a
  quantity defined on the overlap back onto the i+e / i positions.
  """
  hi = [slice(None)] * ndim
  lo = [slice(None)] * ndim
  pad_hi = [0] * (2 * spatial)
  pad_lo = [0] * (2 * spatial)
  for k, e in enumerate(direction_zyx):
    axis = ndim - spatial + k
    p = 2 * (spatial - 1 - k)  # (left, right) of this axis in pad order
    if e == 1:
      hi[axis], lo[axis] = slice(1, None), slice(None, -1)
      pad_hi[p], pad_lo[p + 1] = 1, 1
    elif e == -1:
      hi[axis], lo[axis] = slice(None, -1), slice(1, None)
      pad_hi[p + 1], pad_lo[p] = 1, 1
    elif e != 0:
      raise ValueError('Link components must be in {-1, 0, 1}.')
  return tuple(hi), tuple(lo), pad_hi, pad_lo


def _spring_force(x: torch.Tensor, links, k_eff, stride_xyz,
                  prefer_orig_order: bool, spatial: int) -> torch.Tensor:
  """Total Hookean force of a set of spring families on [dim, ..., grid].

  Per link i -> i+e: dx = x[i+e] - x[i] + l0_vec, force
  f = -k (1 - l0 / |dx|) dx (or the fold-preventing per-component form
  with `prefer_orig_order`), NaN and inf mapped to 0; node i+e gets +f
  and node i gets -f.
  """
  dim = x.shape[0]
  total = torch.zeros_like(x)
  for direction, k in zip(links, k_eff):
    l0_np = np.asarray([stride_xyz[c] * direction[c] for c in range(dim)],
                       np.float32)
    l0_vec = torch.as_tensor(l0_np, device=x.device).reshape(
        (dim,) + (1,) * (x.ndim - 1))
    l0 = float(np.linalg.norm(l0_np))
    hi, lo, pad_hi, pad_lo = _link_slices(direction[::-1], x.ndim, spatial)
    dx = x[hi] - x[lo] + l0_vec
    length = torch.linalg.vector_norm(dx, dim=0)
    if prefer_orig_order:
      factor = torch.stack([
          direction[c] * torch.sign(dx[c]) if direction[c] != 0
          else torch.ones_like(dx[c]) for c in range(dim)])
      f = -k * (1.0 - l0 * factor / length) * dx
    else:
      f = -k * (1.0 - l0 / length) * dx
    f = torch.nan_to_num(f, nan=0.0, posinf=0.0, neginf=0.0)
    total = (total + torch.nn.functional.pad(f, pad_hi)
             - torch.nn.functional.pad(f, pad_lo))
  return total


def inplane_force_plain(x: torch.Tensor, k: float, stride: Sequence[float],
                        prefer_orig_order: bool = False) -> torch.Tensor:
  """Plain PyTorch in-plane force of [2, ..., y, x] positions.

  Spring families: axis links (k) and diagonals (k/sqrt(2)).
  """
  if len(stride) != 2:
    raise ValueError('stride must be 2D (XY).')
  k_diag = k / np.sqrt(2.0)
  return _spring_force(x, INPLANE_LINK_DIRECTIONS, (k, k, k_diag, k_diag),
                       tuple(stride), prefer_orig_order, spatial=2)


def inplane_force(x: torch.Tensor, k: float, stride: Sequence[float],
                  prefer_orig_order: bool = False) -> torch.Tensor:
  """In-plane forces of a 2d spring mesh ([2, ..., y, x] positions).

  Batch axes may sit between the channels and the grid. A CPU tensor
  takes the plain version; a CUDA tensor launches kernel K8.
  """
  if len(stride) != 2:
    raise ValueError('stride must be 2D (XY).')
  if x.device.type == 'cpu':
    return inplane_force_plain(x, k, stride, prefer_orig_order)
  from sofima_tpu_torch.ops import cuda_mesh  # imports this module
  return cuda_mesh.force_2d(x, k, stride, prefer_orig_order)


def link_constants_3d(k: float, stride,
                      links=MESH_LINK_DIRECTIONS) -> list[float]:
  """Per-link k_eff = k * stride_x / l0 (constant elasticity across the
  link families), in the order of `links`."""
  stride = _stride3(stride)
  return [k * stride[0] / float(np.linalg.norm(
      [stride[c] * d[c] for c in range(3)])) for d in links]


def _stride3(stride) -> tuple[float, float, float]:
  if not isinstance(stride, (tuple, list)):
    return (float(stride),) * 3
  return tuple(float(s) for s in stride)


def elastic_mesh_3d_plain(x: torch.Tensor, k: float, stride,
                          prefer_orig_order: bool = False,
                          links=MESH_LINK_DIRECTIONS) -> torch.Tensor:
  """Plain PyTorch force of the springs `links` (default: all 26
  neighbours) on [3, ..., z, y, x] positions."""
  assert x.shape[0] == 3
  stride = _stride3(stride)
  return _spring_force(x, links, link_constants_3d(k, stride, links),
                       stride, prefer_orig_order, spatial=3)


def elastic_mesh_3d(x: torch.Tensor, k: float, stride,
                    prefer_orig_order: bool = False,
                    links=MESH_LINK_DIRECTIONS) -> torch.Tensor:
  """Internal forces of a 3d spring mesh ([3, ..., z, y, x] positions).

  `links`: the spring directions (xyz, components in {-1, 0, 1}; a link
  and its negation are one spring), k_eff = k * stride_x / l0 each.
  Batch axes may sit between the channels and the grid. A CPU tensor
  takes the plain version; a CUDA tensor launches kernel K9.
  """
  if x.device.type == 'cpu':
    return elastic_mesh_3d_plain(x, k, stride, prefer_orig_order, links)
  from sofima_tpu_torch.ops import cuda_mesh  # imports this module
  return cuda_mesh.force_3d(x, k, stride, prefer_orig_order, links)


def _nanmean(v: torch.Tensor, dims) -> torch.Tensor:
  ok = ~torch.isnan(v)
  s = torch.where(ok, v, torch.zeros_like(v)).sum(dim=dims, keepdim=True)
  return s / ok.sum(dim=dims, keepdim=True)


def _make_step_fns(config: IntegrationConfig, mesh_force, prev_fn=None,
                   reduce_fn=None, mean_fn=None):
  """Builds the force, velocity-Verlet and FIRE step functions.

  FIRE state: (x, v, a, dt, alpha, n_pos, cap), scalars as 0-d tensors so
  a step never reads the device back. With `prev_fn`, the k0 springs pull
  toward `prev_fn(x)`, re-evaluated at every force evaluation.
  `reduce_fn(v)` / `mean_fn(v, dims)` let the sharded solver replace the
  global reductions (FIRE's power, the drift means) with collectives
  over its ranks; the defaults are the identity and the NaN-aware mean.
  """
  if reduce_fn is None:
    reduce_fn = lambda v: v
  if mean_fn is None:
    mean_fn = _nanmean

  def force(x, prev, cap):
    a = mesh_force(x, config.k, config.stride, config.prefer_orig_order)
    if prev_fn is not None:
      prev = prev_fn(x)
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
    power = reduce_fn(torch.sum(a * v))
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
      x = x - mean_fn(x, dims)
      v = torch.where(present,
                      v - mean_fn(torch.where(present, v, torch.nan), dims),
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


def velocity_verlet(x: torch.Tensor, v: torch.Tensor,
                    prev: torch.Tensor | None, config: IntegrationConfig,
                    force_cap, fire_dt=None, fire_alpha=None,
                    mesh_force=inplane_force, prev_fn=None):
  """Runs `config.num_iters` integration steps.

  Returns (x, v, a) for plain damped Verlet, or
  (x, v, a, dt, alpha, n_pos, cap) when FIRE is enabled (scalars as 0-d
  tensors; `fire_dt` / `fire_alpha` may be tensors from the last chunk).
  """
  force, vv_step, fire_step = _make_step_fns(config, mesh_force, prev_fn)
  f32 = dict(dtype=torch.float32, device=x.device)
  cap = torch.as_tensor(force_cap, **f32)
  a = force(x, prev, cap)
  if config.fire:
    state = (x, v, a,
             torch.as_tensor(config.dt if fire_dt is None else fire_dt, **f32),
             torch.as_tensor(config.alpha if fire_alpha is None
                             else fire_alpha, **f32),
             torch.tensor(0, dtype=torch.int32, device=x.device), cap)
    for _ in range(config.num_iters):
      state = fire_step(state, prev)
    return state
  state = (x, v, a)
  for _ in range(config.num_iters):
    state = vv_step(state, config.dt, cap, prev)
  return state


def relax_mesh(x, prev, config: IntegrationConfig, mesh_force=inplane_force,
               prev_fn=None, device=None):
  """Relaxes the mesh until convergence (host-driven chunked loop).

  Each chunk is one `velocity_verlet` call (n_pos restarts at 0, as in
  the reference); after it the host reads v_max and the FIRE cap, stops
  at the first converged boundary with the cap at its final value, and
  otherwise escalates the cap. Host (numpy) inputs go to `device`
  (default: the CUDA card); tensors stay where they are.

  Returns (final positions, kinetic-energy history, steps executed).
  """
  if config.start_cap != config.final_cap:
    if not config.fire:
      raise NotImplementedError(
          'Adaptive force capping requires the FIRE integrator.')
    if config.cap_scale <= 1:
      raise ValueError('cap_scale must be > 1 for adaptive capping.')
  if prev is not None and prev_fn is not None:
    raise ValueError('Only one of "prev" and "prev_fn" may be given.')
  x = placement.place(x, device, torch.float32)
  if prev is not None:
    prev = placement.place(prev, x.device, torch.float32)
  t = 0
  v = torch.zeros_like(x)
  dt, alpha, cap = config.dt, config.alpha, config.start_cap
  e_kin: list[float] = []
  while t < config.max_iters:
    state = velocity_verlet(x, v, prev, config, cap, dt, alpha, mesh_force,
                            prev_fn)
    t += config.num_iters
    x, v = state[:2]
    v_mag = torch.linalg.vector_norm(v, dim=0)
    stats = torch.stack([torch.sum(v_mag ** 2), torch.max(v_mag)]).tolist()
    e_kin.append(stats[0])
    v_max = stats[1]
    if config.fire:
      dt, alpha, cap = state[3], state[4], float(state[6])
    if v_max < config.stop_v_max:
      if cap >= config.final_cap:
        break
      cap = min(cap * config.cap_scale, config.final_cap)
  return x, e_kin, t


def relax_mesh_fused(x: torch.Tensor, prev: torch.Tensor | None,
                     config: IntegrationConfig, mesh_force=inplane_force,
                     prev_fn=None):
  """Relaxes the mesh until convergence.

  With `prev_fn`, the k0 springs pull toward `prev_fn(x)`, evaluated at
  every force evaluation (in place of `prev`).
  Returns (x, e_kin history [max_chunks], steps executed).
  """
  if not config.fire:
    raise NotImplementedError('relax_mesh_fused requires FIRE.')
  force, _, fire_step = _make_step_fns(config, mesh_force, prev_fn)
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
