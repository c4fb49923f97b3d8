"""Plain mesh solve of one section: compose the pair's flow with the
previous section's mesh, then relax the spring mesh by FIRE.

A frozen plain version of the stack path's solve layer. The mesh is
[2, G, G] (x, y) relative positions; every node is tied to its eight
neighbours by springs of rest length `stride` (axis links, constant k)
or stride * sqrt(2) (diagonals, k / sqrt(2)), with the per-component
fold-preventing form, and to its target by a zero-length spring k0
whose force is clamped to the current cap. FIRE (velocity Verlet with
power-guided mixing and time-step control) runs in chunks of
`num_iters` steps until two consecutive chunk ends see every speed
below `stop_v_max` with the cap at its final value, the cap growing by
`cap_scale` every `cap_upscale_every` rising steps and at chunk ends
whose speeds converged first. On a CUDA card one step is captured once
as a CUDA graph and replayed: the same operations without the host's
launch cost.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_HISTORY = 128


def _bilinear_clamped(values, qy, qx):
  """Bilinear samples of [n0, n1] at index coordinates, indices clamped
  to the edge; NaN coordinates give NaN, zero-weight taps add nothing."""
  n0, n1 = values.shape
  nan_q = torch.isnan(qy) | torch.isnan(qx)
  qy, qx = torch.nan_to_num(qy), torch.nan_to_num(qx)
  by, bx = torch.floor(qy), torch.floor(qx)
  fy, fx = qy - by, qx - bx
  by, bx = by.to(torch.int64), bx.to(torch.int64)
  flat = values.reshape(-1)
  out = None
  for oy, wy in ((0, 1.0 - fy), (1, fy)):
    for ox, wx in ((0, 1.0 - fx), (1, fx)):
      w = wy * wx
      lin = (by + oy).clamp(0, n0 - 1) * n1 + (bx + ox).clamp(0, n1 - 1)
      term = w * flat[lin]
      term = torch.where(w == 0.0, torch.zeros_like(term), term)
      out = term if out is None else out + term
  return torch.where(nan_q, torch.full_like(out, float('nan')), out)


def compose(flow, mesh_prev, stride):
  """mesh_prev o flow on flow's [G, G] grid: each node moves by its flow
  and reads the previous mesh there (bilinear, edge-clamped)."""
  g0, g1 = flow.shape[-2:]
  dev = flow.device
  ry = torch.arange(g0, dtype=torch.float32, device=dev)[:, None].expand(
      g0, g1) * stride
  rx = torch.arange(g1, dtype=torch.float32, device=dev)[None, :].expand(
      g0, g1) * stride
  qy = (ry + flow[1]) / stride
  qx = (rx + flow[0]) / stride
  out_x = _bilinear_clamped(mesh_prev[0] + rx, qy, qx) - rx
  out_y = _bilinear_clamped(mesh_prev[1] + ry, qy, qx) - ry
  return torch.stack([out_x, out_y])


def _force(xp, k, stride):
  """Spring force on a NaN-ring-padded [2, Y, X] mesh (neighbours by
  circular rolls; the NaN ring makes the wraparound inert)."""
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
      fac0 = float(ex) * torch.sign(d0) if ex != 0 else 1.0
      fac1 = float(ey) * torch.sign(d1) if ey != 0 else 1.0
      f0 = k_eff * (1.0 - l0 * fac0 * inv_l) * d0
      f1 = k_eff * (1.0 - l0 * fac1 * inv_l) * d1
      fin = torch.isfinite(dd)
      acc0 = acc0 + torch.where(fin, f0, torch.zeros_like(f0))
      acc1 = acc1 + torch.where(fin, f1, torch.zeros_like(f1))
  return torch.stack([acc0, acc1])


class Fire:
  """The FIRE relaxation of one configuration (a dict of the solver's
  constants: dt, gamma, k0, k, stride, num_iters, max_iters, stop_v_max,
  dt_max, start_cap, final_cap, cap_scale, prefer_orig_order; FIRE's own
  constants f_alpha, f_inc, f_dec, alpha, n_min and cap_upscale_every
  where given, else at their defaults)."""

  def __init__(self, m: dict, graphs: bool = True):
    if not m.get('prefer_orig_order', False):
      raise ValueError('the reference solves the fold-preventing form only')
    self.m = m
    self.graphs = graphs
    self.f_alpha = m.get('f_alpha', 0.99)
    self.f_inc = m.get('f_inc', 1.1)
    self.f_dec = m.get('f_dec', 0.5)
    self.alpha0 = m.get('alpha', 0.1)
    self.n_min = m.get('n_min', 5)
    self.cap_every = m.get('cap_upscale_every', 100)

  def _accel(self, x, prev, cap):
    m = self.m
    a = _force(x, m['k'], m['stride'])
    return a + torch.clamp(-m['k0'] * torch.nan_to_num(x - prev), -cap, cap)

  def _step(self, state, prev, dt_cap):
    m = self.m
    x, v, a, dt, alpha, n_pos, cap = state
    x = x + dt * v + (0.5 * dt * dt) * a
    a_new = self._accel(x, prev, cap)
    damp_in = 1.0 / (1.0 + 0.5 * dt * m['gamma'])
    damp_out = 1.0 - 0.5 * dt * m['gamma']
    v = damp_in * (v * damp_out + 0.5 * dt * (a + a_new))
    a = a_new
    a_norm = torch.linalg.vector_norm(a, dim=0, keepdim=True) + 1e-6
    v_norm = torch.linalg.vector_norm(v, dim=0, keepdim=True)
    power = torch.sum(a * v)
    v = v + alpha * (a / a_norm * v_norm - v)
    uphill = power < 0
    n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
    grow = (~uphill) & (n_pos > self.n_min)
    dt = torch.where(uphill, dt * self.f_dec,
                     torch.where(grow, torch.minimum(dt * self.f_inc, dt_cap),
                                 dt))
    alpha = torch.where(uphill, torch.full_like(alpha, self.alpha0),
                        torch.where(grow, alpha * self.f_alpha, alpha))
    up = (~uphill) & (n_pos > 0) & (n_pos % self.cap_every == 0)
    cap = torch.clamp(torch.where(up, m['cap_scale'] * cap, cap),
                      max=m['final_cap'])
    v = v * (~uphill)
    return x, v, a, dt, alpha, n_pos, cap

  def _stepper(self, state, prev, dt_cap):
    """A function advancing `state` (a list, updated in place) by one
    step: the captured graph's replay on a card, else the eager step."""
    if not (self.graphs and state[0].is_cuda):
      def eager():
        state[:] = self._step(tuple(state), prev, dt_cap)
      return eager
    static = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      for _ in range(2):
        self._step(tuple(static), prev, dt_cap)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
      new = self._step(tuple(static), prev, dt_cap)
      for dst, src in zip(static, new):
        dst.copy_(src)
    state[:] = static
    return graph.replay

  def relax(self, x, prev):
    """[2, G, G] start and targets -> ([2, G, G] relaxed, steps)."""
    m = self.m
    f32 = dict(dtype=torch.float32, device=x.device)
    pad = (1, 1, 1, 1)
    xp = torch.nn.functional.pad(x.to(torch.float32), pad, value=float('nan'))
    pp = torch.nn.functional.pad(prev.to(torch.float32), pad,
                                 value=float('nan'))
    cap = torch.tensor(m['start_cap'], **f32)
    state = [xp, torch.zeros_like(xp), self._accel(xp, pp, cap),
             torch.tensor(m['dt'], **f32), torch.tensor(self.alpha0, **f32),
             torch.tensor(0, dtype=torch.int32, device=x.device), cap]
    dt_cap = torch.tensor(m['dt_max'] * m['dt'], **f32)
    step = self._stepper(state, pp, dt_cap)
    max_chunks = min(int(math.ceil(m['max_iters'] / m['num_iters'])),
                     MAX_HISTORY)
    chunk, streak = 0, 0
    while streak < 2 and chunk < max_chunks:
      for _ in range(m['num_iters']):
        step()
      v = state[1]
      v_max = float(torch.sqrt(torch.max(v[0] * v[0] + v[1] * v[1])))
      cap_f = float(state[6])
      done = v_max < m['stop_v_max']
      streak = streak + 1 if done and cap_f >= m['final_cap'] else 0
      if done and cap_f < m['final_cap']:
        state[6].copy_(torch.clamp(state[6] * m['cap_scale'],
                                   max=m['final_cap']))
      chunk += 1
    return state[0][:, 1:-1, 1:-1].clone(), chunk * m['num_iters']


def solve(flow_full, mesh_prev, m: dict):
  """One section's solve: targets = mesh_prev o flow (NaN where the flow
  is), start = targets with mesh_prev in the holes -> (mesh, steps)."""
  s = float(m['stride'][0])
  target = compose(flow_full, mesh_prev, s)
  x0 = torch.where(torch.isnan(target), mesh_prev, target)
  return Fire(m).relax(x0, target)
