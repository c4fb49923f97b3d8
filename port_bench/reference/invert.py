"""Plain inversion of a solved mesh and the filling of its holes.

A frozen plain version of the stack path's invert layer. The absolute
map F(p) = p + d(p), d sampled bilinearly from the mesh, is inverted at
every node position q: a damped fixed point p <- p + 0.6 (q - F(p)),
then, where its residual stays above 1e-2 stride, damped Newton steps
from p = q with the sampled Jacobian (2x2 Cramer solve, determinant
gate 0.005, steps clamped to 8 strides). An iterate further than
`shift_bound` nodes from its query, or a positive-weight tap outside
the grid or on a NaN node, gives NaN. Holes are then filled: harmonic
(multigrid with Jacobi smoothing) inside the rectilinear span hull of
the valid nodes, nearest valid node (jump flooding) outside it.
"""

from __future__ import annotations

import itertools

import torch

_BIG = 1e12


def _sample_linear_clamped(img, qy, qx):
  """Bilinear samples of [..., n0, n1] images at per-image index planes
  [..., oy, ox], indices clamped to the edge, NaN coordinates -> NaN."""
  n0, n1 = img.shape[-2:]
  lead = img.shape[:-2]
  nan_q = torch.isnan(qy) | torch.isnan(qx)
  qy, qx = torch.nan_to_num(qy), torch.nan_to_num(qx)
  by, bx = torch.floor(qy), torch.floor(qx)
  fy, fx = qy - by, qx - bx
  by, bx = by.to(torch.int64), bx.to(torch.int64)
  flat = img.reshape(*lead, -1)
  out = None
  for oy, wy in ((0, 1.0 - fy), (1, fy)):
    for ox, wx in ((0, 1.0 - fx), (1, fx)):
      w = wy * wx
      lin = (by + oy).clamp(0, n0 - 1) * n1 + (bx + ox).clamp(0, n1 - 1)
      g = torch.gather(flat, -1, lin.reshape(*lead, -1)).reshape(w.shape)
      term = w * g
      term = torch.where(w == 0.0, torch.zeros_like(term), term)
      out = term if out is None else out + term
  return torch.where(nan_q, torch.full_like(out, float('nan')), out)


def invert(abs_map, query, stride, fp_iters, newton_iters, shift_bound,
           tol=1e-2):
  """Inverse of absolute maps [..., 2, G, G] (x, y) given at the node
  positions `query` [2, G, G] -> [..., 2, G, G] absolute source
  positions, NaN where the inversion failed."""
  dev = abs_map.device
  lead = abs_map.shape[:-3]
  g0, g1 = abs_map.shape[-2:]
  s = float(stride)
  query = query.expand(*lead, 2, g0, g1)
  d_xy = abs_map.to(torch.float32) - query
  bnd = int(shift_bound)
  pad = bnd + 3
  d_pad = torch.nn.functional.pad(d_xy, (pad, pad, pad, pad),
                                  value=float('nan'))
  ioy = torch.arange(g0, dtype=torch.float32, device=dev)[:, None]
  iox = torch.arange(g1, dtype=torch.float32, device=dev)[None, :]
  iyo = torch.arange(g0, device=dev)[:, None] + pad
  ixo = torch.arange(g1, device=dev)[None, :] + pad
  pw = d_pad.shape[-1]
  d_flat = d_pad.flatten(-2)

  def sample_d(p_xy):
    dy_ = p_xy[..., 1, :, :] / s - ioy
    dx_ = p_xy[..., 0, :, :] / s - iox
    bad = (~(torch.abs(dy_) <= bnd + 1)) | (~(torch.abs(dx_) <= bnd + 1))
    dy_ = torch.where(bad, torch.zeros_like(dy_), dy_)
    dx_ = torch.where(bad, torch.zeros_like(dx_), dx_)
    ty0 = torch.floor(dy_)
    tx0 = torch.floor(dx_)
    acc = torch.zeros(*lead, 2, g0, g1, dtype=torch.float32, device=dev)
    for ty in (ty0, ty0 + 1.0):
      wy = torch.clamp(1.0 - torch.abs(dy_ - ty), min=0.0)
      for tx in (tx0, tx0 + 1.0):
        wgt = wy * torch.clamp(1.0 - torch.abs(dx_ - tx), min=0.0)
        lin = (iyo + ty.to(torch.int64)) * pw + (ixo + tx.to(torch.int64))
        lin = lin.flatten(-2).unsqueeze(-2).expand(*lead, 2, g0 * g1)
        vals = torch.gather(d_flat, -1, lin).unflatten(-1, (g0, g1))
        keep = (wgt > 0.0).unsqueeze(-3)
        acc = acc + torch.where(keep, wgt.unsqueeze(-3) * vals,
                                torch.zeros_like(vals))
    return torch.where(bad.unsqueeze(-3), torch.full_like(acc, float('nan')),
                       acc)

  def residual_ok(p_cur):
    resid = torch.abs(p_cur + sample_d(p_cur) - query)
    return torch.all(resid <= tol * s, dim=-3)

  p = query
  for _ in range(fp_iters):
    p = p + 0.6 * (query - (p + sample_d(p)))
  nan = torch.full_like(p, float('nan'))
  if newton_iters <= 0:
    return torch.where(residual_ok(p).unsqueeze(-3), p, nan)
  gyx = [torch.gradient(d_xy[..., c, :, :], dim=(-2, -1)) for c in range(2)]
  jac = [gyx[0][1] / s, gyx[0][0] / s, gyx[1][1] / s, gyx[1][0] / s]
  ok0 = residual_ok(p)
  failed = ok0.logical_not() | torch.isnan(p[..., 0, :, :]) | torch.isnan(
      p[..., 1, :, :])
  p_n = torch.where(failed.unsqueeze(-3), query, p)
  for _ in range(newton_iters):
    r = query - (p_n + sample_d(p_n))
    r0, r1 = r[..., 0, :, :], r[..., 1, :, :]
    qy, qx = p_n[..., 1, :, :] / s, p_n[..., 0, :, :] / s
    a, b, c_, e = (_sample_linear_clamped(j, qy, qx) for j in jac)
    det = (1.0 + a) * (1.0 + e) - b * c_
    safe = torch.abs(det) > 0.005
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det,
                                                  torch.ones_like(det)),
                          torch.zeros_like(det))
    dx = ((1.0 + e) * r0 - b * r1) * inv_det
    dy = (-c_ * r0 + (1.0 + a) * r1) * inv_det
    step = torch.where(safe.unsqueeze(-3), torch.stack([dx, dy], dim=-3),
                       0.6 * r)
    step = torch.clamp(step, -8.0 * s, 8.0 * s)
    p_n = p_n + step
  ok_n = residual_ok(p_n)
  p = torch.where(ok0.unsqueeze(-3), p,
                  torch.where(ok_n.unsqueeze(-3), p_n, nan))
  return torch.where((ok0 | ok_n).unsqueeze(-3), p, nan)


def _shift(arr, offsets, fill):
  """Shifts the last len(offsets) axes by `offsets`, filling what empties."""
  k = len(offsets)
  for i, off in enumerate(offsets):
    if off == 0:
      continue
    axis = arr.ndim - k + i
    n = arr.shape[axis]
    shape = list(arr.shape)
    shape[axis] = min(abs(off), n)
    pad = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    if abs(off) >= n:
      arr = pad
    elif off > 0:
      arr = torch.cat([pad, arr.narrow(axis, 0, n - off)], dim=axis)
    else:
      arr = torch.cat([arr.narrow(axis, -off, n + off), pad], dim=axis)
  return arr


def _nearest_fill(values, valid):
  """Invalid entries of [..., c, n0, n1] from the nearest valid node
  (jump flooding); a field with no valid node stays as it is."""
  spatial = valid.shape[-2:]
  dev = values.device
  coords = torch.stack(torch.meshgrid(
      *[torch.arange(n, dtype=torch.float32, device=dev) for n in spatial],
      indexing='ij'))
  big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
  seed = torch.where(valid.unsqueeze(-3), coords, big)
  s = 1
  while s < max(spatial):
    s *= 2
  steps = []
  while s >= 1:
    steps.append(s)
    s //= 2

  def dist2(cand):
    d2 = ((cand - coords) ** 2).sum(dim=-3)
    return torch.where(torch.any(cand >= big, dim=-3), big, d2)

  for step in steps:
    best = seed
    best_d2 = dist2(best)
    for offs in itertools.product((-step, 0, step), repeat=2):
      if not any(offs):
        continue
      cand = _shift(seed, offs, _BIG)
      d2 = dist2(cand)
      better = d2 < best_d2
      best = torch.where(better.unsqueeze(-3), cand, best)
      best_d2 = torch.where(better, d2, best_d2)
    seed = best
  has_seed = torch.all(seed < big, dim=-3)
  iy = torch.clamp(seed.select(-3, 0).to(torch.int64), 0, spatial[0] - 1)
  ix = torch.clamp(seed.select(-3, 1).to(torch.int64), 0, spatial[1] - 1)
  lin = (iy * spatial[1] + ix).flatten(-2).unsqueeze(-2)
  lin = lin.expand(*values.shape[:-2], lin.shape[-1])
  near = torch.gather(values.flatten(-2), -1, lin).reshape(values.shape)
  out = torch.where(valid.unsqueeze(-3), values, near)
  return torch.where(has_seed.unsqueeze(-3), out, values)


def _span_hull(valid):
  hull = torch.ones_like(valid)
  v = valid.to(torch.int32)
  for axis in (-2, -1):
    fwd = torch.cumsum(v, dim=axis) > 0
    bwd = torch.flip(torch.cumsum(torch.flip(v, [axis]), dim=axis) > 0,
                     [axis])
    hull = hull & fwd & bwd
  return hull


def _downsample2(values, weight):
  v = values * weight.unsqueeze(-3)
  w = weight
  for axis in (-2, -1):
    if v.shape[axis] % 2 == 1:
      v = torch.cat([v, torch.zeros_like(v.narrow(axis, 0, 1))], dim=axis)
      w = torch.cat([w, torch.zeros_like(w.narrow(axis, 0, 1))], dim=axis)
    v = v.unflatten(axis, (-1, 2)).sum(dim=axis)
    w = w.unflatten(axis, (-1, 2)).sum(dim=axis)
  return v / torch.clamp(w, min=1e-12).unsqueeze(-3), w


def _upsample2(values, target_shape):
  dev = values.device
  coords = torch.meshgrid(
      *[(torch.arange(n, dtype=torch.float32, device=dev) - 0.5) / 2.0
        for n in target_shape], indexing='ij')
  src = values.shape[-2:]
  base, frac, step = [], [], []
  for a in range(2):
    b = torch.clamp(torch.floor(coords[a]).to(torch.int64), 0, src[a] - 2)
    if src[a] == 1:
      b = torch.zeros_like(b)
    base.append(b)
    frac.append(torch.clamp(coords[a] - b.to(torch.float32), 0.0, 1.0))
    step.append(min(1, src[a] - 1))
  out = torch.zeros(values.shape[:-2] + tuple(target_shape),
                    dtype=torch.float32, device=dev)
  for corner in range(4):
    idx = []
    w = torch.ones(tuple(target_shape), dtype=torch.float32, device=dev)
    for a in range(2):
      hi = bool(corner & (1 << a))
      idx.append(base[a] + (step[a] if hi else 0))
      w = w * (frac[a] if hi else (1.0 - frac[a]))
    out = out + w * values[(Ellipsis, *idx)]
  return out


def _jacobi(values, orig, valid, iters):
  ones = torch.ones(valid.shape[-2:], dtype=torch.float32,
                    device=values.device)
  offsets = [(-1, 0), (1, 0), (0, -1), (0, 1)]
  not_edge = [1.0 - _shift(ones, o, 0.0) for o in offsets]
  keep = valid.unsqueeze(-3)
  v = values
  for _ in range(iters):
    acc = torch.zeros_like(v)
    for o, ne in zip(offsets, not_edge):
      acc = acc + (_shift(v, o, 0.0) + ne * v)
    v = torch.where(keep, orig, acc / len(offsets))
  return v


def _harmonic_fill(values, valid, jacobi_iters=16):
  orig = torch.where(valid.unsqueeze(-3), values,
                     torch.zeros_like(values)).to(torch.float32)
  levels = [(orig, valid.to(torch.float32))]
  while max(levels[-1][1].shape[-2:]) > 2:
    v, w = _downsample2(*levels[-1])
    levels.append((v, torch.clamp(w, max=1.0)))
  v, w = levels[-1]
  wsum = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1e-12)
  mean = torch.sum(v * w.unsqueeze(-3), dim=(-2, -1)) / wsum.unsqueeze(-1)
  filled = torch.where(w.unsqueeze(-3) > 0, v, mean[..., None, None])
  for v, w in reversed(levels[:-1]):
    filled = _upsample2(filled, v.shape[-2:])
    lv_valid = w > 0
    filled = torch.where(lv_valid.unsqueeze(-3), v, filled)
    filled = _jacobi(filled, v, lv_valid, jacobi_iters)
  return filled


def fill(values, valid):
  """Holes of [..., 2, G, G] filled harmonically inside the span hull of
  `valid`, by the nearest valid node outside it."""
  filled = _harmonic_fill(values, valid)
  hull = _span_hull(valid)
  nan = torch.full_like(filled, float('nan'))
  out = torch.where(hull.unsqueeze(-3), filled, nan)
  out = torch.where(valid.unsqueeze(-3), values, out)
  out = _nearest_fill(torch.where(hull.unsqueeze(-3), out, nan), hull | valid)
  any_valid = torch.any(valid.flatten(-2), dim=-1)
  return torch.where(any_valid[..., None, None, None], out, values)


def invert_and_fill(solved, stride, fp_iters, newton_iters, max_displacement):
  """Solved meshes [..., 2, G, G] -> (rel_inv, inv_abs) [..., 2, G, G]:
  the filled relative inverse and the absolute source positions."""
  g0, g1 = solved.shape[-2:]
  dev = solved.device
  node = torch.arange(g0, dtype=torch.float32, device=dev) * stride
  query = torch.stack([node[None, :].expand(g0, g1),
                       node[:, None].expand(g0, g1)])
  inv_abs = invert(solved + query, query, stride, fp_iters, newton_iters,
                   -(-max_displacement // stride) + 1)
  rel_inv = inv_abs - query
  valid = torch.isfinite(rel_inv).all(dim=-3)
  rel_inv = fill(rel_inv, valid)
  return rel_inv, rel_inv + query
