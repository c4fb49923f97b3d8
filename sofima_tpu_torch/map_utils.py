"""Coordinate-map algebra of the alignment and stitching paths (subset).

Twin of sofima_tpu/map_utils.py. Ported: `compose_maps_fast` (2d, and 3d
with a batched form that the stitching solver evaluates every step) and
`_invert_section` (2d with the `shift_bound` sampling contract the
stack pipeline uses; 3d on the general path, with the 3x3 adjugate
Newton rescue, which the 3d stitch render uses). Maps are
[2|3, z, y, x] relative offsets, channels (x, y[, z]), NaN where
invalid. Plain PyTorch: these run on node grids (~250^2 at 10k^2
sections, ~40^3 per stitched tile).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sofima_tpu_torch.ops import interp


def _as_vec(value, dim: int) -> tuple[float, ...]:
  if isinstance(value, (int, float)):
    return (float(value),) * dim
  value = tuple(float(v) for v in value)
  assert len(value) == dim, f'Dimension mismatch: {value=} vs {dim=}'
  return value


def compose_maps_fast(map1: torch.Tensor, start1: Sequence[float], stride1,
                      map2: torch.Tensor, start2: Sequence[float], stride2,
                      mode: str = 'nearest') -> torch.Tensor:
  """Composes two coordinate maps: result = map2 o map1.

  NaN entries of either map propagate (they are not interpolated).

  Args:
    map1/map2: [2|3, z, y, x] relative maps
    start1/start2: [z]yx origins (node units)
    stride1/stride2: node spacing, scalar or [z]yx
    mode: 'nearest' (edge clamp) or 'constant' (outside -> NaN)

  Returns:
    [2|3, z, y, x] composed map over map1's grid
  """
  if map1.shape[0] != map2.shape[0]:
    raise ValueError('maps of different dimension')
  if map1.shape[0] == 3:
    plan = ComposePlan3d(map1[None], [start1], stride1, map2.shape[1:],
                         [start2], stride2, mode)
    return plan.apply(map2[None])[0]
  stride1 = _as_vec(stride1, 2)
  stride2 = _as_vec(stride2, 2)
  map1 = map1.to(torch.float32)
  map2 = map2.to(torch.float32)
  start1 = [float(v) for v in start1][-2:]
  start2 = [float(v) for v in start2][-2:]
  dev = map1.device

  def ref_grid(m, start, stride):
    ranges = [torch.arange(m.shape[-2 + i], dtype=torch.float32, device=dev)
              + start[i] for i in range(2)]
    ref = torch.meshgrid(*ranges, indexing='ij')
    return [a * b for a, b in zip(ref, stride)]  # physical (y, x)

  ref1 = ref_grid(map1, start1, stride1)
  ref2 = ref_grid(map2, start2, stride2)
  out = []
  for z in range(map1.shape[1]):
    m1, m2 = map1[:, z], map2[:, z]
    q = torch.stack([(ref1[1 - c] + m1[c]) / stride2[1 - c] - start2[1 - c]
                     for c in reversed(range(2))])
    sec = []
    for c in range(2):
      absolute = m2[c] + ref2[1 - c]
      vals = interp.sample(absolute, q, method='linear', mode=mode)
      sec.append(vals - ref1[1 - c])
    out.append(torch.stack(sec))
  return torch.stack(out, dim=1)


class ComposePlan3d:
  """Batched 3d `compose_maps_fast` with the sampling taps computed once.

  map2 o map1 for P pairs at once: map1 [P, 3, z, y, x] (channels x, y,
  z) with per-pair origins start1 [P] x (z, y, x); map2 grids of spatial
  shape `shape2` with origins start2. The sampling positions depend on
  map1 only, so `apply(map2)` (called every solver step when map2 is a
  mesh being relaxed) is a fixed gather of the 8 linear taps.
  """

  def __init__(self, map1: torch.Tensor, start1, stride1, shape2,
               start2, stride2, mode: str = 'nearest'):
    dim = 3
    stride1 = _as_vec(stride1, dim)
    self.stride2 = _as_vec(stride2, dim)
    map1 = map1.to(torch.float32)
    dev = map1.device
    self.ref1 = self._ref_grid(map1.shape[2:], start1, stride1, dev)
    self.ref2 = self._ref_grid(shape2, start2, self.stride2, dev)
    q = torch.stack([
        (self.ref1[dim - 1 - c] + map1[:, c]) / self.stride2[dim - 1 - c]
        - self._starts(start2, dev)[dim - 1 - c]
        for c in reversed(range(dim))], dim=1)  # [P, zyx, *grid1]
    self.taps, self.nan = interp.linear_taps(q, tuple(shape2), mode, lead=1)

  @staticmethod
  def _starts(starts, dev):
    """[P] x (z, y, x) origins -> three [P, 1, 1, 1] float32 columns."""
    s = torch.as_tensor(np.asarray([[float(v) for v in st][-3:]
                                    for st in starts], np.float32),
                        device=dev)
    return [s[:, a].reshape(-1, 1, 1, 1) for a in range(3)]

  def _ref_grid(self, shape, starts, stride, dev):
    """Physical node coordinates (z, y, x), each [P, *shape]-broadcastable."""
    st = self._starts(starts, dev)
    ref = []
    for a in range(3):
      view = [1, 1, 1]
      view[a] = shape[a]
      r = torch.arange(shape[a], dtype=torch.float32, device=dev).reshape(
          1, *view)
      ref.append((r + st[a]) * stride[a])
    return ref

  def apply(self, map2: torch.Tensor) -> torch.Tensor:
    """[P, 3, *shape2] relative maps -> [P, 3, *grid1] composed maps."""
    dim = 3
    absolute = torch.stack([map2[:, c].to(torch.float32)
                            + self.ref2[dim - 1 - c] for c in range(dim)],
                           dim=1)
    vals = interp.apply_taps(absolute.flatten(2), self.taps, self.nan,
                             float('nan'), lead=1)
    return torch.stack([vals[:, c] - self.ref1[dim - 1 - c]
                        for c in range(dim)], dim=1)


def _invert_general_3d(abs_map_xy, src_start_yx, query_xy, stride_yx,
                       num_iters, tol, newton_iters):
  """The reference's general (gather-sampled) inversion path, in 3d."""
  dim = 3
  dev = abs_map_xy.device
  abs_map_xy = abs_map_xy.to(torch.float32)
  query_xy = query_xy.to(torch.float32)
  src = [float(v) for v in src_start_yx]
  strd = [float(v) for v in stride_yx]
  grid = torch.meshgrid(*[torch.arange(n, dtype=torch.float32, device=dev)
                          for n in abs_map_xy.shape[1:]], indexing='ij')
  d_xy = torch.stack([abs_map_xy[c] - (grid[dim - 1 - c] + src[dim - 1 - c])
                      * strd[dim - 1 - c] for c in range(dim)])

  def to_idx(p_xy):
    return torch.stack([p_xy[dim - 1 - a] / strd[a] - src[a]
                        for a in range(dim)])

  def sample_d(p_xy):
    return interp.sample_channels(d_xy, to_idx(p_xy), 'linear', 'constant')

  p = query_xy
  for _ in range(num_iters):
    p = p + 0.6 * (query_xy - (p + sample_d(p)))
  max_stride = max(strd)

  def residual_ok(p_cur):
    resid = torch.abs(p_cur + sample_d(p_cur) - query_xy)
    return torch.all(resid <= tol * max_stride, dim=0)

  nan = torch.full_like(p, float('nan'))
  if newton_iters <= 0:
    ok = residual_ok(p)
    return torch.where(ok[None], p, nan)
  # Sampled 3x3 Jacobian J = I + M, M[c][j] = d(d_c)/d(axis_j) in
  # pixel/pixel units (c, j in xyz order; array axes are zyx).
  grads = [torch.gradient(d_xy[c]) for c in range(dim)]  # d/dz, d/dy, d/dx
  jac_planes = torch.stack([grads[c][2 - j] / strd[2 - j]
                            for c in range(dim) for j in range(dim)])
  ok0 = residual_ok(p)
  bad0 = ~ok0 | torch.isnan(p).any(dim=0)
  p_n = torch.where(bad0[None], query_xy, p)
  for _ in range(newton_iters):
    r = query_xy - (p_n + sample_d(p_n))
    m = interp.sample_channels(jac_planes, to_idx(p_n), 'linear', 'nearest')
    j00, j01, j02 = 1.0 + m[0], m[1], m[2]
    j10, j11, j12 = m[3], 1.0 + m[4], m[5]
    j20, j21, j22 = m[6], m[7], 1.0 + m[8]
    c00 = j11 * j22 - j12 * j21
    c01 = j12 * j20 - j10 * j22
    c02 = j10 * j21 - j11 * j20
    c10 = j02 * j21 - j01 * j22
    c11 = j00 * j22 - j02 * j20
    c12 = j01 * j20 - j00 * j21
    c20 = j01 * j12 - j02 * j11
    c21 = j02 * j10 - j00 * j12
    c22 = j00 * j11 - j01 * j10
    det = j00 * c00 + j01 * c01 + j02 * c02
    safe = torch.abs(det) > 3e-4
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det,
                                                  torch.ones_like(det)),
                          torch.zeros_like(det))
    s0 = (c00 * r[0] + c10 * r[1] + c20 * r[2]) * inv_det
    s1 = (c01 * r[0] + c11 * r[1] + c21 * r[2]) * inv_det
    s2 = (c02 * r[0] + c12 * r[1] + c22 * r[2]) * inv_det
    step = torch.where(safe[None], torch.stack([s0, s1, s2]), 0.6 * r)
    step = torch.clamp(step, -8.0 * max_stride, 8.0 * max_stride)
    p_n = p_n + step
  ok_n = residual_ok(p_n)
  p = torch.where(ok0[None], p, torch.where(ok_n[None], p_n, nan))
  ok = ok0 | ok_n
  return torch.where(ok[None], p, nan)


def _invert_section(abs_map_xy: torch.Tensor, src_start_yx: torch.Tensor,
                    query_xy: torch.Tensor, stride_yx: torch.Tensor,
                    num_iters: int = 32, tol: float = 1e-2,
                    newton_iters: int = 8, shift_bound: int | None = None,
                    shift_origin: tuple[int, int] = (0, 0)) -> torch.Tensor:
  """Fixed-point + Newton inversion of 2d or 3d absolute maps.

  Solves F(p) = q for p, with F(p) = p + d(p) and d the relative offset
  field sampled (bi/tri)linearly from the map grid: damped fixed point
  p <- p + 0.6 (q - F(p)), then failed queries are re-seeded at q and
  refined with damped Newton steps (sampled Jacobian; 2x2 Cramer solve
  with det gate 0.005, or 3x3 adjugate solve with det gate 3e-4; trust
  region 8 strides). Queries whose residual stays above tol * stride
  give NaN. 2d maps take the `shift_bound` contract, and leading
  dimensions of `abs_map_xy` are then a batch of sections (the
  reference vmaps this function over sections); 3d maps ([3, z, y, x],
  no `shift_bound`) take the general gather-sampled path.

  Args:
    abs_map_xy: [..., 2, gy, gx] or [3, gz, gy, gx] absolute maps
      (channels x, y[, z])
    src_start_yx: [2|3] grid origin ([z]yx, node units)
    query_xy: [2|3, ...] or [..., 2, oy, ox] query points in physical
      units (channels x, y[, z])
    stride_yx: [2|3] node spacing ([z]yx)
    num_iters: fixed-point iterations
    tol: residual tolerance in units of stride
    newton_iters: Newton refinement iterations (0 disables)
    shift_bound: the pipeline's sampling contract: queries form a
      unit-spaced grid at `shift_origin` in map-index space and iterates
      stay within `shift_bound` nodes of their own query (further ->
      NaN); any positive-weight tap outside the grid or on a NaN node
      gives NaN
    shift_origin: integer origin of the query grid in map-index space

  Returns:
    source positions shaped like `query_xy` (absolute), NaN where the
    inversion failed.
  """
  if shift_bound is None:
    if abs_map_xy.ndim != 4 or abs_map_xy.shape[0] != 3:
      raise NotImplementedError('the general path is ported for [3, z, y, '
                                'x] maps; 2d maps take shift_bound')
    return _invert_general_3d(abs_map_xy, src_start_yx, query_xy,
                              stride_yx, num_iters, tol, newton_iters)
  if abs_map_xy.shape[-3] != 2:
    raise ValueError('shift_bound is the 2d sampling contract')
  dev = abs_map_xy.device
  abs_map_xy = abs_map_xy.to(torch.float32)
  lead = abs_map_xy.shape[:-3]
  query_xy = query_xy.to(torch.float32).expand(*lead, *query_xy.shape[-3:])
  src = [float(v) for v in src_start_yx]
  strd = [float(v) for v in stride_yx]
  g0, g1 = abs_map_xy.shape[-2:]
  grid_yx = torch.meshgrid(torch.arange(g0, dtype=torch.float32, device=dev),
                           torch.arange(g1, dtype=torch.float32, device=dev),
                           indexing='ij')
  d_xy = torch.stack([abs_map_xy[..., c, :, :] - (grid_yx[1 - c] + src[1 - c])
                      * strd[1 - c] for c in range(2)], dim=-3)

  def to_idx(p_xy):
    return torch.stack([p_xy[..., 1 - a, :, :] / strd[a] - src[a]
                        for a in range(2)], dim=-3)

  bnd = int(shift_bound)
  org_y, org_x = int(shift_origin[0]), int(shift_origin[1])
  oy_n, ox_n = query_xy.shape[-2:]
  pad_y0 = bnd + 3 + max(0, -org_y)
  pad_y1 = bnd + 3 + max(0, org_y + oy_n - g0)
  pad_x0 = bnd + 3 + max(0, -org_x)
  pad_x1 = bnd + 3 + max(0, org_x + ox_n - g1)
  d_pad = torch.nn.functional.pad(d_xy, (pad_x0, pad_x1, pad_y0, pad_y1),
                                  value=float('nan'))
  ioy = torch.arange(oy_n, dtype=torch.float32, device=dev)[:, None]
  iox = torch.arange(ox_n, dtype=torch.float32, device=dev)[None, :]
  iyo = torch.arange(oy_n, device=dev)[:, None] + pad_y0 + org_y
  ixo = torch.arange(ox_n, device=dev)[None, :] + pad_x0 + org_x
  pw = d_pad.shape[-1]
  d_flat = d_pad.flatten(-2)  # [..., 2, H * W]

  def sample_d(p_xy):
    idx = to_idx(p_xy)
    dy_ = idx[..., 0, :, :] - ioy - org_y
    dx_ = idx[..., 1, :, :] - iox - org_x
    bad = (~(torch.abs(dy_) <= bnd + 1)) | (~(torch.abs(dx_) <= bnd + 1))
    dy_ = torch.where(bad, torch.zeros_like(dy_), dy_)
    dx_ = torch.where(bad, torch.zeros_like(dx_), dx_)
    ty0 = torch.floor(dy_)
    tx0 = torch.floor(dx_)
    acc = torch.zeros(*lead, 2, oy_n, ox_n, dtype=torch.float32, device=dev)
    for ty in (ty0, ty0 + 1.0):
      wy = torch.clamp(1.0 - torch.abs(dy_ - ty), min=0.0)
      for tx in (tx0, tx0 + 1.0):
        wgt = wy * torch.clamp(1.0 - torch.abs(dx_ - tx), min=0.0)
        lin = (iyo + ty.to(torch.int64)) * pw + (ixo + tx.to(torch.int64))
        lin = lin.flatten(-2).unsqueeze(-2).expand(*lead, 2, oy_n * ox_n)
        vals = torch.gather(d_flat, -1, lin).unflatten(-1, (oy_n, ox_n))
        keep = (wgt > 0.0).unsqueeze(-3)
        acc = acc + torch.where(keep, wgt.unsqueeze(-3) * vals,
                                torch.zeros_like(vals))
    return torch.where(bad.unsqueeze(-3), torch.full_like(acc, float('nan')),
                       acc)

  p = query_xy
  for _ in range(num_iters):
    p = p + 0.6 * (query_xy - (p + sample_d(p)))
  max_stride = max(strd)

  def residual_ok(p_cur):
    resid = torch.abs(p_cur + sample_d(p_cur) - query_xy)
    return torch.all(resid <= tol * max_stride, dim=-3)

  nan = torch.full_like(p, float('nan'))
  if newton_iters > 0:
    # Sampled Jacobian planes (pixel/pixel): d(dx)/dx, d(dx)/dy,
    # d(dy)/dx, d(dy)/dy.
    gyx = [torch.gradient(d_xy[..., c, :, :], dim=(-2, -1))
           for c in range(2)]
    jac_planes = [gyx[0][1] / strd[1], gyx[0][0] / strd[0],
                  gyx[1][1] / strd[1], gyx[1][0] / strd[0]]
    ok0 = residual_ok(p)
    failed = ~ok0 | torch.isnan(p[..., 0, :, :]) | torch.isnan(p[..., 1, :, :])
    p_n = torch.where(failed.unsqueeze(-3), query_xy, p)
    for _ in range(newton_iters):
      r = query_xy - (p_n + sample_d(p_n))
      r0, r1 = r[..., 0, :, :], r[..., 1, :, :]
      idx = to_idx(p_n)
      a, b, c_, e = (interp.sample(j, idx, method='linear', mode='nearest')
                     for j in jac_planes)
      det = (1.0 + a) * (1.0 + e) - b * c_
      safe = torch.abs(det) > 0.005
      inv_det = torch.where(safe, 1.0 / torch.where(safe, det,
                                                    torch.ones_like(det)),
                            torch.zeros_like(det))
      dx = ((1.0 + e) * r0 - b * r1) * inv_det
      dy = (-c_ * r0 + (1.0 + a) * r1) * inv_det
      step = torch.where(safe.unsqueeze(-3), torch.stack([dx, dy], dim=-3),
                         0.6 * r)
      step = torch.clamp(step, -8.0 * max_stride, 8.0 * max_stride)
      p_n = p_n + step
    ok_n = residual_ok(p_n)
    p = torch.where(ok0.unsqueeze(-3), p,
                    torch.where(ok_n.unsqueeze(-3), p_n, nan))
    ok = ok0 | ok_n
  else:
    ok = residual_ok(p)
  return torch.where(ok.unsqueeze(-3), p, nan)
