"""Coordinate-map algebra of the alignment and stitching paths.

Twin of sofima_tpu/map_utils.py. Maps are [2|3, z, y, x] relative
offsets, channels (x, y[, z]), NaN where invalid, with a node `stride`
and an optional anchoring BoundingBox. Ported:
  * `compose_maps_fast` (2d, and 3d with a batched form that the
    stitching solver evaluates every step) and `_invert_section` (2d
    with the `shift_bound` sampling contract the stack pipeline uses;
    the general gather-sampled path in 2d and 3d, with the 2x2 / 3x3
    Newton rescue);
  * the library API on host arrays (numpy in, numpy out, as the
    reference): `to_absolute`, `to_relative`, `fill_missing`,
    `outer_box`, `inner_box`, `invert_map` (its divergence counters in
    `invert_stats`, and the float64 option), `resample_map`,
    `compose_maps`, `mask_irregular` and `make_affine_map`. Their device
    work (fills, inversion, sampling) runs on `device` (default: the
    CUDA card; pass device='cpu' without one).
Plain PyTorch: these run on node grids (~250^2 at 10k^2 sections, ~40^3
per stitched tile).
"""

from __future__ import annotations

import collections
import logging
from typing import Sequence

import numpy as np
import torch

from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import cuda_invert
from sofima_tpu_torch.ops import fill as fill_ops
from sofima_tpu_torch.ops import interp
from sofima_tpu_torch.utils.bounding_box import BoundingBox


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
    self.taps, self.nan = interp.method_taps(q, tuple(shape2), 'linear', mode,
                                             lead=1)

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


def _invert_general(abs_map_xy, src_start_yx, query_xy, stride_yx,
                    num_iters, tol, newton_iters):
  """The reference's general (gather-sampled) inversion, 2d or 3d.

  Returns (source positions, ok): `ok` is False where the residual
  stays above tol * stride (those positions are NaN).
  """
  dim = abs_map_xy.shape[0]
  dev = abs_map_xy.device
  ftype = interp.float_type(abs_map_xy)
  abs_map_xy = abs_map_xy.to(ftype)
  query_xy = query_xy.to(ftype)
  src = [float(v) for v in src_start_yx]
  strd = [float(v) for v in stride_yx]
  grid = torch.meshgrid(*[torch.arange(n, dtype=ftype, device=dev)
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
    return torch.where(ok[None], p, nan), ok
  # Sampled Jacobian J = I + M, M[c][j] = d(d_c)/d(axis_j) in pixel/pixel
  # units (c, j in xy[z] order; array axes are [z]yx).
  grads = [torch.gradient(d_xy[c]) for c in range(dim)]
  jac_planes = torch.stack([grads[c][dim - 1 - j] / strd[dim - 1 - j]
                            for c in range(dim) for j in range(dim)])
  ok0 = residual_ok(p)
  bad0 = ~ok0 | torch.isnan(p).any(dim=0)
  p_n = torch.where(bad0[None], query_xy, p)

  def inv_det_of(det, gate):
    safe = torch.abs(det) > gate
    return safe, torch.where(safe, 1.0 / torch.where(
        safe, det, torch.ones_like(det)), torch.zeros_like(det))

  for _ in range(newton_iters):
    r = query_xy - (p_n + sample_d(p_n))
    m = interp.sample_channels(jac_planes, to_idx(p_n), 'linear', 'nearest')
    if dim == 2:
      a, b, c_, e = m[0], m[1], m[2], m[3]
      safe, inv_det = inv_det_of((1.0 + a) * (1.0 + e) - b * c_, 0.005)
      steps = [((1.0 + e) * r[0] - b * r[1]) * inv_det,
               (-c_ * r[0] + (1.0 + a) * r[1]) * inv_det]
    else:
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
      safe, inv_det = inv_det_of(j00 * c00 + j01 * c01 + j02 * c02, 3e-4)
      steps = [(c00 * r[0] + c10 * r[1] + c20 * r[2]) * inv_det,
               (c01 * r[0] + c11 * r[1] + c21 * r[2]) * inv_det,
               (c02 * r[0] + c12 * r[1] + c22 * r[2]) * inv_det]
    step = torch.where(safe[None], torch.stack(steps), 0.6 * r)
    step = torch.clamp(step, -8.0 * max_stride, 8.0 * max_stride)
    p_n = p_n + step
  ok_n = residual_ok(p_n)
  p = torch.where(ok0[None], p, torch.where(ok_n[None], p_n, nan))
  ok = ok0 | ok_n
  return torch.where(ok[None], p, nan), ok


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
  give NaN. Without `shift_bound`, one [2, y, x] or [3, z, y, x] map
  takes the general gather-sampled path (float64 maps stay float64).
  2d maps with the `shift_bound` contract may carry leading batch
  dimensions (the reference vmaps this function over sections); on the
  card they take one kernel (ops/cuda_invert.invert_section).

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
    if abs_map_xy.ndim != abs_map_xy.shape[0] + 1:
      raise ValueError('the general path takes one [2, y, x] or [3, z, y, '
                       'x] map')
    return _invert_general(abs_map_xy, src_start_yx, query_xy, stride_yx,
                           num_iters, tol, newton_iters)[0]
  if abs_map_xy.shape[-3] != 2:
    raise ValueError('shift_bound is the 2d sampling contract')
  invert = (cuda_invert.invert_section if abs_map_xy.is_cuda
            else _invert_section_plain)
  return invert(abs_map_xy, src_start_yx, query_xy, stride_yx, num_iters,
                tol, newton_iters, shift_bound, shift_origin)


def _invert_section_plain(abs_map_xy: torch.Tensor, src_start_yx,
                          query_xy: torch.Tensor, stride_yx, num_iters: int,
                          tol: float, newton_iters: int, shift_bound: int,
                          shift_origin=(0, 0)) -> torch.Tensor:
  """`_invert_section` of 2d maps under `shift_bound` in plain torch: what
  CPU tensors run, and what ops/cuda_invert.invert_section is held to."""
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
      a, b, c_, e = (interp.sample_batched(j, idx, method='linear',
                                           mode='nearest')
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


def _identity_map_absolute(coord_shape, stride) -> list[np.ndarray]:
  """Identity map in absolute form: [z -> z sz,] y -> y sy, x -> x sx."""
  stride = _as_vec(stride, len(coord_shape))
  return [hx * step for hx, step in zip(
      np.mgrid[[np.s_[:s] for s in coord_shape]], stride)]


def _check_box(coord_map, box, dim):
  if not np.all(coord_map.shape[-dim:][::-1] == box.size[:dim]):
    raise ValueError(
        f'box size {box.size} mismatch with map shape {coord_map.shape}')


def to_absolute(coord_map, stride, box: BoundingBox | None = None
                ) -> np.ndarray:
  """Relative (offsets) -> absolute (target positions), a new array."""
  coord_map = np.array(placement.to_host(coord_map))
  dim = coord_map.shape[0]
  stride = _as_vec(stride, dim)
  off_zyx = _identity_map_absolute(coord_map.shape[-dim:], stride)
  if box is not None:
    _check_box(coord_map, box, dim)
    off_zyx = [o + start * step for o, step, start in zip(
        off_zyx, stride, box.start[:dim][::-1])]
  for i in range(dim):
    coord_map[i, ...] += off_zyx[-(i + 1)]
  return coord_map


def to_relative(coord_map, stride, box: BoundingBox | None = None
                ) -> np.ndarray:
  """Absolute (target positions) -> relative (offsets), a new array."""
  coord_map = np.array(placement.to_host(coord_map))
  dim = coord_map.shape[0]
  stride = _as_vec(stride, dim)
  off_zyx = _identity_map_absolute(coord_map.shape[-dim:], stride)
  if box is not None:
    _check_box(coord_map, box, dim)
    for i in range(dim):
      off_zyx[-(i + 1)] += box.start[i] * stride[-(i + 1)]
  for i in range(dim):
    coord_map[i, ...] -= off_zyx[-(i + 1)]
  return coord_map


def fill_missing(coord_map, *, extrapolate: bool = False,
                 invalid_to_zero: bool = False,
                 interpolate_first: bool = True, device=None) -> np.ndarray:
  """Fills NaN entries of a coordinate map (float32 numpy out).

  Interpolation over the span hull (ops.fill.fill_invalid), then with
  `extrapolate` a nearest-valid fill outside it (or the nearest fill
  alone when not `interpolate_first`). 2d maps are independent per-z
  sections; `invalid_to_zero` resets fully invalid ones to zeros.
  """
  coord_map = np.asarray(placement.to_host(coord_map), dtype=np.float32)
  if not np.any(np.isnan(coord_map)):
    return coord_map.copy()
  dim = coord_map.shape[0]
  # 2d: [z, 2, y, x] sections (a batch); 3d: one [3, z, y, x] field.
  values = placement.place(np.moveaxis(coord_map, 1, 0) if dim == 2
                           else coord_map, device)
  valid = torch.all(torch.isfinite(values), dim=-dim - 1)
  if interpolate_first:
    out = fill_ops.fill_invalid(values, valid, extrapolate=extrapolate,
                                dim=dim)
  elif extrapolate:
    out = fill_ops.nearest_fill(values, valid, dim=dim)
  else:
    out = values
  out = out.cpu().numpy()
  if dim == 2:
    out = np.moveaxis(out, 0, 1)
  out = np.array(out, np.float32)
  if invalid_to_zero:
    if dim == 2:
      out[:, np.all(np.isnan(coord_map), axis=(0, 2, 3))] = 0.0
    elif np.all(np.isnan(coord_map)):
      out[...] = 0.0
  return out


def outer_box(coord_map, box: BoundingBox, stride,
              target_len=None) -> BoundingBox:
  """Bounding box covering all (u, v[, w]) targets of the map."""
  coord_map = placement.to_host(coord_map)
  abs_map = to_absolute(np.asarray(coord_map, np.float64), stride, box)
  extents_xyz = [(np.nanmin(c), np.nanmax(c)) for c in abs_map]
  dim = coord_map.shape[0]
  target_len_xyz = _as_vec(
      target_len if target_len is not None else stride, dim)[::-1]
  start = box.start.copy()
  size = box.size.copy()
  for i, ((x_min, x_max), tl) in enumerate(zip(extents_xyz, target_len_xyz)):
    lo = int(x_min) // int(tl)
    start[i] = lo
    size[i] = -(int(-x_max) // int(tl)) - lo + 1
  return BoundingBox(start, size)


def inner_box(coord_map, box: BoundingBox, stride, device=None
              ) -> BoundingBox:
  """Box of targets guaranteed to be covered by the map's image."""
  dim = coord_map.shape[0]
  assert dim in (2, 3)
  stride = _as_vec(stride, dim)
  int_map = to_absolute(fill_missing(coord_map, extrapolate=True,
                                     device=device), stride, box)
  x0 = np.max(np.min(int_map[0, ...], axis=-1))
  x1 = np.min(np.max(int_map[0, ...], axis=-1))
  y0 = np.max(np.min(int_map[1, ...], axis=-2))
  y1 = np.min(np.max(int_map[1, ...], axis=-2))
  x0 = int(-(-x0 // stride[-1]))
  y0 = int(-(-y0 // stride[-2]))
  x1 = int(x1 // stride[-1])
  y1 = int(y1 // stride[-2])
  if dim == 2:
    return BoundingBox(start=(x0, y0, int(box.start[2])),
                       size=(x1 - x0 + 1, y1 - y0 + 1, int(box.size[2])))
  z0 = np.max(np.min(int_map[2, ...], axis=-3))
  z1 = np.min(np.max(int_map[2, ...], axis=-3))
  z0 = int(-(-z0 // stride[0]))
  z1 = int(z1 // stride[0])
  return BoundingBox(start=(x0, y0, z0),
                     size=(x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1))


# Divergence telemetry of invert_map (the reference's metrics counters
# 'invert_map_sections' and 'invert_map_failed_nodes_permille').
invert_stats: collections.Counter = collections.Counter()


def _record_invert_stats(failed_per_section: np.ndarray) -> None:
  """Counts inverted sections and failed queries; warns above 5%."""
  worst = float(failed_per_section.max()) if failed_per_section.size else 0.0
  invert_stats['invert_map_sections'] += int(failed_per_section.size)
  invert_stats['invert_map_failed_nodes_permille'] += (
      int(round(1000.0 * float(failed_per_section.mean())))
      if failed_per_section.size else 0)
  if worst > 0.05:
    logging.warning(
        'invert_map: %.1f%% of queries failed to invert in the worst '
        'section (folds or out-of-image regions); downstream fill will '
        'interpolate them.', 100.0 * worst)


def invert_map(coord_map, src_box: BoundingBox, dst_box: BoundingBox, stride,
               dtype=np.float32, device=None) -> np.ndarray:
  """Inverts an (x, y[, z]) -> (u, v[, w]) map over `dst_box`.

  The map's holes are first filled by interpolation (on the relative
  map, in float32), then every dst node is inverted by the general
  `_invert_section` (fixed point + Newton). Coordinates are shifted to
  dst_box.start for precision. With `dtype=np.float64` the inversion
  runs in float64 (on `device`; the reference runs it on its CPU
  backend).
  """
  compute = np.dtype(dtype)
  coord_map = np.asarray(placement.to_host(coord_map), np.float32)
  dim = coord_map.shape[0]
  stride_v = _as_vec(stride, dim)
  src_box = src_box.adjusted_by(start=-dst_box.start, end=-dst_box.start)
  dst_box = dst_box.adjusted_by(start=-dst_box.start, end=-dst_box.start)
  src_start_yx = [float(src_box.start[dim - 1 - i]) for i in range(dim)]
  qgrids = np.mgrid[[np.s_[:int(dst_box.size[dim - 1 - i])]
                     for i in range(dim)]]
  query = np.stack([(qgrids[dim - 1 - c] + dst_box.start[c])
                    * stride_v[dim - 1 - c] for c in range(dim)]
                   ).astype(compute)
  filled = fill_missing(coord_map, extrapolate=False, device=device)
  abs_map = to_absolute(filled.astype(compute), stride_v, src_box)
  ttype = torch.float64 if compute == np.float64 else torch.float32
  query_t = placement.place(query, device, ttype)

  def one(m):
    out, ok = _invert_general(placement.place(m, device, ttype),
                              src_start_yx, query_t, stride_v, 32, 1e-2, 8)
    failed = 1.0 - float(ok.to(torch.float32).mean())
    return out.cpu().numpy(), failed

  if dim == 2:
    res = [one(abs_map[:, z]) for z in range(abs_map.shape[1])]
    _record_invert_stats(np.asarray([f for _, f in res]))
    inv = np.stack([r for r, _ in res], axis=1)
  else:
    inv, failed = one(abs_map)
    _record_invert_stats(np.asarray([failed]))
  return to_relative(inv.astype(compute), stride_v, dst_box).astype(compute)


def resample_map(coord_map, src_box: BoundingBox, dst_box: BoundingBox,
                 src_stride: float, dst_stride: float,
                 method: str = 'linear', device=None) -> np.ndarray:
  """Resamples a 2d coordinate map onto a new node grid / stride.

  Offsets are in pixels and are NOT rescaled; only the node grid
  changes. NaN entries poison the interpolated values touching them, and
  targets outside the source grid are NaN.
  """
  coord_map = np.asarray(placement.to_host(coord_map), np.float32)
  assert coord_map.shape[0] == 2
  tg_y, tg_x = np.mgrid[:int(dst_box.size[1]), :int(dst_box.size[0])]
  src_y = ((tg_y + dst_box.start[1]) * dst_stride) / src_stride - (
      src_box.start[1])
  src_x = ((tg_x + dst_box.start[0]) * dst_stride) / src_stride - (
      src_box.start[0])
  coords = placement.place(np.stack([src_y, src_x]).astype(np.float32),
                           device)
  sections = placement.place(coord_map, device)
  out = torch.stack([interp.sample_channels(sections[:, z], coords, method,
                                            'constant')
                     for z in range(coord_map.shape[1])], dim=1)
  return out.cpu().numpy()


def compose_maps(map1, box1: BoundingBox, stride1: float, map2,
                 box2: BoundingBox, stride2: float, device=None
                 ) -> np.ndarray:
  """Composes two 2d maps (map2 o map1); map2's holes are interpolated
  first, map1's invalid entries stay invalid, targets outside map2's
  grid are NaN."""
  map1 = np.asarray(placement.to_host(map1), np.float32)
  assert map1.shape[0] == 2 and map2.shape[0] == 2
  map2_filled = fill_missing(map2, device=device)
  out = compose_maps_fast(
      placement.place(map1, device),
      [float(box1.start[1]), float(box1.start[0])], float(stride1),
      placement.place(map2_filled, device),
      [float(box2.start[1]), float(box2.start[0])], float(stride2),
      mode='constant')
  return out.cpu().numpy()


def mask_irregular(coord_map: np.ndarray, stride: Sequence[float],
                   frac: float, max_frac: float | None = None,
                   dilation_iters: int = 1) -> np.ndarray:
  """Masks (NaNs, in place) stretched or folded parts of a [2, y, x] map.

  Node spacing of the absolute map below frac * stride or above
  max_frac * stride (default 2 - frac) along either axis is bad; the
  trailing node of each axis gets the neutral pitch; the bad set grows by
  `dilation_iters` 8-neighbour dilations. Returns the mask.
  """
  assert coord_map.ndim == 3 and coord_map.shape[0] == 2
  if max_frac is None:
    max_frac = 2 - frac
  stride_x, stride_y = np.asarray(stride)
  ny, nx = coord_map.shape[1:]
  abs_x = coord_map[0] + np.arange(nx, dtype=np.float32) * stride_x
  abs_y = coord_map[1] + (np.arange(ny, dtype=np.float32)
                          * stride_y)[:, None]
  spacing_x = np.full((ny, nx), stride_x, np.float32)
  spacing_x[:, :-1] = abs_x[:, 1:] - abs_x[:, :-1]
  spacing_y = np.full((ny, nx), stride_y, np.float32)
  spacing_y[:-1, :] = abs_y[1:, :] - abs_y[:-1, :]
  with np.errstate(invalid='ignore'):
    bad = (spacing_x < frac * stride_x) | (spacing_y < frac * stride_y)
    bad |= ((spacing_x > max_frac * stride_x)
            | (spacing_y > max_frac * stride_y))
  for _ in range(dilation_iters):
    grown = bad.copy()
    grown[1:, :] |= bad[:-1, :]
    grown[:-1, :] |= bad[1:, :]
    grown[:, 1:] |= bad[:, :-1]
    grown[:, :-1] |= bad[:, 1:]
    grown[1:, 1:] |= bad[:-1, :-1]
    grown[:-1, :-1] |= bad[1:, 1:]
    grown[1:, :-1] |= bad[:-1, 1:]
    grown[:-1, 1:] |= bad[1:, :-1]
    bad = grown
  coord_map[0, ...][bad] = np.nan
  coord_map[1, ...][bad] = np.nan
  return bad


def make_affine_map(matrix: np.ndarray, box: BoundingBox,
                    stride) -> np.ndarray:
  """Relative coordinate map of an affine transform ([3, 4], xyz rows).

  float64 [3, z, y, x] (x, y, z channels), as the reference's. Channel r
  is sum_c (matrix[r, c] - [r == c]) p_c + matrix[r, 3], with p_c the
  absolute positions along axis c: formed on each axis and broadcast
  over the grid, so that no [3, n] identity map is built and multiplied.
  """
  size_zyx = tuple(int(s) for s in box.size[::-1])
  stride_zyx = _as_vec(stride, 3)
  pos = []  # absolute positions along x, y and z, [z, y, x]-shaped
  for c in range(3):
    view = [1, 1, 1]
    view[2 - c] = size_zyx[2 - c]
    pos.append((np.arange(size_zyx[2 - c]) * stride_zyx[2 - c]
                + box.start[c]).reshape(view))
  out = np.empty((3,) + size_zyx)
  for r in range(3):
    coef = [float(matrix[r, c]) - (r == c) for c in range(3)]
    np.add(coef[0] * pos[0], coef[1] * pos[1], out=out[r])
    out[r] += coef[2] * pos[2] + float(matrix[r, 3])
  return out
