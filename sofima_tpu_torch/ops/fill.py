"""Hole filling and nearest-valid extrapolation of node fields (subset).

Twin of sofima_tpu/ops/fill.py. Ported: `fill_invalid` and what it calls
(`harmonic_fill`, `nearest_fill`, `_jacobi`, `_downsample2`,
`_upsample2`, `span_hull`), for 2d or 3d spatial grids (`dim`). Plain
PyTorch: the fields are section or tile meshes (~250^2 or ~40^3 nodes).

Fields are [..., c, *spatial] with masks [..., *spatial]: leading
dimensions are a batch (the reference vmaps over sections; here the
batch is written out), and every field is filled independently.
"""

from __future__ import annotations

import itertools

import torch

_BIG = 1e12


def _shift(arr: torch.Tensor, offsets, fill) -> torch.Tensor:
  """Shifts the last len(offsets) axes by `offsets`, filling vacated area."""
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


def _neighbor_offsets(dim: int, step: int):
  """The 3^dim - 1 offsets of a jump-flooding pass, in the reference's
  order (axis 0 outermost)."""
  return [o for o in itertools.product((-step, 0, step), repeat=dim)
          if any(o)]


def _gather(values: torch.Tensor, idx, dim: int) -> torch.Tensor:
  """values[..., c, idx_0, ..., idx_dim-1] with per-batch index planes
  idx_a [..., *spatial]."""
  spatial = values.shape[-dim:]
  lin = idx[0]
  for a in range(1, dim):
    lin = lin * spatial[a] + idx[a]
  lin = lin.flatten(-dim).unsqueeze(-2)
  lin = lin.expand(*values.shape[:-dim], lin.shape[-1])
  out = torch.gather(values.flatten(-dim), -1, lin)
  return out.reshape(*values.shape[:-dim], *idx[0].shape[-dim:])


def nearest_fill(values: torch.Tensor, valid: torch.Tensor,
                 dim: int = 2) -> torch.Tensor:
  """Fills invalid entries of [..., c, *spatial] from the nearest valid node.

  Jump flooding over log2(n) passes; a field with no valid node is
  returned unchanged.
  """
  spatial = valid.shape[-dim:]
  dev = values.device
  coords = torch.stack(torch.meshgrid(
      *[torch.arange(n, dtype=torch.float32, device=dev) for n in spatial],
      indexing='ij'))
  big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
  cdim = -dim - 1
  seed = torch.where(valid.unsqueeze(cdim), coords, big)

  s = 1
  while s < max(spatial):
    s *= 2
  steps = []
  while s >= 1:
    steps.append(s)
    s //= 2

  def dist2(cand):
    d2 = ((cand - coords) ** 2).sum(dim=cdim)
    return torch.where(torch.any(cand >= big, dim=cdim), big, d2)

  for step in steps:
    best = seed
    best_d2 = dist2(best)
    for offs in _neighbor_offsets(dim, step):
      cand = _shift(seed, offs, _BIG)
      d2 = dist2(cand)
      better = d2 < best_d2
      best = torch.where(better.unsqueeze(cdim), cand, best)
      best_d2 = torch.where(better, d2, best_d2)
    seed = best

  has_seed = torch.all(seed < big, dim=cdim)
  idx = [torch.clamp(seed.select(cdim, a).to(torch.int64), 0, spatial[a] - 1)
         for a in range(dim)]
  out = torch.where(valid.unsqueeze(cdim), values, _gather(values, idx, dim))
  return torch.where(has_seed.unsqueeze(cdim), out, values)


def span_hull(valid: torch.Tensor, dim: int = 2) -> torch.Tensor:
  """Rectilinear span hull: points between valid samples along every axis."""
  hull = torch.ones_like(valid)
  v = valid.to(torch.int32)
  for axis in range(-dim, 0):
    fwd = torch.cumsum(v, dim=axis) > 0
    bwd = torch.flip(torch.cumsum(torch.flip(v, [axis]), dim=axis) > 0,
                     [axis])
    hull = hull & fwd & bwd
  return hull


def _downsample2(values: torch.Tensor, weight: torch.Tensor, dim: int):
  """2x valid-weighted average downsampling along all spatial axes."""
  v = values * weight.unsqueeze(-dim - 1)
  w = weight

  def pair_sum(t, axis):  # t[..., 0::2, ...] + t[..., 1::2, ...]
    return t.unflatten(axis, (-1, 2)).sum(dim=axis)

  for axis in range(-dim, 0):
    if v.shape[axis] % 2 == 1:  # pad to even with zero weight
      v = torch.cat([v, torch.zeros_like(v.narrow(axis, 0, 1))], dim=axis)
      w = torch.cat([w, torch.zeros_like(w.narrow(axis, 0, 1))], dim=axis)
    v = pair_sum(v, axis)
    w = pair_sum(w, axis)
  return v / torch.clamp(w, min=1e-12).unsqueeze(-dim - 1), w


def _upsample2(values: torch.Tensor, target_shape) -> torch.Tensor:
  """Linear 2x upsampling of [..., c, *spatial] to spatial `target_shape`."""
  dim = len(target_shape)
  dev = values.device
  coords = torch.meshgrid(
      *[(torch.arange(n, dtype=torch.float32, device=dev) - 0.5) / 2.0
        for n in target_shape], indexing='ij')
  src = values.shape[-dim:]
  base, frac, step = [], [], []
  for a in range(dim):
    b = torch.clamp(torch.floor(coords[a]).to(torch.int64), 0, src[a] - 2)
    if src[a] == 1:
      b = torch.zeros_like(b)
    base.append(b)
    frac.append(torch.clamp(coords[a] - b.to(torch.float32), 0.0, 1.0))
    step.append(min(1, src[a] - 1))
  out = torch.zeros(values.shape[:-dim] + tuple(target_shape),
                    dtype=torch.float32, device=dev)
  for corner in range(2 ** dim):
    idx = []
    w = torch.ones(tuple(target_shape), dtype=torch.float32, device=dev)
    for a in range(dim):
      hi = bool(corner & (1 << a))
      idx.append(base[a] + (step[a] if hi else 0))
      w = w * (frac[a] if hi else (1.0 - frac[a]))
    out = out + w * values[(Ellipsis, *idx)]
  return out


def _jacobi(values: torch.Tensor, orig: torch.Tensor, valid: torch.Tensor,
            iters: int, dim: int) -> torch.Tensor:
  """Jacobi relaxation of the Laplace equation on invalid nodes."""
  ones = torch.ones(valid.shape[-dim:], dtype=torch.float32,
                    device=values.device)
  offsets = []
  for axis in range(dim):
    for off in (-1, 1):
      o = [0] * dim
      o[axis] = off
      offsets.append(tuple(o))
  not_edge = [1.0 - _shift(ones, o, 0.0) for o in offsets]
  keep = valid.unsqueeze(-dim - 1)
  v = values
  for _ in range(iters):
    acc = torch.zeros_like(v)
    for o, ne in zip(offsets, not_edge):
      acc = acc + (_shift(v, o, 0.0) + ne * v)
    v = torch.where(keep, orig, acc / len(offsets))
  return v


def harmonic_fill(values: torch.Tensor, valid: torch.Tensor,
                  jacobi_iters: int = 16, dim: int = 2) -> torch.Tensor:
  """Multigrid harmonic interpolation of invalid entries of
  [..., c, *spatial]."""
  cdim = -dim - 1
  sp_axes = tuple(range(-dim, 0))
  orig = torch.where(valid.unsqueeze(cdim), values,
                     torch.zeros_like(values)).to(torch.float32)
  levels = [(orig, valid.to(torch.float32))]
  while max(levels[-1][1].shape[-dim:]) > 2:
    v, w = _downsample2(*levels[-1], dim)
    levels.append((v, torch.clamp(w, max=1.0)))
  v, w = levels[-1]
  wsum = torch.clamp(torch.sum(w, dim=sp_axes), min=1e-12)
  mean = torch.sum(v * w.unsqueeze(cdim), dim=sp_axes) / wsum.unsqueeze(-1)
  filled = torch.where(w.unsqueeze(cdim) > 0, v,
                       mean[(Ellipsis,) + (None,) * dim])
  for v, w in reversed(levels[:-1]):
    filled = _upsample2(filled, v.shape[-dim:])
    lv_valid = w > 0
    filled = torch.where(lv_valid.unsqueeze(cdim), v, filled)
    filled = _jacobi(filled, v, lv_valid, jacobi_iters, dim)
  return filled


def fill_invalid(values: torch.Tensor, valid: torch.Tensor,
                 extrapolate: bool = False, jacobi_iters: int = 16,
                 dim: int = 2) -> torch.Tensor:
  """Interpolates holes (span hull) and optionally extrapolates outside."""
  cdim = -dim - 1
  filled = harmonic_fill(values, valid, jacobi_iters=jacobi_iters, dim=dim)
  hull = span_hull(valid, dim)
  nan = torch.full_like(filled, float('nan'))
  out = torch.where(hull.unsqueeze(cdim), filled, nan)
  out = torch.where(valid.unsqueeze(cdim), values, out)
  if extrapolate:
    out = nearest_fill(torch.where(hull.unsqueeze(cdim), out, nan),
                       hull | valid, dim)
  any_valid = torch.any(valid.flatten(-dim), dim=-1)
  return torch.where(any_valid[(Ellipsis,) + (None,) * (dim + 1)], out,
                     values)
