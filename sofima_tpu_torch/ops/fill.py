"""Hole filling and nearest-valid extrapolation of 2d node fields (subset).

Twin of sofima_tpu/ops/fill.py. Ported: `fill_invalid` and what it calls
(`harmonic_fill`, `nearest_fill`, `_jacobi`, `_downsample2`,
`_upsample2`, `span_hull`), 2d only. Plain PyTorch: the fields are
section meshes (~250^2 nodes at 10k^2 sections).

Fields are [..., c, y, x] with masks [..., y, x]: leading dimensions are
a batch (the reference vmaps over sections; here the batch is written
out), and every section is filled independently.
"""

from __future__ import annotations

import torch

_BIG = 1e12


def _shift(arr: torch.Tensor, oy: int, ox: int, fill) -> torch.Tensor:
  """Shifts the last two axes by (oy, ox), filling the vacated area."""
  for axis, off in ((-2, oy), (-1, ox)):
    if off == 0:
      continue
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


def _gather_yx(values: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
  """values[..., c, iy, ix] with per-batch index planes iy, ix [..., y, x]."""
  w = values.shape[-1]
  lin = (iy * w + ix).flatten(-2).unsqueeze(-2)
  lin = lin.expand(*values.shape[:-2], lin.shape[-1])
  out = torch.gather(values.flatten(-2), -1, lin)
  return out.reshape(*values.shape[:-2], *iy.shape[-2:])


def nearest_fill(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
  """Fills invalid entries of [..., c, y, x] from the nearest valid node.

  Jump flooding over log2(n) passes; a section with no valid node is
  returned unchanged.
  """
  ny, nx = valid.shape[-2:]
  dev = values.device
  coords = torch.stack(torch.meshgrid(
      torch.arange(ny, dtype=torch.float32, device=dev),
      torch.arange(nx, dtype=torch.float32, device=dev), indexing='ij'))
  big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
  seed = torch.where(valid.unsqueeze(-3), coords, big)

  s = 1
  while s < max(ny, nx):
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
    for oy in (-step, 0, step):
      for ox in (-step, 0, step):
        if oy == 0 and ox == 0:
          continue
        cand = _shift(seed, oy, ox, _BIG)
        d2 = dist2(cand)
        better = d2 < best_d2
        best = torch.where(better.unsqueeze(-3), cand, best)
        best_d2 = torch.where(better, d2, best_d2)
    seed = best

  has_seed = torch.all(seed < big, dim=-3)
  iy = torch.clamp(seed[..., 0, :, :].to(torch.int64), 0, ny - 1)
  ix = torch.clamp(seed[..., 1, :, :].to(torch.int64), 0, nx - 1)
  out = torch.where(valid.unsqueeze(-3), values, _gather_yx(values, iy, ix))
  return torch.where(has_seed.unsqueeze(-3), out, values)


def span_hull(valid: torch.Tensor) -> torch.Tensor:
  """Rectilinear span hull: points between valid samples along y and x."""
  hull = torch.ones_like(valid)
  v = valid.to(torch.int32)
  for axis in (-2, -1):
    fwd = torch.cumsum(v, dim=axis) > 0
    bwd = torch.flip(torch.cumsum(torch.flip(v, [axis]), dim=axis) > 0,
                     [axis])
    hull = hull & fwd & bwd
  return hull


def _downsample2(values: torch.Tensor, weight: torch.Tensor):
  """2x valid-weighted average downsampling along both spatial axes."""
  v = values * weight.unsqueeze(-3)
  w = weight

  def pair_sum(t, axis):  # t[..., 0::2, ...] + t[..., 1::2, ...]
    return t.unflatten(axis, (-1, 2)).sum(dim=axis)

  for axis in (-2, -1):
    if v.shape[axis] % 2 == 1:  # pad to even with zero weight
      v = torch.cat([v, torch.zeros_like(v.narrow(axis, 0, 1))], dim=axis)
      w = torch.cat([w, torch.zeros_like(w.narrow(axis, 0, 1))], dim=axis)
    v = pair_sum(v, axis)
    w = pair_sum(w, axis)
  return v / torch.clamp(w, min=1e-12).unsqueeze(-3), w


def _upsample2(values: torch.Tensor, target_shape) -> torch.Tensor:
  """Linear 2x upsampling of [..., c, y, x] to spatial `target_shape`."""
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
    out = out + w * values[..., idx[0], idx[1]]
  return out


def _jacobi(values: torch.Tensor, orig: torch.Tensor, valid: torch.Tensor,
            iters: int) -> torch.Tensor:
  """Jacobi relaxation of the Laplace equation on invalid nodes."""
  ones = torch.ones(valid.shape[-2:], dtype=torch.float32,
                    device=values.device)
  offsets = ((-1, 0), (1, 0), (0, -1), (0, 1))
  not_edge = [1.0 - _shift(ones, oy, ox, 0.0) for oy, ox in offsets]
  keep = valid.unsqueeze(-3)
  v = values
  for _ in range(iters):
    acc = torch.zeros_like(v)
    for (oy, ox), ne in zip(offsets, not_edge):
      acc = acc + (_shift(v, oy, ox, 0.0) + ne * v)
    v = torch.where(keep, orig, acc / len(offsets))
  return v


def harmonic_fill(values: torch.Tensor, valid: torch.Tensor,
                  jacobi_iters: int = 16) -> torch.Tensor:
  """Multigrid harmonic interpolation of invalid entries of [..., c, y, x]."""
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


def fill_invalid(values: torch.Tensor, valid: torch.Tensor,
                 extrapolate: bool = False,
                 jacobi_iters: int = 16) -> torch.Tensor:
  """Interpolates holes (span hull) and optionally extrapolates outside."""
  filled = harmonic_fill(values, valid, jacobi_iters=jacobi_iters)
  hull = span_hull(valid)
  nan = torch.full_like(filled, float('nan'))
  out = torch.where(hull.unsqueeze(-3), filled, nan)
  out = torch.where(valid.unsqueeze(-3), values, out)
  if extrapolate:
    out = nearest_fill(torch.where(hull.unsqueeze(-3), out, nan),
                       hull | valid)
  any_valid = torch.any(valid.flatten(-2), dim=-1)[..., None, None, None]
  return torch.where(any_valid, out, values)
