"""Render weights and the device-side render plan (subset).

Twin of sofima_tpu/ops/shift_warp.py. Ported: `_kernel_weight`, `_TAPS`,
`_LEFT`, `make_weight_fn` (with the range-reduced sin(pi d) of sofima_tpu
commit 78165d3) and `tiled_plan_device`, the latter only for what the
render needs: the `overflow` flag and the tile shape. The gather render
kernel (ops.cuda_warp) reaches every tap, so it needs no per-tile bases;
`overflow` still reports where the TPU kernel's static envelope would
have zeroed pixels, so both packages flag the same runs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE_SHAPE = (128, 256)
_TAPS = {'nearest': 1, 'linear': 2, 'cubic': 4, 'lanczos': 8}
# Kernel support radius on each side of the base tap.
_LEFT = {'nearest': 0, 'linear': 0, 'cubic': 1, 'lanczos': 3}

_PI = math.pi


def _kernel_weight(t: torch.Tensor, method: str) -> torch.Tensor:
  """Interpolation kernel K(t) evaluated elementwise (support varies)."""
  if method == 'nearest':
    return ((t >= -0.5) & (t < 0.5)).to(torch.float32)
  if method == 'linear':
    return torch.clamp(1.0 - torch.abs(t), min=0.0)
  if method == 'cubic':
    a = -0.75
    at = torch.abs(t)
    near = (a + 2.0) * (at * at * at) - (a + 3.0) * (at * at) + 1.0
    far = a * (at * at * at) - 5.0 * a * (at * at) + 8.0 * a * at - 4.0 * a
    zero = torch.zeros_like(at)
    return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, zero))
  if method == 'lanczos':
    x = _PI * t
    w = torch.where(
        torch.abs(t) < 1e-6, torch.ones_like(t),
        4.0 * torch.sin(x) * torch.sin(x / 4.0)
        / torch.clamp(x * x, min=1e-12))
    return torch.where(torch.abs(t) < 4.0, w, torch.zeros_like(w))
  raise ValueError(f'Unknown method {method!r}')


def lanczos_planes(d: torch.Tensor):
  """Range-reduced transcendental planes of the factored Lanczos4 weight.

  f32 sin at argument pi*d carries absolute error ~|d| pi eps, which at
  |d| ~ 100 swamps sin(pi t) ~ pi t near integer displacements and blows
  up through 1/(pi t)^2; reducing to the nearest integer and modulo 8
  keeps every argument in [-pi, pi].
  """
  k_int = torch.round(d)
  parity = 1.0 - 2.0 * torch.remainder(k_int, 2.0)
  sin_pd = parity * torch.sin(_PI * (d - k_int))
  d8 = d - 8.0 * torch.round(d / 8.0)
  return sin_pd, torch.sin(_PI * d8 / 4.0), torch.cos(_PI * d8 / 4.0)


# cos(pi m / 4), sin(pi m / 4) for m = s mod 8, float64 rounded to float32.
_COS8 = np.cos(np.pi * np.arange(8) / 4.0).astype(np.float32)
_SIN8 = np.sin(np.pi * np.arange(8) / 4.0).astype(np.float32)


def lanczos_weight(d: torch.Tensor, planes, s: torch.Tensor) -> torch.Tensor:
  """K(d - s) from the hoisted planes; `s` is an integer tensor."""
  sin_pd, sin_pd4, cos_pd4 = planes
  t = d - s.to(torch.float32)
  m = torch.remainder(s, 8)
  c_s = torch.as_tensor(_COS8, device=d.device)[m]
  s_s = torch.as_tensor(_SIN8, device=d.device)[m]
  sign = 1.0 - 2.0 * torch.remainder(s, 2).to(torch.float32)
  sin_pt4 = sin_pd4 * c_s - cos_pd4 * s_s
  x2 = torch.clamp((_PI * t) * (_PI * t), min=1e-12)
  w = torch.where(torch.abs(t) < 1e-6, torch.ones_like(t),
                  4.0 * sign * sin_pd * sin_pt4 / x2)
  return torch.where(torch.abs(t) < 4.0, w, torch.zeros_like(w))


def make_weight_fn(d: torch.Tensor, method: str):
  """Returns s -> K(d - s) with the transcendentals hoisted out of the loop.

  `s` may be a Python int or an integer tensor broadcastable to `d`.
  """
  if method != 'lanczos':
    return lambda s: _kernel_weight(d - s, method)
  planes = lanczos_planes(d)

  def weight(s):
    s = torch.as_tensor(s, device=d.device)
    return lanczos_weight(d, planes, s)

  return weight


def _required_ext(node_out_y, node_out_x, out_shape, min_ext: int = 2) -> int:
  """Linear-extrapolation node count that covers the output box."""
  ext = min_ext
  for pos, extent in ((np.asarray(node_out_y, np.float64), out_shape[0]),
                      (np.asarray(node_out_x, np.float64), out_shape[1])):
    if len(pos) < 2:
      continue
    s0 = max(abs(float(pos[1] - pos[0])), 1e-9)
    s1 = max(abs(float(pos[-1] - pos[-2])), 1e-9)
    over_lo = max(0.0, float(pos[0]) - 0.0) / s0
    over_hi = max(0.0, (extent - 1) - float(pos[-1])) / s1
    ext = max(ext, int(np.ceil(over_lo)), int(np.ceil(over_hi)))
  return ext


def _nanmin(x: torch.Tensor, dim: int) -> torch.Tensor:
  inf = torch.full_like(x, float('inf'))
  out = torch.where(torch.isnan(x), inf, x).amin(dim)
  return torch.where(torch.isnan(x).all(dim), torch.nan, out)


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
  inf = torch.full_like(x, float('-inf'))
  out = torch.where(torch.isnan(x), inf, x).amax(dim)
  return torch.where(torch.isnan(x).all(dim), torch.nan, out)


def tiled_plan_device(disp_y: torch.Tensor, disp_x: torch.Tensor,
                      node_out_y: np.ndarray, node_out_x: np.ndarray,
                      out_shape: tuple[int, int],
                      residual_bounds: tuple[int, int, int, int],
                      base_bounds: tuple[int, int, int, int],
                      tile: tuple[int, int] | None = None,
                      pad: float = 1.0):
  """Per-tile displacement hulls against a static envelope.

  Same contract as sofima_tpu's `tiled_plan_device` for the render: the
  per-tile base is the rounded midpoint of the tile's node-displacement
  hull (clamped into `base_bounds`), and `overflow` is True when any
  finite tile's residual hull leaves `residual_bounds`.

  Args:
    disp_y/disp_x: [z, my, mx] displacement at map nodes
    node_out_y/node_out_x: static node positions in output pixels
    out_shape: (oy, ox) output size
    residual_bounds: (ry_lo, ry_hi, rx_lo, rx_hi) residual envelope
    base_bounds: (by_lo, by_hi, bx_lo, bx_hi) bounds on the bases
    tile: output tile shape (default TILE_SHAPE)
    pad: densification safety margin

  Returns:
    dict with `overflow` (bool tensor) and the static `tile`.
  """
  oy, ox = int(out_shape[0]), int(out_shape[1])
  ty, tx = tile if tile is not None else TILE_SHAPE
  nty = -(-oy // ty)
  ntx = -(-ox // tx)
  ext = _required_ext(node_out_y, node_out_x, out_shape)

  def extend_j(d, axis):
    n = d.shape[axis]
    if n < 2:
      return d
    first = d.narrow(axis, 0, 1)
    second = d.narrow(axis, 1, 1)
    last = d.narrow(axis, n - 1, 1)
    prev = d.narrow(axis, n - 2, 1)
    lo = [first + (k + 1) * (first - second) for k in range(ext)][::-1]
    hi = [last + (k + 1) * (last - prev) for k in range(ext)]
    return torch.cat(lo + [d] + hi, dim=axis)

  def extend_pos(p):
    p = np.asarray(p, np.float64)
    if len(p) < 2:
      return p
    s0 = p[1] - p[0]
    s1 = p[-1] - p[-2]
    lo = [p[0] - (k + 1) * s0 for k in range(ext)][::-1]
    hi = [p[-1] + (k + 1) * s1 for k in range(ext)]
    return np.concatenate([lo, p, hi])

  d_y = extend_j(extend_j(disp_y.to(torch.float32), 1), 2)
  d_x = extend_j(extend_j(disp_x.to(torch.float32), 1), 2)
  pos_y = extend_pos(node_out_y)
  pos_x = extend_pos(node_out_x)

  def windows(node_pos, n_tiles, t):
    m = len(node_pos)
    lo_hi = []
    for i in range(n_tiles):
      a, b = i * t, (i + 1) * t
      i0 = np.searchsorted(node_pos, a, side='right') - 1
      i1 = np.searchsorted(node_pos, b - 1, side='left')
      lo_hi.append((max(i0 - 1, 0), min(i1 + 1, m - 1)))
    width = max(i1 - i0 + 1 for i0, i1 in lo_hi)
    return np.stack([np.minimum(i0 + np.arange(width), i1)
                     for i0, i1 in lo_hi])  # [n_tiles, width]

  idx_y = torch.as_tensor(windows(pos_y, nty, ty), device=d_y.device)
  idx_x = torch.as_tensor(windows(pos_x, ntx, tx), device=d_y.device)

  def pool(d):
    rows = d[:, idx_y, :]                         # [z, nty, wy, mx]
    rmin, rmax = _nanmin(rows, 2), _nanmax(rows, 2)
    cmin = _nanmin(rmin[:, :, idx_x], 3)          # [z, nty, ntx]
    cmax = _nanmax(rmax[:, :, idx_x], 3)
    return cmin, cmax

  def over(tmin, tmax, b_lo, b_hi, r_lo, r_hi):
    mid = torch.round((tmin + tmax) * 0.5)
    valid = torch.isfinite(mid)
    base = torch.clamp(torch.where(valid, mid, torch.zeros_like(mid)),
                       b_lo, b_hi)
    lo = torch.floor(tmin - base - pad)
    hi = torch.ceil(tmax - base + pad)
    return torch.any(valid & ((lo < r_lo) | (hi > r_hi)))

  ry_lo, ry_hi, rx_lo, rx_hi = residual_bounds
  by_lo, by_hi, bx_lo, bx_hi = base_bounds
  ov_y = over(*pool(d_y), by_lo, by_hi, ry_lo, ry_hi)
  ov_x = over(*pool(d_x), bx_lo, bx_hi, rx_lo, rx_hi)
  return dict(overflow=ov_y | ov_x, tile=(ty, tx))
