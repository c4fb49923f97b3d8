"""Dense interpolation on small grids (subset).

Twin of sofima_tpu/ops/interp.py. Ported: `sample` for the linear method
(the coordinate-map algebra in map_utils uses it), `grid_sample_linear`
and `upsample_map_linear`. Plain PyTorch: these run on small node grids
or are simple streaming passes, with no kernel of their own.
"""

from __future__ import annotations

import torch


def sample(image: torch.Tensor, coords: torch.Tensor, method: str = 'linear',
           mode: str = 'constant', cval: float = float('nan')) -> torch.Tensor:
  """Samples 2d images [..., h, w] at fractional (y, x) coords
  [..., 2, *out] (the leading batch dimensions of both match).

  Linear only. mode 'constant': out-of-bounds taps read `cval`; mode
  'nearest': indices clamp to the edge. Zero-weight taps never poison
  the output, and NaN coordinates always give NaN.
  """
  if method != 'linear':
    raise NotImplementedError('only linear sampling is ported')
  lead = image.shape[:-2]
  if coords.shape[:len(lead)] != lead or coords.shape[len(lead)] != 2:
    raise ValueError('[..., h, w] images and [..., 2, ...] coords expected')
  image = image.to(torch.float32)
  coords = coords.to(torch.float32)
  nan_coords = torch.isnan(coords).any(dim=len(lead))
  coords = torch.nan_to_num(coords)
  base = torch.floor(coords)
  frac = (coords - base).unbind(dim=len(lead))
  base = base.to(torch.int64).unbind(dim=len(lead))
  h, w = image.shape[-2:]
  out = torch.zeros(nan_coords.shape, dtype=torch.float32,
                    device=image.device)
  flat = image.reshape(*lead, h * w)

  def gather(lin):
    return torch.gather(flat, -1, lin.reshape(*lead, -1)).reshape(lin.shape)

  for off0, w0 in ((0, 1.0 - frac[0]), (1, frac[0])):
    r = base[0] + off0
    for off1, w1 in ((0, 1.0 - frac[1]), (1, frac[1])):
      c = base[1] + off1
      weight = w0 * w1
      g = gather(r.clamp(0, h - 1) * w + c.clamp(0, w - 1))
      if mode == 'constant':
        oob = (r < 0) | (r >= h) | (c < 0) | (c >= w)
        g = torch.where(oob, torch.full_like(g, cval), g)
      contrib = weight * g
      out = out + torch.where(weight == 0.0, torch.zeros_like(contrib),
                              contrib)
  return torch.where(nan_coords, torch.full_like(out, float('nan')), out)


def grid_sample_linear(values: torch.Tensor, coords: torch.Tensor,
                       extrapolate: bool = True) -> torch.Tensor:
  """Bilinear sampling of a 2d grid with linear edge-cell extrapolation.

  Args:
    values: [d0, d1] grid values
    coords: [2, *out] query coordinates in grid index space
    extrapolate: if False, out-of-range queries clamp to the edge value

  Returns:
    [*out] sampled values
  """
  values = values.to(torch.float32)
  coords = coords.to(torch.float32)
  shape = values.shape
  if not extrapolate:
    coords = torch.stack([torch.clamp(coords[a], 0.0, shape[a] - 1.0)
                          for a in range(2)])
  base = [torch.clamp(torch.floor(coords[a]).to(torch.int64), 0,
                      shape[a] - 2) for a in range(2)]
  frac = [coords[a] - base[a].to(torch.float32) for a in range(2)]
  out = torch.zeros(coords.shape[1:], dtype=torch.float32,
                    device=values.device)
  for corner in range(4):
    idx = []
    wgt = torch.ones(coords.shape[1:], dtype=torch.float32,
                     device=values.device)
    for axis in range(2):
      if corner & (1 << axis):
        idx.append(base[axis] + 1)
        wgt = wgt * frac[axis]
      else:
        idx.append(base[axis])
        wgt = wgt * (1.0 - frac[axis])
    out = out + wgt * values[idx[0], idx[1]]
  return out


def upsample_map_linear(values: torch.Tensor, scale: int,
                        phase: tuple[int, int],
                        out_shape: tuple[int, int]) -> torch.Tensor:
  """Dense bilinear upsampling of a regular grid by an integer factor.

  Output pixel p samples grid coordinate (p + phase) / scale, with linear
  extrapolation past the last node (same as `grid_sample_linear`).

  Args:
    values: [c, my, mx] grid values
    scale: grid spacing in output pixels
    phase: (py, px) non-negative integer offsets
    out_shape: (oy, ox)

  Returns:
    [c, oy, ox] densified field
  """
  oy, ox = out_shape
  py, px = phase
  if py < 0 or px < 0:
    raise ValueError('phases must be non-negative (shift the output box)')
  values = values.to(torch.float32)

  def extend(v, axis, needed):
    n = v.shape[axis]
    hi = needed - n + 1  # +1: the interpolation uses base and base+1
    if hi <= 0:
      return v
    last = v.narrow(axis, n - 1, 1)
    grad = last - v.narrow(axis, n - 2, 1)
    return torch.cat([v] + [last + (k + 1) * grad for k in range(hi)],
                     dim=axis)

  v = extend(values, 1, (oy - 1 + py) // scale + 1)
  v = extend(v, 2, (ox - 1 + px) // scale + 1)
  dev = values.device
  r0 = torch.repeat_interleave(v, scale, dim=1)[:, py:py + oy]
  r1 = torch.repeat_interleave(v[:, 1:], scale, dim=1)[:, py:py + oy]
  fy = ((torch.arange(oy, dtype=torch.float32, device=dev) + py) % scale
        / scale)[None, :, None]
  a = (1.0 - fy) * r0 + fy * r1
  c0 = torch.repeat_interleave(a, scale, dim=2)[:, :, px:px + ox]
  c1 = torch.repeat_interleave(a[:, :, 1:], scale, dim=2)[:, :, px:px + ox]
  fx = ((torch.arange(ox, dtype=torch.float32, device=dev) + px) % scale
        / scale)[None, None, :]
  return (1.0 - fx) * c0 + fx * c1
