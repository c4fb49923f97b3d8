"""Plain render of one section through its inverted map, and the
static-envelope `overflow` flag.

A frozen plain version of the stack path's render layer. The node map
is upsampled bilinearly to every pixel (extrapolated linearly past the
last node), and each output pixel is, by the configuration's `method`,
either the nearest source pixel (offset d = position - pixel, tap
floor(d) + 1 where frac(d) >= 0.5, else floor(d); outside the image 0)
or a normalized Lanczos4 sum over the 8 x 8 source taps around its
source position (taps outside the image read 0 and still count in the
norm; weights from range-reduced sines).
`overflow`: per output tile of 128 x 256 pixels, the hull of the
node displacements (nodes extended linearly to cover the tile) minus
the tile's rounded, clamped midpoint must stay inside +-`residual`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE = (128, 256)
ROWS = 256  # output rows rendered at a time
_PI = math.pi
_COS8 = np.cos(np.pi * np.arange(8) / 4.0).astype(np.float32)
_SIN8 = np.sin(np.pi * np.arange(8) / 4.0).astype(np.float32)


def upsample(values, scale, out_shape):
  """[c, my, mx] node values at spacing `scale` -> [c, oy, ox] per pixel."""
  oy, ox = out_shape
  values = values.to(torch.float32)

  def extend(v, axis, needed):
    n = v.shape[axis]
    hi = needed - n + 1
    if hi <= 0:
      return v
    last = v.narrow(axis, n - 1, 1)
    grad = last - v.narrow(axis, n - 2, 1)
    return torch.cat([v] + [last + (k + 1) * grad for k in range(hi)],
                     dim=axis)

  v = extend(values, 1, (oy - 1) // scale + 1)
  v = extend(v, 2, (ox - 1) // scale + 1)
  dev = values.device
  r0 = torch.repeat_interleave(v, scale, dim=1)[:, :oy]
  r1 = torch.repeat_interleave(v[:, 1:], scale, dim=1)[:, :oy]
  fy = (torch.arange(oy, dtype=torch.float32, device=dev) % scale
        / scale)[None, :, None]
  a = (1.0 - fy) * r0 + fy * r1
  c0 = torch.repeat_interleave(a, scale, dim=2)[:, :, :ox]
  c1 = torch.repeat_interleave(a[:, :, 1:], scale, dim=2)[:, :, :ox]
  fx = (torch.arange(ox, dtype=torch.float32, device=dev) % scale
        / scale)[None, None, :]
  return (1.0 - fx) * c0 + fx * c1


def _lanczos_weight_fn(d):
  """s -> K(d - s) for integer tensors s, K the Lanczos4 kernel."""
  k_int = torch.round(d)
  parity = 1.0 - 2.0 * torch.remainder(k_int, 2.0)
  sin_pd = parity * torch.sin(_PI * (d - k_int))
  d8 = d - 8.0 * torch.round(d / 8.0)
  sin_pd4 = torch.sin(_PI * d8 / 4.0)
  cos_pd4 = torch.cos(_PI * d8 / 4.0)
  cos8 = torch.as_tensor(_COS8, device=d.device)
  sin8 = torch.as_tensor(_SIN8, device=d.device)

  def weight(s):
    t = d - s.to(torch.float32)
    m = torch.remainder(s, 8)
    sign = 1.0 - 2.0 * torch.remainder(s, 2).to(torch.float32)
    sin_pt4 = sin_pd4 * cos8[m] - cos_pd4 * sin8[m]
    x2 = torch.clamp((_PI * t) * (_PI * t), min=1e-12)
    w = torch.where(torch.abs(t) < 1e-6, torch.ones_like(t),
                    4.0 * sign * sin_pd * sin_pt4 / x2)
    return torch.where(torch.abs(t) < 4.0, w, torch.zeros_like(w))

  return weight


def lanczos(image, coords):
  """[h, w] image sampled at [2, oy, ox] (y, x) positions -> [oy, ox]."""
  h, w = image.shape
  oy, ox = coords.shape[1:]
  dev = image.device
  img = image.to(torch.float32).reshape(-1)
  out = torch.empty((oy, ox), dtype=torch.float32, device=dev)
  xs = torch.arange(ox, device=dev, dtype=torch.float32)
  xi = xs.to(torch.int64)[None, :]
  for r0 in range(0, oy, ROWS):
    r1 = min(oy, r0 + ROWS)
    ys = torch.arange(r0, r1, device=dev, dtype=torch.float32)[:, None]
    dy = coords[0, r0:r1].to(torch.float32) - ys
    dx = coords[1, r0:r1].to(torch.float32) - xs[None, :]
    ok = (torch.abs(dy) < 1e8) & (torch.abs(dx) < 1e8)
    dy = torch.where(ok, dy, torch.zeros_like(dy))
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    wfy, wfx = _lanczos_weight_fn(dy), _lanczos_weight_fn(dx)
    sy0 = torch.floor(dy).to(torch.int64) - 3
    sx0 = torch.floor(dx).to(torch.int64) - 3
    yi = ys.to(torch.int64)
    wx = [wfx(sx0 + j) for j in range(8)]
    norm_x = torch.zeros_like(dx)
    for j in range(8):
      norm_x = norm_x + wx[j]
    acc = torch.zeros_like(dx)
    norm_y = torch.zeros_like(dy)
    for i in range(8):
      s = sy0 + i
      wy = wfy(s)
      norm_y = norm_y + wy
      row = yi + s
      row_ok = (row >= 0) & (row < h)
      inner = torch.zeros_like(dx)
      for j in range(8):
        col = xi + sx0 + j
        inb = row_ok & (col >= 0) & (col < w)
        lin = torch.where(inb, row * w + col, torch.zeros_like(col))
        v = torch.where(inb, img[lin], torch.zeros_like(dx))
        inner = inner + wx[j] * v
      acc = acc + wy * inner
    acc = acc / torch.clamp(norm_y * norm_x, min=1e-12)
    out[r0:r1] = torch.where(ok, acc, torch.zeros_like(acc))
  return out


def nearest(image, coords):
  """[h, w] image at [2, oy, ox] (y, x) positions, nearest tap -> [oy, ox]."""
  h, w = image.shape
  oy, ox = coords.shape[1:]
  dev = image.device
  img = image.to(torch.float32).reshape(-1)
  out = torch.empty((oy, ox), dtype=torch.float32, device=dev)
  xs = torch.arange(ox, device=dev, dtype=torch.float32)
  for r0 in range(0, oy, ROWS):
    r1 = min(oy, r0 + ROWS)
    ys = torch.arange(r0, r1, device=dev, dtype=torch.float32)[:, None]
    taps = []
    for pos, at in ((coords[0, r0:r1], ys), (coords[1, r0:r1], xs[None, :])):
      d = pos.to(torch.float32) - at
      ok = torch.abs(d) < 1e8
      d = torch.where(ok, d, torch.zeros_like(d))
      fl = torch.floor(d)
      taps.append((ok, at.to(torch.int64) + fl.to(torch.int64)
                   + (d - fl >= 0.5).to(torch.int64)))
    (oky, row), (okx, col) = taps
    inb = oky & okx & (row >= 0) & (row < h) & (col >= 0) & (col < w)
    lin = torch.where(inb, row * w + col, torch.zeros_like(col))
    out[r0:r1] = torch.where(inb, img[lin], torch.zeros_like(lin,
                                                           dtype=torch.float32))
  return out


def render(image, coords, method):
  """The configuration's render: `nearest` or `lanczos`."""
  if method == 'nearest':
    return nearest(image, coords)
  if method == 'lanczos':
    return lanczos(image, coords)
  raise ValueError(f'the reference renders no {method!r}')


def _nanmin(x, dim):
  out = torch.where(torch.isnan(x), torch.full_like(x, float('inf')),
                    x).amin(dim)
  return torch.where(torch.isnan(x).all(dim), torch.nan, out)


def _nanmax(x, dim):
  out = torch.where(torch.isnan(x), torch.full_like(x, float('-inf')),
                    x).amax(dim)
  return torch.where(torch.isnan(x).all(dim), torch.nan, out)


def overflow(disp_y, disp_x, stride, n, residual, max_displacement,
             pad=1.0):
  """The static-envelope flag of one render: [G, G] node displacements
  (pixels) on nodes at j * stride, an n x n output."""
  node = np.arange(disp_y.shape[-1], dtype=np.float64) * stride
  ty, tx = TILE
  nty, ntx = -(-n // ty), -(-n // tx)
  ext = 2
  for pos in (node, node):
    s0 = max(abs(float(pos[1] - pos[0])), 1e-9)
    s1 = max(abs(float(pos[-1] - pos[-2])), 1e-9)
    ext = max(ext, int(np.ceil(max(0.0, float(pos[0])) / s0)),
              int(np.ceil(max(0.0, (n - 1) - float(pos[-1])) / s1)))

  def extend_d(d, axis):
    k = d.shape[axis]
    first, second = d.narrow(axis, 0, 1), d.narrow(axis, 1, 1)
    last, prev = d.narrow(axis, k - 1, 1), d.narrow(axis, k - 2, 1)
    lo = [first + (i + 1) * (first - second) for i in range(ext)][::-1]
    hi = [last + (i + 1) * (last - prev) for i in range(ext)]
    return torch.cat(lo + [d] + hi, dim=axis)

  s0, s1 = node[1] - node[0], node[-1] - node[-2]
  pos = np.concatenate([[node[0] - (i + 1) * s0 for i in range(ext)][::-1],
                        node, [node[-1] + (i + 1) * s1 for i in range(ext)]])

  def windows(n_tiles, t):
    m = len(pos)
    lo_hi = []
    for i in range(n_tiles):
      a, b = i * t, (i + 1) * t
      i0 = np.searchsorted(pos, a, side='right') - 1
      i1 = np.searchsorted(pos, b - 1, side='left')
      lo_hi.append((max(i0 - 1, 0), min(i1 + 1, m - 1)))
    width = max(i1 - i0 + 1 for i0, i1 in lo_hi)
    return np.stack([np.minimum(i0 + np.arange(width), i1)
                     for i0, i1 in lo_hi])

  dev = disp_y.device
  idx_y = torch.as_tensor(windows(nty, ty), device=dev)
  idx_x = torch.as_tensor(windows(ntx, tx), device=dev)
  md = -(-max_displacement // 64) * 64
  result = torch.zeros((), dtype=torch.bool, device=dev)
  for d in (disp_y, disp_x):
    d = extend_d(extend_d(d[None].to(torch.float32), 1), 2)
    rows = d[:, idx_y, :]
    rmin, rmax = _nanmin(rows, 2), _nanmax(rows, 2)
    tmin = _nanmin(rmin[:, :, idx_x], 3)
    tmax = _nanmax(rmax[:, :, idx_x], 3)
    mid = torch.round((tmin + tmax) * 0.5)
    valid = torch.isfinite(mid)
    base = torch.clamp(torch.where(valid, mid, torch.zeros_like(mid)), -md, md)
    lo = torch.floor(tmin - base - pad)
    hi = torch.ceil(tmax - base + pad)
    result = result | torch.any(valid & ((lo < -residual) | (hi > residual)))
  return result
