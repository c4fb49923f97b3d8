"""Plain dense flow of one section pair: coarse pass, targeted fine pass,
cleaning.

A frozen plain version of the stack path's flow layer, written with
torch.fft and elementwise torch only. For every patch pair (pre at
(i*sy, j*sx), post at the same corner plus the pair's integer offset,
zeros outside the image) the patch means are removed, the circular
cross-correlation irfft2(F(pre) conj(F(post))) is centred at p // 2, and
the two highest local maxima give (x, y, sharpness, ratio); a pair with
no peak above half the surface maximum gives NaN.

Coarse pass: full patches on a grid of step = patch. Its field is
NaN-filled with its median, 3x3-median filtered and clipped to
+-max_displacement. Fine pass: half-size patches at the flow stride,
each block of `rows x group` patches correlating a post window moved by
the rounded coarse flow at the block centre; flow = fine peak - move.
"""

from __future__ import annotations

import numpy as np
import torch

# Patch pairs per FFT batch (bounds the working memory).
CHUNK = 2048


def _patches(img, y0, x0, p):
  """[b, p, p] patches at corners (y0, x0), zero outside the image."""
  h, w = img.shape
  ar = torch.arange(p, device=img.device)
  yy = y0[:, None, None] + ar[None, :, None]
  xx = x0[:, None, None] + ar[None, None, :]
  inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
  lin = torch.where(inb, yy * w + xx, torch.zeros_like(yy))
  vals = img.reshape(-1)[lin]
  return torch.where(inb, vals, torch.zeros_like(vals))


def peaks(img, center, min_distance=2, threshold_rel=0.5, peak_radius=5):
  """Top-2 local maxima of [b, n1, n2] surfaces -> [b, 4] rows of (x, y
  offset from `center`, sharpness, ratio); ratio 0 with one peak, NaN
  rows with none. Sharpness is the peak over the minimum of the
  (2 r + 1)^2 window around it, clamped into the surface."""
  b, n1, n2 = img.shape
  md = min_distance
  pool = torch.nn.functional.max_pool2d
  img_max = pool(img[:, None], 2 * md + 1, stride=1, padding=md)[:, 0]
  thr = threshold_rel * img.amax(dim=(1, 2), keepdim=True)
  cand = (img == img_max) & (img > thr)
  flat = torch.where(cand, img, torch.full_like(img, float('-inf')))
  flat = flat.reshape(b, -1)
  idx1 = torch.argmax(flat, dim=-1)
  val1 = torch.gather(flat, 1, idx1[:, None])[:, 0]
  cols = torch.arange(flat.shape[-1], device=img.device)[None]
  val2 = torch.where(cols == idx1[:, None],
                     torch.full_like(flat, float('-inf')), flat).amax(dim=-1)
  r = peak_radius
  minf = -pool(-img[:, None], 2 * r + 1, stride=1)[:, 0]
  iy, ix = idx1 // n2, idx1 % n2
  wy = torch.clamp(iy - r, 0, n1 - 2 * r - 1)
  wx = torch.clamp(ix - r, 0, n2 - 2 * r - 1)
  wmin = minf[torch.arange(b, device=img.device), wy, wx]
  sharp = val1 / wmin
  ratio = torch.where(torch.isinf(val2), torch.zeros_like(val1), val1 / val2)
  rows = torch.stack([ix.to(torch.float32) - center[1],
                      iy.to(torch.float32) - center[0], sharp, ratio], dim=-1)
  return torch.where(torch.isinf(val1)[:, None],
                     torch.full_like(rows, float('nan')), rows)


def grid_peaks(pre, post, offsets, grid, p, step, crop):
  """Peaks of every patch pair of a grid -> [4, gy, gx].

  `offsets`: None or int [gy, gx, 2] (dy, dx) moves of the post patches;
  `crop`: the peak search keeps the centred [crop, crop] core.
  """
  gy, gx = grid
  sy, sx = step
  n = gy * gx
  dev = pre.device
  lo = p // 2 - crop // 2
  out = []
  for c0 in range(0, n, CHUNK):
    ii = torch.arange(c0, min(n, c0 + CHUNK), device=dev)
    y0, x0 = (ii // gx) * sy, (ii % gx) * sx
    qy0, qx0 = y0, x0
    if offsets is not None:
      off = offsets.reshape(n, 2).to(torch.int64)[ii]
      qy0, qx0 = y0 + off[:, 0], x0 + off[:, 1]
    a = _patches(pre, y0, x0, p)
    b = _patches(post, qy0, qx0, p)
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
    corr = torch.fft.irfft2(torch.fft.rfft2(a) * torch.conj(torch.fft.rfft2(b)),
                            s=(p, p))
    corr = torch.roll(corr, (p // 2, p // 2), dims=(1, 2))
    out.append(peaks(corr[:, lo:lo + crop, lo:lo + crop],
                     (crop // 2, crop // 2)))
  return torch.cat(out).reshape(gy, gx, 4).permute(2, 0, 1).contiguous()


def _nanmedian(c):
  vals = c[~torch.isnan(c)]
  n = vals.numel()
  if n == 0:
    return torch.tensor(float('nan'), device=c.device)
  srt = torch.sort(vals).values
  q = 0.5 * (n - 1)
  lo, hi = int(q // 1), int(-(-q // 1))
  hw = q - lo
  return srt[lo] * (1.0 - hw) + srt[hi] * hw


def _robust(c, max_displacement):
  med = torch.nan_to_num(_nanmedian(c))
  c = torch.where(torch.isfinite(c), c, med)
  n0, n1 = c.shape
  yi = torch.arange(n0, device=c.device)
  xi = torch.arange(n1, device=c.device)
  stacked = torch.stack([
      c[(yi + i - 1).clamp(0, n0 - 1)][:, (xi + j - 1).clamp(0, n1 - 1)]
      for i in range(3) for j in range(3)])
  c = torch.sort(stacked, dim=0).values[4]
  return torch.clamp(c, -max_displacement, max_displacement)


def _bilinear_extrapolated(values, cy, cx):
  """Bilinear samples of a [n0, n1] grid at index coordinates (cy, cx),
  extrapolating linearly from the edge cells."""
  n0, n1 = values.shape
  by = torch.clamp(torch.floor(cy).to(torch.int64), 0, n0 - 2)
  bx = torch.clamp(torch.floor(cx).to(torch.int64), 0, n1 - 2)
  fy = cy - by.to(torch.float32)
  fx = cx - bx.to(torch.float32)
  return ((1.0 - fy) * (1.0 - fx) * values[by, bx]
          + fy * (1.0 - fx) * values[by + 1, bx]
          + (1.0 - fy) * fx * values[by, bx + 1]
          + fy * fx * values[by + 1, bx + 1])


def block_geometry(shape, patch, step, rows):
  """The fine pass's blocks: `rows` patch rows by `group` patch columns
  share one window move; the coarse flow is read at the centre of each
  block's window, whose width is rounded up to 128 columns."""
  h, w = shape
  gy = (h - (patch - step)) // step
  gx = (w - (patch - step)) // step
  unit = 128 // int(np.gcd(int(step), 128))
  group = max(unit, ((8 + unit - 1) // unit) * unit)
  if rows is None:
    rows = 2 if (step + patch) % 8 == 0 and gy >= 2 else 1
  win_c = -(-((group - 1) * step + patch) // 128) * 128
  return dict(gy=gy, gx=gx, group=group, rows=rows,
              ngroups=-(-gx // group), nrsteps=-(-gy // rows),
              win_r=(rows - 1) * step + patch, win_c=win_c)


def coarse_moves(pre, post, patch, stride, max_displacement):
  """The coarse pass and the fine pass's block moves of a pair ->
  (moves int32 [nrsteps, ngroups, 2] (dy, dx), overflow: a move beyond
  `max_displacement`, the fine pass's block geometry)."""
  p, s = patch, stride
  fine = p // 2
  h, w = pre.shape
  pre, post = pre.to(torch.float32), post.to(torch.float32)
  coarse = grid_peaks(pre, post, None, (h // p, w // p), p, (p, p), p)
  cx = _robust(coarse[0], max_displacement)
  cy = _robust(coarse[1], max_displacement)
  c0 = p // 2  # the first coarse patch's centre
  crop_off = (p // 2 - fine // 2) % s
  hc, wc = h - crop_off, w - crop_off
  gy_f = (hc - (fine - s)) // s
  rows = 4 if ((3 * s + fine) % 8 == 0 and gy_f >= 4) else None
  geo = block_geometry((hc, wc), fine, s, rows)
  dev = pre.device
  ctr_y = ((torch.arange(geo['nrsteps'], dtype=torch.float32, device=dev)
            * (geo['rows'] * s) + geo['win_r'] / 2.0 + crop_off - c0) / p)
  ctr_x = ((torch.arange(geo['ngroups'], dtype=torch.float32, device=dev)
            * (geo['group'] * s) + geo['win_c'] / 2.0 + crop_off - c0) / p)
  nr, ng = geo['nrsteps'], geo['ngroups']
  qy = ctr_y[:, None].expand(nr, ng)
  qx = ctr_x[None, :].expand(nr, ng)
  fx_c = _bilinear_extrapolated(cx, qy, qx)
  fy_c = _bilinear_extrapolated(cy, qy, qx)
  move_raw = torch.stack([torch.round(-fy_c), torch.round(-fx_c)], dim=-1)
  move = torch.clamp(move_raw, -max_displacement,
                     max_displacement).to(torch.int32)
  return move, torch.any(torch.abs(move_raw) > max_displacement), geo


def coarse_to_fine(pre, post, patch, stride, max_displacement, peak_crop):
  """Flow of a pair on the [gy, gx] grid of `patch` at `stride` ->
  ([4, gy, gx] (x, y, sharpness, ratio), overflow: a coarse move beyond
  `max_displacement`)."""
  p, s = patch, stride
  fine = p // 2
  crop_off = (p // 2 - fine // 2) % s
  h, w = pre.shape
  pre = pre.to(torch.float32)
  post = post.to(torch.float32)
  move, overflow, geo = coarse_moves(pre, post, p, s, max_displacement)
  gy = (h - (p - s)) // s
  gx = (w - (p - s)) // s
  k0 = (p // 2 - fine // 2 - crop_off) // s
  per_patch = torch.repeat_interleave(move, geo['rows'], dim=0)
  per_patch = torch.repeat_interleave(per_patch, geo['group'], dim=1)
  per_patch = per_patch[:geo['gy'], :geo['gx']].contiguous()
  crop = fine if peak_crop is None else int(peak_crop)
  fine_f = grid_peaks(pre[crop_off:, crop_off:], post[crop_off:, crop_off:],
                      per_patch, (geo['gy'], geo['gx']), fine, (s, s), crop)
  off = per_patch.to(torch.float32)
  total = torch.stack([fine_f[0] - off[..., 1], fine_f[1] - off[..., 0],
                       fine_f[2], fine_f[3]])
  return total[:, k0:k0 + gy, k0:k0 + gx], overflow


def _median3x3(x):
  """3x3 moving median over the last two axes; out-of-bounds window
  entries take the centre value."""
  n0, n1 = x.shape[-2:]
  views = []
  for dy in (-1, 0, 1):
    for dx in (-1, 0, 1):
      v = torch.full_like(x, float('nan'))
      ys0, ys1 = max(0, -dy), n0 - max(0, dy)
      xs0, xs1 = max(0, -dx), n1 - max(0, dx)
      v[..., ys0:ys1, xs0:xs1] = x[..., ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
      views.append(torch.where(torch.isnan(v), x, v))
  return torch.sort(torch.stack(views), dim=0).values[4]


def clean(flow4, min_peak_ratio, min_peak_sharpness, max_magnitude,
          max_deviation):
  """[4, gy, gx] flow -> [2, gy, gx], NaN where a quality gate fails:
  sharpness, peak ratio (0 passes), magnitude, deviation from the 3x3
  median."""
  flow4 = flow4.to(torch.float32)
  xy = flow4[:2]
  bad = torch.abs(flow4[2]) < min_peak_sharpness
  ratio = torch.abs(flow4[3])
  bad = bad | ((ratio > 0.0) & (ratio < min_peak_ratio))
  if max_magnitude > 0:
    bad = bad | (torch.abs(xy).amax(dim=0) > max_magnitude)
  if max_deviation > 0:
    med = _median3x3(torch.nan_to_num(xy))
    bad = bad | (torch.abs(med - xy).amax(dim=0) > max_deviation)
  return torch.where(bad[None], torch.full_like(xy, float('nan')), xy)
