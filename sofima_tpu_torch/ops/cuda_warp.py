"""Kernels K4 and K13, the renders: gather resamplers and their plain twins.

Twin of sofima_tpu/ops/pallas_warp.py:
  * K4 `shift_warp`: `pallas_shift_warp_tiled` (Pallas bodies
    `_warp_tiled_kernel` and, for two_pass=True, `_warp_tiled_sep_kernel`),
    the section render; csrc/warp.cu;
  * K13 `shift_warp_3d`: `pallas_shift_warp_3d` (`_warp3d_kernel`), the
    volume render of 3d stitching; csrc/warp3d.cu.

`shift_warp` resamples [z, h, w] images at [z, 2, oy, ox] (y, x) sampling
positions with nearest, linear, cubic or normalized Lanczos4 weights.
Taps outside the image read 0 (and still count in the Lanczos norm);
NaN coordinates give 0. Where the TPU kernel needs a static shift
envelope and per-tile bases, this gather reaches every tap: it equals
the TPU kernel wherever that kernel's `overflow` plan flag is False.
The two-pass separable TPU variant is an approximation of this exact
render (held to it by mean <= 0.05 and max <= 4.0 gray levels).

`shift_warp_3d` resamples a [d, h, w] volume at [3, oz, oy, ox] (z, y, x)
positions with the TPU kernel's contract: static per-axis displacement
bounds (a tap whose integer shift leaves [lo - left, hi + taps - 1 -
left] adds nothing), raw (unnormalized) weights, 0 outside the volume
and at NaN coordinates.
"""

from __future__ import annotations

import ctypes

import torch

from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.ops import shift_warp as sw

_METHODS = {'nearest': 0, 'linear': 1, 'cubic': 2, 'lanczos': 3}
# The plain versions resample this many output rows (2d) or about this
# many voxels (3d) at a time.
_PLAIN_ROWS = 256
_PLAIN_VOXELS = 1 << 21


def shift_warp_plain(images: torch.Tensor, coords: torch.Tensor,
                     method: str) -> torch.Tensor:
  """Plain PyTorch version of the render kernel (same arithmetic order)."""
  nz, h, w = images.shape
  oy, ox = coords.shape[2:]
  taps = 2 if method == 'nearest' else sw._TAPS[method]
  left = sw._LEFT[method]
  images = images.to(torch.float32)
  out = torch.empty((nz, oy, ox), dtype=torch.float32, device=images.device)
  xs = torch.arange(ox, device=images.device, dtype=torch.float32)
  for z in range(nz):
    img = images[z].reshape(-1)
    for r0 in range(0, oy, _PLAIN_ROWS):
      r1 = min(oy, r0 + _PLAIN_ROWS)
      ys = torch.arange(r0, r1, device=images.device,
                        dtype=torch.float32)[:, None]
      dy = coords[z, 0, r0:r1].to(torch.float32) - ys
      dx = coords[z, 1, r0:r1].to(torch.float32) - xs[None, :]
      ok = (torch.abs(dy) < 1e8) & (torch.abs(dx) < 1e8)
      dy = torch.where(ok, dy, torch.zeros_like(dy))
      dx = torch.where(ok, dx, torch.zeros_like(dx))
      wfy = sw.make_weight_fn(dy, method)
      wfx = sw.make_weight_fn(dx, method)
      sy0 = torch.floor(dy).to(torch.int64) - left
      sx0 = torch.floor(dx).to(torch.int64) - left
      yi = ys.to(torch.int64)
      xi = xs.to(torch.int64)[None, :]
      wx = [wfx(sx0 + j) for j in range(taps)]
      norm_x = torch.zeros_like(dx)
      for j in range(taps):
        norm_x = norm_x + wx[j]
      acc = torch.zeros_like(dx)
      norm_y = torch.zeros_like(dy)
      for i in range(taps):
        s = sy0 + i
        wy = wfy(s)
        norm_y = norm_y + wy
        row = yi + s
        row_ok = (row >= 0) & (row < h)
        inner = torch.zeros_like(dx)
        for j in range(taps):
          col = xi + sx0 + j
          inb = row_ok & (col >= 0) & (col < w)
          lin = torch.where(inb, row * w + col, torch.zeros_like(col))
          v = torch.where(inb, img[lin], torch.zeros_like(dx))
          inner = inner + wx[j] * v
        acc = acc + wy * inner
      if method == 'lanczos':
        acc = acc / torch.clamp(norm_y * norm_x, min=1e-12)
      out[z, r0:r1] = torch.where(ok, acc, torch.zeros_like(acc))
  return out


def shift_warp(images: torch.Tensor, coords: torch.Tensor,
               method: str = 'lanczos', counter: str = 'warp_gather',
               tile_stats: torch.Tensor | None = None) -> torch.Tensor:
  """Resamples [z, h, w] images at [z, 2, oy, ox] (y, x) coords.

  CPU tensors take the plain version; CUDA tensors launch the kernel (one
  instantiation per method; each warp renders a 32-column tile, from its
  source window staged in shared memory when that window is compact) and
  count the launch under `counter` ('warp_subvolume' and 'ndimage_warp'
  tell the library API's renders, the reference's K4p and K12, from the
  pipelines' K4). `tile_stats`, an int32 CUDA tensor of two elements,
  gains the number of tiles that took the staged branch and the number
  of tiles with any tap. Planes below 2^31 pixels on the card. Returns
  [z, oy, ox] float32.
  """
  if method not in _METHODS:
    raise ValueError(f'Unknown method {method!r}')
  if images.ndim != 3 or coords.ndim != 4 or coords.shape[1] != 2 \
      or coords.shape[0] != images.shape[0]:
    raise ValueError(f'bad shapes {tuple(images.shape)}, '
                     f'{tuple(coords.shape)}')
  if images.device.type == 'cpu':
    return shift_warp_plain(images, coords, method)
  _build.require_cuda('shift_warp', images, coords)
  nz, h, w = images.shape
  oy, ox = coords.shape[2:]
  if max(h * w, oy * ox) >= 2 ** 31 - 1 or nz > 65535:
    raise ValueError(f'shift_warp: planes below 2^31 pixels and at most '
                     f'65535 of them, got {tuple(images.shape)} -> '
                     f'{tuple(coords.shape)}')
  if tile_stats is not None:
    _build.require_cuda('shift_warp', tile_stats, dtype=torch.int32)
    if tile_stats.device != images.device or tile_stats.numel() != 2:
      raise ValueError('shift_warp: tile_stats must be two int32 on the '
                       'images\' card')
  fn = _build.library().warp_gather_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
  out = torch.empty((nz, oy, ox), dtype=torch.float32, device=images.device)
  rc = fn(images.data_ptr(), coords.data_ptr(), out.data_ptr(), nz, h, w,
          oy, ox, _METHODS[method], _build.ptr(tile_stats),
          _build.stream_of(images))
  _build.count(counter)
  _build.check(rc, 'warp_gather')
  return out


def _shift_range(method: str, bounds):
  """Inclusive per-axis shift ranges [(s0, s1)] x 3 of the TPU lattice."""
  left = sw._LEFT[method]
  taps = sw._TAPS[method]
  lo_hi = [(int(bounds[2 * a]), int(bounds[2 * a + 1])) for a in range(3)]
  return [(lo - left, hi + taps - 1 - left) for lo, hi in lo_hi]


def shift_warp_3d_plain(volume: torch.Tensor, coords: torch.Tensor,
                        method: str, bounds, origin) -> torch.Tensor:
  """Plain PyTorch version of the 3d render kernel (same arithmetic order:
  z outermost, x innermost, increasing shift)."""
  d, h, w = volume.shape
  oz, oy, ox = coords.shape[1:]
  taps = 2 if method == 'nearest' else sw._TAPS[method]
  left = sw._LEFT[method]
  ranges = _shift_range(method, bounds)
  span = max(abs(v) for r in ranges for v in r) + 16
  dev = volume.device
  flat = volume.to(torch.float32).reshape(-1)
  out = torch.empty((oz, oy, ox), dtype=torch.float32, device=dev)
  zc = max(1, _PLAIN_VOXELS // max(1, oy * ox))
  for z0 in range(0, oz, zc):
    z1 = min(oz, z0 + zc)
    pos = [torch.arange(z0, z1, device=dev)[:, None, None] + origin[0],
           torch.arange(oy, device=dev)[None, :, None] + origin[1],
           torch.arange(ox, device=dev)[None, None, :] + origin[2]]
    ds = [coords[a, z0:z1].to(torch.float32) - pos[a].to(torch.float32)
          for a in range(3)]
    ok = ((torch.abs(ds[0]) < span) & (torch.abs(ds[1]) < span)
          & (torch.abs(ds[2]) < span))
    axes = []
    for a, n in enumerate((d, h, w)):
      da = torch.where(ok, ds[a], torch.zeros_like(ds[a]))
      wfn = sw.make_weight_fn(da, method)
      base = torch.floor(da).to(torch.int64) - left
      s0, s1 = ranges[a]
      ws, idx = [], []
      for t in range(taps):
        s = base + t
        live = (s >= s0) & (s <= s1)
        ws.append(torch.where(live, wfn(s), torch.zeros_like(da)))
        p = pos[a] + s
        idx.append(torch.where(live & (p >= 0) & (p < n), p,
                               torch.full_like(p, -1)))
      axes.append((ws, idx))
    (wz, iz), (wy, iy), (wx, ix) = axes
    acc = torch.zeros_like(ds[0])
    for i in range(taps):
      acc_y = torch.zeros_like(acc)
      for j in range(taps):
        acc_x = torch.zeros_like(acc)
        row_ok = (iz[i] >= 0) & (iy[j] >= 0)
        row = (iz[i] * h + iy[j]) * w
        for k in range(taps):
          inb = row_ok & (ix[k] >= 0)
          lin = torch.where(inb, row + ix[k], torch.zeros_like(row))
          v = torch.where(inb, flat[lin], torch.zeros_like(acc))
          acc_x = acc_x + wx[k] * v
        acc_y = acc_y + wy[j] * acc_x
      acc = acc + wz[i] * acc_y
    out[z0:z1] = torch.where(ok, acc, torch.zeros_like(acc))
  return out


def shift_warp_3d(volume: torch.Tensor, coords: torch.Tensor, method: str,
                  dz_lo: int, dz_hi: int, dy_lo: int, dy_hi: int,
                  dx_lo: int, dx_hi: int, origin_z: int = 0,
                  origin_y: int = 0, origin_x: int = 0,
                  tile_stats: torch.Tensor | None = None) -> torch.Tensor:
  """K13: warps a [d, h, w] volume by per-voxel (z, y, x) coords.

  Same contract as sofima_tpu's pallas_shift_warp_3d: the inclusive
  static bounds of the displacement coords[c] - (output position[c] +
  origin[c]) per axis, 0 outside the volume, the bounds or at NaN
  coords. CPU tensors take the plain version; CUDA tensors launch the
  kernel (one instantiation per method; each block renders a 32 x 8 x 4
  voxel tile, from its source brick staged in shared memory when that
  brick is compact). `tile_stats`, an int32 CUDA tensor of two elements,
  gains the number of tiles that took the staged branch and the number
  of tiles with any tap. Returns [oz, oy, ox] float32.
  """
  if method not in _METHODS:
    raise ValueError(f'Unknown method {method!r}')
  if volume.ndim != 3 or coords.ndim != 4 or coords.shape[0] != 3:
    raise ValueError(f'bad shapes {tuple(volume.shape)}, '
                     f'{tuple(coords.shape)}')
  bounds = (dz_lo, dz_hi, dy_lo, dy_hi, dx_lo, dx_hi)
  origin = (int(origin_z), int(origin_y), int(origin_x))
  if volume.device.type == 'cpu':
    return shift_warp_3d_plain(volume, coords, method, bounds, origin)
  volume = volume.to(torch.float32).contiguous()
  coords = coords.to(torch.float32).contiguous()
  _build.require_cuda('shift_warp_3d', volume, coords)
  if tile_stats is not None:
    _build.require_cuda('shift_warp_3d', tile_stats, dtype=torch.int32)
    if tile_stats.device != volume.device or tile_stats.numel() != 2:
      raise ValueError('shift_warp_3d: tile_stats must be two int32 on the '
                       'volume\'s card')
  fn = _build.library().warp_gather_3d_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
  d, h, w = volume.shape
  oz, oy, ox = coords.shape[1:]
  out = torch.empty((oz, oy, ox), dtype=torch.float32, device=volume.device)
  (s0z, s1z), (s0y, s1y), (s0x, s1x) = _shift_range(method, bounds)
  rc = fn(volume.data_ptr(), coords.data_ptr(), out.data_ptr(), d, h, w, oz,
          oy, ox, *origin, s0z, s1z, s0y, s1y, s0x, s1x, _METHODS[method],
          _build.ptr(tile_stats), _build.stream_of(volume))
  _build.count('warp_gather_3d')
  _build.check(rc, 'warp_gather_3d')
  return out
