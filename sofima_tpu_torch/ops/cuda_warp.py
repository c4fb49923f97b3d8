"""Kernel K4, the section render: a gather resampler and its plain twin.

Twin of sofima_tpu/ops/pallas_warp.py `pallas_shift_warp_tiled` (Pallas
bodies `_warp_tiled_kernel` and, for two_pass=True,
`_warp_tiled_sep_kernel`). The CUDA kernel is csrc/warp.cu.

`shift_warp` resamples [z, h, w] images at [z, 2, oy, ox] (y, x) sampling
positions with nearest, linear, cubic or normalized Lanczos4 weights.
Taps outside the image read 0 (and still count in the Lanczos norm);
NaN coordinates give 0. Where the TPU kernel needs a static shift
envelope and per-tile bases, this gather reaches every tap: it equals
the TPU kernel wherever that kernel's `overflow` plan flag is False.
The two-pass separable TPU variant is an approximation of this exact
render (held to it by mean <= 0.05 and max <= 4.0 gray levels).
"""

from __future__ import annotations

import ctypes

import torch

from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.ops import shift_warp as sw

_METHODS = {'nearest': 0, 'linear': 1, 'cubic': 2, 'lanczos': 3}
# The plain version resamples this many output rows at a time.
_PLAIN_ROWS = 256


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
               method: str = 'lanczos') -> torch.Tensor:
  """Resamples [z, h, w] images at [z, 2, oy, ox] (y, x) coords.

  CPU tensors take the plain version; CUDA tensors launch the kernel.
  Returns [z, oy, ox] float32.
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
  lib = _build.library()
  fn = lib.warp_gather_launch
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  nz, h, w = images.shape
  oy, ox = coords.shape[2:]
  out = torch.empty((nz, oy, ox), dtype=torch.float32, device=images.device)
  rc = fn(images.data_ptr(), coords.data_ptr(), out.data_ptr(), nz, h, w,
          oy, ox, _METHODS[method], _build.stream_of(images))
  _build.launch_counts['warp_gather'] += 1
  _build.check(rc, 'warp_gather')
  return out
