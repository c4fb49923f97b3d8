"""Contrast-limited adaptive histogram equalization (CLAHE).

Twin of sofima_tpu/ops/clahe.py (no Pallas kernel there): per-tile
clipped histograms -> CDFs, bilinear interpolation of the four
surrounding tile mappings at every pixel. Plain PyTorch; `render_tiles`
applies it to each tile before warping.
"""

from __future__ import annotations

import numpy as np
import torch

from sofima_tpu_torch import placement


def clahe(image: torch.Tensor, grid: tuple[int, int] = (8, 8),
          clip_limit: float = 0.01, nbins: int = 256) -> torch.Tensor:
  """Equalizes a [y, x] image in [0, 1]; returns float32 in [0, 1].

  Args:
    image: [y, x] float image scaled to [0, 1]
    grid: number of context tiles (rows, cols)
    clip_limit: histogram clip limit as a fraction of tile pixel count
    nbins: histogram bins
  """
  image = image.to(torch.float32)
  h, w = image.shape
  gy, gx = grid
  th, tw = -(-h // gy), -(-w // gx)
  img = torch.nn.functional.pad(image[None, None], (0, tw * gx - w, 0,
                                                    th * gy - h),
                                mode='replicate')[0, 0]
  tiles = img.reshape(gy, th, gx, tw).permute(0, 2, 1, 3)
  bins = torch.clamp((tiles * (nbins - 1)).to(torch.int64), 0, nbins - 1)
  # Per-tile histograms: one bincount over tile-offset bin indices.
  offs = torch.arange(gy * gx, device=image.device).reshape(gy, gx, 1)
  flat = (bins.reshape(gy, gx, -1) + offs * nbins).reshape(-1)
  hist = torch.bincount(flat, minlength=gy * gx * nbins).reshape(
      gy, gx, nbins).to(torch.float32)
  # Clip and redistribute the excess uniformly.
  limit = max(clip_limit * th * tw, 1.0)
  excess = torch.clamp(hist - limit, min=0.0).sum(dim=-1, keepdim=True)
  hist = torch.clamp(hist, max=limit) + excess / nbins
  cdf = torch.cumsum(hist, dim=-1)
  cdf = cdf / cdf[..., -1:]

  dev = image.device
  yy = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
  xx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
  if gy > 1:
    y0 = torch.clamp(torch.floor(yy).to(torch.int64), 0, gy - 2)
    fy = torch.clamp(yy - y0, 0.0, 1.0)
  else:
    y0 = torch.zeros(h, dtype=torch.int64, device=dev)
    fy = torch.zeros(h, device=dev)
  if gx > 1:
    x0 = torch.clamp(torch.floor(xx).to(torch.int64), 0, gx - 2)
    fx = torch.clamp(xx - x0, 0.0, 1.0)
  else:
    x0 = torch.zeros(w, dtype=torch.int64, device=dev)
    fx = torch.zeros(w, device=dev)
  pix = torch.clamp((image * (nbins - 1)).to(torch.int64), 0, nbins - 1)
  y0g, x0g = y0[:, None], x0[None, :]
  y1g = torch.clamp(y0g + 1, max=gy - 1)
  x1g = torch.clamp(x0g + 1, max=gx - 1)

  def look(ty, tx):
    return cdf[ty, tx, pix]

  fyg, fxg = fy[:, None], fx[None, :]
  return ((1 - fyg) * (1 - fxg) * look(y0g, x0g)
          + (1 - fyg) * fxg * look(y0g, x1g)
          + fyg * (1 - fxg) * look(y1g, x0g)
          + fyg * fxg * look(y1g, x1g)).to(torch.float32)


def equalize_adapthist(image, kernel_size=None, clip_limit: float = 0.01,
                       nbins: int = 256, device=None) -> np.ndarray:
  """skimage-compatible wrapper: uint images in, float [0, 1] numpy out,
  computed on `device` (default: the CUDA card)."""
  image = np.asarray(image)
  if np.issubdtype(image.dtype, np.integer):
    scaled = image.astype(np.float32) / np.iinfo(image.dtype).max
  else:
    scaled = image.astype(np.float32)
  h, w = scaled.shape
  if kernel_size is None:
    grid = (8, 8)
  else:
    if not isinstance(kernel_size, (tuple, list)):
      kernel_size = (kernel_size, kernel_size)
    grid = (max(1, h // int(kernel_size[0])), max(1, w // int(kernel_size[1])))
  return clahe(placement.place(scaled, device), grid=grid,
               clip_limit=clip_limit, nbins=nbins).cpu().numpy()
