"""Integral images (summed-area tables) and patch occupancy queries.

Twin of sofima_tpu/utils/geom.py, kept as the port's own copy of the
helpers the masked flow calculator uses for its host-side patch
deselection: `integral_image` (numpy in, numpy out; a tensor stays on
its device), `integral_image_np` and `query_integral_image`. Sums are
int64 throughout, so no mask size can overflow them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def integral_image_np(mask) -> np.ndarray:
  """Summed-area table with a zero border, computed with NumPy (int64)."""
  ii = np.asarray(mask).astype(np.int64)
  for axis in range(ii.ndim):
    ii = ii.cumsum(axis=axis)
  return np.pad(ii, [(1, 0)] * ii.ndim, mode='constant')


def integral_image(mask):
  """Summed-area table of a boolean / integer mask, with a zero border.

  A tensor gets an int64 table on its own device; anything else an int64
  numpy table. None gives None, as in the reference.
  """
  if mask is None:
    return None
  if not isinstance(mask, torch.Tensor):
    return integral_image_np(mask)
  ii = mask.to(torch.int64)
  for axis in range(ii.ndim):
    ii = ii.cumsum(dim=axis)
  return torch.nn.functional.pad(ii, (1, 0) * ii.ndim)


def query_integral_image(ii, patch_size: Sequence[int],
                         stride: Sequence[int]) -> np.ndarray:
  """Sums within all patches of `patch_size` sampled at `stride` spacing.

  Args:
    ii: integral image as returned by `integral_image` ([d0+1, ...]);
      a tensor is queried on its device
    patch_size: per-axis patch extents
    stride: per-axis patch start spacing

  Returns:
    int64 per-patch sums (numpy), shape `(dims - patch_size) // stride + 1`
  """
  on_device = isinstance(ii, torch.Tensor)
  if not on_device:
    ii = np.asarray(ii).astype(np.int64)
  dim = ii.ndim
  patch = np.asarray(patch_size)
  step = np.asarray(stride)
  dims = np.array(tuple(ii.shape)) - 1
  out_shape = (dims - patch) // step + 1
  if np.any(out_shape <= 0):
    raise ValueError(f'patch {patch} too large for image {dims}')
  if on_device:
    starts = [torch.arange(int(n), device=ii.device) * int(s)
              for n, s in zip(out_shape, step)]
    grids = torch.meshgrid(*starts, indexing='ij')
    result = torch.zeros(tuple(out_shape), dtype=torch.int64,
                         device=ii.device)
  else:
    starts = [np.arange(n) * s for n, s in zip(out_shape, step)]
    grids = np.meshgrid(*starts, indexing='ij')
    result = np.zeros(out_shape, dtype=np.int64)
  # Inclusion-exclusion over the 2^dim corners of each patch: the sign
  # is the parity of the number of "low" corners.
  for corner in range(2 ** dim):
    idx = []
    sign = 1
    for axis in range(dim):
      if corner & (1 << axis):
        idx.append(grids[axis] + int(patch[axis]))
      else:
        idx.append(grids[axis])
        sign = -sign
    result = result + sign * ii[tuple(idx)]
  return result.cpu().numpy() if on_device else result
