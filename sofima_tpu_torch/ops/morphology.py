"""Moving median filter (subset).

Twin of sofima_tpu/ops/morphology.py. Ported: `median_filter`, which the
flow cleaning uses. Plain PyTorch over small flow grids.
"""

from __future__ import annotations

import torch


def _shifted_stack(x: torch.Tensor, radius: int, dims: int) -> torch.Tensor:
  """All (2r+1)^dims shifted views of the trailing axes, NaN-filled."""
  views = []

  def rec(axis, arr):
    if axis == dims:
      views.append(arr)
      return
    ax = x.ndim - dims + axis
    n = x.shape[ax]
    for off in range(-radius, radius + 1):
      if off == 0:
        rec(axis + 1, arr)
        continue
      fill_shape = list(arr.shape)
      fill_shape[ax] = abs(off)
      fill = torch.full(fill_shape, float('nan'), dtype=arr.dtype,
                        device=arr.device)
      if off > 0:
        shifted = torch.cat([fill, arr.narrow(ax, 0, n - off)], dim=ax)
      else:
        shifted = torch.cat([arr.narrow(ax, -off, n + off), fill], dim=ax)
      rec(axis + 1, shifted)

  rec(0, x)
  return torch.stack(views)


def median_filter(x: torch.Tensor, dims: int = 2,
                  radius: int = 1) -> torch.Tensor:
  """Moving median over the trailing `dims` axes ((2r+1)^dims window).

  Out-of-bounds window entries take the center value (the window
  effectively shrinks at the border); a NaN in the window gives NaN.
  """
  stack = _shifted_stack(x, radius, dims)
  center = x[None].expand_as(stack)
  stack = torch.where(torch.isnan(stack), center, stack)
  k = stack.shape[0]
  srt = torch.sort(stack, dim=0).values
  med = srt[(k - 1) // 2] if k % 2 else 0.5 * (srt[k // 2 - 1]
                                                + srt[k // 2])
  return torch.where(torch.isnan(stack).any(dim=0),
                     torch.full_like(med, float('nan')), med)
