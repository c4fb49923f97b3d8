"""Moving median filter and connected components.

Twin of sofima_tpu/ops/morphology.py: `median_filter` (the flow
cleaning) and `label_components`, `component_sizes` and
`small_component_mask` (flow_utils.reconcile_flows' `min_patch_size`).
Plain PyTorch over small flow grids.
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


def label_components(valid: torch.Tensor, max_iters: int = 0) -> torch.Tensor:
  """Labels the 4-connected components of a 2d boolean mask.

  The reference's min-label propagation with pointer jumping: every
  valid pixel starts with its linear index; each round takes the
  minimum over its valid 4-neighbourhood and then follows its label to
  that pixel's label twice. It stops at the fixed point or after
  `max_iters` rounds (0: h + w, the reference's ceiling). Returns int32
  labels, -1 on invalid pixels; a label is unique per component.
  """
  h, w = valid.shape
  n = h * w
  dev = valid.device
  big = torch.tensor(n, dtype=torch.int64, device=dev)
  init = torch.where(valid, torch.arange(n, device=dev).reshape(h, w), big)
  if max_iters <= 0:
    max_iters = h + w

  def neighbor_min(lab):
    pad = torch.full((h + 2, w + 2), n, dtype=torch.int64, device=dev)
    pad[1:-1, 1:-1] = lab
    out = lab
    for sy, sx in ((slice(0, -2), slice(1, -1)), (slice(2, None), slice(1, -1)),
                   (slice(1, -1), slice(0, -2)), (slice(1, -1), slice(2, None))):
      out = torch.minimum(out, pad[sy, sx])
    return torch.where(valid, out, big)

  def jump(lab):
    flat = torch.cat([lab.reshape(-1), big[None]])
    return torch.where(valid, torch.minimum(lab, flat[lab].reshape(h, w)),
                       big)

  lab, prev = neighbor_min(init), init
  it = 0
  while it < max_iters and bool((lab != prev).any()):
    lab, prev = jump(jump(neighbor_min(lab))), lab
    it += 1
  return torch.where(valid, lab, -1).to(torch.int32)


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
  """Per-pixel size of the component each pixel belongs to (-1 -> 0)."""
  n = labels.numel()
  flat = labels.reshape(-1).to(torch.int64)
  safe = torch.where(flat < 0, n, flat)
  counts = torch.bincount(safe, minlength=n + 1)
  counts[n] = 0
  return counts[safe].reshape(labels.shape).to(torch.int32)


def small_component_mask(valid: torch.Tensor, min_size: int) -> torch.Tensor:
  """True where a valid pixel belongs to a component smaller than
  `min_size`."""
  return valid & (component_sizes(label_components(valid)) < min_size)
