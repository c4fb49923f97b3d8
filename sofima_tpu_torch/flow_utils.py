"""Flow-field quality gates (subset).

Twin of sofima_tpu/flow_utils.py. Ported: `clean_flow_device` and
`_median_per_section`, the cleaning step of the stack-alignment path.
"""

from __future__ import annotations

import torch

from sofima_tpu_torch.ops import morphology


def clean_flow_device(flow: torch.Tensor, min_peak_ratio: float,
                      min_peak_sharpness: float, max_magnitude: float,
                      max_deviation: float, dim: int = 2) -> torch.Tensor:
  """Removes flow vectors that fail the quality gates (NaN out).

  Args:
    flow: [c, z, y, x] flow; c == dim (+2 with sharpness/ratio channels)
    min_peak_ratio: min |peak ratio|; ratio == 0 (single peak) passes
    min_peak_sharpness: min |sharpness|
    max_magnitude: max |component|; <= 0 disables
    max_deviation: max |component - 3^dim-window median|; <= 0 disables
    dim: spatial dimensionality of the flow vectors

  Returns:
    [dim or dim+1, z, y, x] filtered flow
  """
  assert dim in (2, 3)
  assert dim <= flow.shape[0] <= dim + 2
  flow = flow.to(torch.float32)
  if flow.shape[0] == dim + 2:
    ret = flow[:dim]
    bad = torch.abs(flow[dim]) < min_peak_sharpness
    ratio = torch.abs(flow[dim + 1])
    bad = bad | ((ratio > 0.0) & (ratio < min_peak_ratio))
  else:
    ret = flow[:dim + 1] if flow.shape[0] == dim + 1 else flow
    bad = torch.zeros(flow.shape[1:], dtype=torch.bool, device=flow.device)
  if max_magnitude > 0:
    bad = bad | (torch.abs(flow[:dim]).amax(dim=0) > max_magnitude)
  if max_deviation > 0:
    med = _median_per_section(torch.nan_to_num(flow[:dim]), dim)
    bad = bad | (torch.abs(med - flow[:dim]).amax(dim=0) > max_deviation)
  return torch.where(bad[None], torch.full_like(ret, float('nan')), ret)


def _median_per_section(flow: torch.Tensor, dim: int) -> torch.Tensor:
  """3^dim median filter over [c, z, y, x] flows (per-z window for 2d)."""
  return morphology.median_filter(flow, dims=2 if dim == 2 else 3)
