"""Flow-field quality gates and reconciliation.

Twin of sofima_tpu/flow_utils.py: `clean_flow_device` and
`_median_per_section` (the cleaning step of the stack-alignment path),
and the library API's host-side `apply_mask`, `clean_flow`,
`_steep_gradient` and `reconcile_flows`: numpy in and out, as the
reference, with the median filter and the connected-component pruning
on `device` (default: the CUDA card; pass device='cpu' without one).
A flow field is a [c, z, y, x] relative map (x, y[, z] channels, then
optionally sharpness and peak ratio); invalid entries are NaN.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import morphology


def apply_mask(flow: np.ndarray, mask: np.ndarray) -> None:
  """NaNs out all channels of `flow` where `mask` is True (in place)."""
  for i in range(flow.shape[0]):
    flow[i, ...][mask] = np.nan


def clean_flow(flow, min_peak_ratio: float, min_peak_sharpness: float,
               max_magnitude: float, max_deviation: float, dim: int = 2,
               device=None) -> np.ndarray:
  """`clean_flow_device` on `device` (default: the CUDA card), numpy out.

  A host `flow` goes to `device`; a tensor stays where it is. The
  arguments and the result are those of `clean_flow_device`.
  """
  t = placement.place(flow, device, torch.float32)
  return placement.to_host(clean_flow_device(
      t, min_peak_ratio, min_peak_sharpness, max_magnitude, max_deviation,
      dim))


def _steep_gradient(comp: np.ndarray, axis: int,
                    limit: float) -> np.ndarray:
  """Entries whose difference to EITHER axis neighbour exceeds `limit`.

  Out-of-range neighbours count as 0; NaN differences compare False, so
  invalid entries never flag their neighbours here.
  """
  axis = axis % comp.ndim
  pad = [(0, 0)] * comp.ndim
  pad[axis] = (1, 1)
  padded = np.pad(comp, pad)
  n = comp.shape[axis]
  before = np.take(padded, np.arange(n), axis=axis)
  after = np.take(padded, np.arange(2, n + 2), axis=axis)
  with np.errstate(invalid='ignore'):
    return ((np.abs(comp - before) > limit)
            | (np.abs(after - comp) > limit))


def reconcile_flows(flows: Sequence[np.ndarray], max_gradient: float,
                    max_deviation: float, min_patch_size: int,
                    min_delta_z: int = 0, device=None) -> np.ndarray:
  """Merges flows in preference order and invalidates inconsistencies.

  Args:
    flows: [c, z, y, x] arrays sorted by decreasing preference (c in 2, 3)
    max_gradient: max |flow gradient| forward and backward per axis; <= 0
      disables
    max_deviation: max |component - 3x3 median|; <= 0 disables
    min_patch_size: min 4-connected valid-component size (nodes); <= 0
      disables
    min_delta_z: for 3-channel flows, min |dz| for donor entries
    device: where the median filter and the component labelling run
      (default: the CUDA card)

  Returns:
    [c, z, y, x] reconciled flow
  """
  flows = [np.asarray(placement.to_host(f), np.float32) for f in flows]
  ret = flows[0].copy()
  assert ret.shape[0] in (2, 3)
  for f in flows[1:]:
    holes = np.repeat(np.isnan(ret[0:1]), ret.shape[0], 0)
    if ret.shape[0] == 3:
      holes &= np.repeat(np.abs(f[2:3]) >= min_delta_z, 3, 0)
    ret[holes] = f[holes]

  if max_gradient > 0:
    # Each component along its own axis (x-flow along x, y-flow along y)
    # against both neighbours, the one beyond the edge counting as 0.
    bad = _steep_gradient(ret[0], -1, max_gradient)
    bad |= _steep_gradient(ret[1], -2, max_gradient)
    apply_mask(ret, bad)

  if max_deviation > 0:
    med = placement.to_host(_median_per_section(
        torch.nan_to_num(placement.place(ret, device)), 2))
    bad = np.max(np.abs(med - ret)[:2], axis=0) > max_deviation
    apply_mask(ret, bad)

  if min_patch_size > 0:
    valid = placement.place(~np.any(np.isnan(ret), axis=0), device)
    small = torch.stack([morphology.small_component_mask(v, min_patch_size)
                         for v in valid])
    apply_mask(ret, small.cpu().numpy())
  return ret


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
