"""Where the port's entry points run.

The entry points (`align_stack*`, `align_step`, `stitch_and_render_3d`,
`mesh.relax_mesh`, `convert.map_from_numpy` and the library API of
flow_utils, map_utils and warp) take `device=None`, which means the CUDA
card. Host (numpy) inputs go to that device; a tensor
that is already placed stays where it is, as its placement is the
caller's choice. There is no silent CPU path: without a card, a host
input raises unless the caller asks for `device='cpu'`.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
  """`device`, defaulting to the CUDA card; raises if that card is absent."""
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('no CUDA device: pass device="cpu" to run the plain '
                       'PyTorch versions on the CPU')
  return dev


def place(value, device=None, dtype=None) -> torch.Tensor:
  """A tensor as it is (cast to `dtype` if given); anything else as a
  tensor on `device` (default: the CUDA card)."""
  if isinstance(value, torch.Tensor):
    return value if dtype is None else value.to(dtype)
  t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)).copy())
  return t.to(device=resolve(device), dtype=dtype)


def to_host(value) -> np.ndarray:
  """A tensor's values as numpy (copied to the host); anything else as
  `np.asarray` gives it."""
  if isinstance(value, torch.Tensor):
    return value.detach().cpu().numpy()
  return np.asarray(value)
