"""Exact 2d Euclidean distance transform for tile-blending weights.

Twin of sofima_tpu/ops/edt.py. The reference runs the exact native C++
transform when its extension is built and falls back to approximate
jump flooding on the device otherwise. The port computes the exact
transform on the host with `scipy.ndimage.distance_transform_edt` (a
separable lower-envelope algorithm, as the native one): the weights are
a small [y, x] plane per tile, computed once per tile.
"""

from __future__ import annotations

import numpy as np


def edt(mask: np.ndarray, black_border: bool = True,
        parallel: int = 0) -> np.ndarray:
  """2d Euclidean distance transform of a boolean/integer mask.

  Args:
    mask: nonzero pixels are 'inside'; distance is to the nearest zero
    black_border: treat the image border as background
    parallel: accepted for API compatibility with the `edt` package

  Returns:
    float32 distance map, 0 on background pixels (inf everywhere when
    nothing is background and the border is not either)
  """
  del parallel
  from scipy import ndimage
  inside = np.asarray(mask) != 0
  if black_border:
    padded = np.pad(inside, 1, constant_values=False)
    out = ndimage.distance_transform_edt(padded)[1:-1, 1:-1]
  else:
    if inside.all():
      return np.full(inside.shape, np.inf, np.float32)
    out = ndimage.distance_transform_edt(inside)
  return out.astype(np.float32)
