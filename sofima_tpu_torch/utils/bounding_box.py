"""Axis-aligned bounding boxes in XYZ order (subset).

Twin of sofima_tpu/utils/bounding_box.py, kept as the port's own numpy
copy: only what tile stitching uses (`start`, `size`, `end`,
`translate`, `intersection`, `to_slice_tuple`, `to_slice4d`). Boxes
store integer (or float) `start` and `size` vectors in XYZ order; `end`
is exclusive.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

ArrayLike = Sequence[int] | Sequence[float] | np.ndarray


def _as_array(v: ArrayLike) -> np.ndarray:
  a = np.asarray(v)
  if a.ndim != 1:
    raise ValueError(f'Expected 1d vector, got shape {a.shape}')
  return a


class BoundingBox:
  """An axis-aligned box defined by `start` (inclusive) and `size` (XYZ)."""

  def __init__(self, start: ArrayLike, size: ArrayLike):
    start = _as_array(start)
    size = _as_array(size)
    if start.shape != size.shape:
      raise ValueError(f'start/size shape mismatch: {start} vs {size}')
    if np.issubdtype(start.dtype, np.integer) and np.issubdtype(
        size.dtype, np.integer):
      dtype = np.int64
    else:
      dtype = np.float64
    self.start = start.astype(dtype)
    self.size = size.astype(dtype)

  @property
  def end(self) -> np.ndarray:
    return self.start + self.size

  def translate(self, offset: ArrayLike) -> 'BoundingBox':
    return BoundingBox(self.start + _as_array(offset), self.size)

  def intersection(self, other: 'BoundingBox') -> 'BoundingBox | None':
    start = np.maximum(self.start, other.start)
    end = np.minimum(self.end, other.end)
    if np.any(end <= start):
      return None
    return BoundingBox(start, end - start)

  def to_slice_tuple(self) -> tuple[slice, ...]:
    """Slices in reverse (...ZYX) axis order for array indexing."""
    return tuple(slice(int(s), int(e))
                 for s, e in zip(self.start[::-1], self.end[::-1]))

  def to_slice4d(self) -> tuple[slice, ...]:
    """(channel, z, y, x) slice with a full-channel selector prepended."""
    return (slice(None),) + self.to_slice_tuple()
