"""Axis-aligned bounding boxes in XYZ order.

Twin of sofima_tpu/utils/bounding_box.py, kept as the port's own numpy
copy: `BoundingBox` (`start`, `size`, `end`, `rank`, equality,
`translate`, `adjusted_by`, `scale`, `intersection`, `hull`, `contains`,
`to_slice_tuple`, `to_slice3d`, `to_slice4d`), `intersections` and
`containing`. Boxes store integer (or float) `start` and `size` vectors
in XYZ order; `end` is exclusive.
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

  def __init__(self, start: ArrayLike, size: ArrayLike | None = None,
               end: ArrayLike | None = None):
    start = _as_array(start)
    if size is None:
      if end is None:
        raise ValueError('Either size or end must be specified.')
      size = _as_array(end) - start
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

  @property
  def rank(self) -> int:
    return len(self.start)

  def __eq__(self, other) -> bool:
    if not isinstance(other, BoundingBox):
      return NotImplemented
    return bool(np.all(self.start == other.start)
                and np.all(self.size == other.size))

  def __hash__(self):
    return hash((tuple(self.start.tolist()), tuple(self.size.tolist())))

  def __repr__(self):
    return (f'BoundingBox(start={self.start.tolist()}, '
            f'size={self.size.tolist()})')

  def translate(self, offset: ArrayLike) -> 'BoundingBox':
    return BoundingBox(self.start + _as_array(offset), self.size)

  def adjusted_by(self, *, start: ArrayLike | None = None,
                  end: ArrayLike | None = None) -> 'BoundingBox':
    """The box with `start` and / or `end` shifted by the given deltas."""
    new_start = self.start.copy()
    new_end = self.end.copy()
    if start is not None:
      new_start = new_start + _as_array(start)
    if end is not None:
      new_end = new_end + _as_array(end)
    return BoundingBox(new_start, new_end - new_start)

  def scale(self, factor) -> 'BoundingBox':
    """The box with its start floored and its size ceiled after scaling
    by `factor` (a scalar or one per axis)."""
    factor = np.asarray(factor)
    return BoundingBox(np.floor(self.start * factor).astype(np.int64),
                       np.ceil(self.size * factor).astype(np.int64))

  def intersection(self, other: 'BoundingBox') -> 'BoundingBox | None':
    start = np.maximum(self.start, other.start)
    end = np.minimum(self.end, other.end)
    if np.any(end <= start):
      return None
    return BoundingBox(start, end - start)

  def hull(self, other: 'BoundingBox') -> 'BoundingBox':
    """The smallest box containing both boxes."""
    start = np.minimum(self.start, other.start)
    end = np.maximum(self.end, other.end)
    return BoundingBox(start, end - start)

  def contains(self, point: ArrayLike) -> bool:
    p = _as_array(point)
    return bool(np.all(p >= self.start) and np.all(p < self.end))

  def to_slice_tuple(self) -> tuple[slice, ...]:
    """Slices in reverse (...ZYX) axis order for array indexing."""
    return tuple(slice(int(s), int(e))
                 for s, e in zip(self.start[::-1], self.end[::-1]))

  def to_slice3d(self) -> tuple[slice, ...]:
    if self.rank != 3:
      raise ValueError('to_slice3d requires a rank-3 box')
    return self.to_slice_tuple()

  def to_slice4d(self) -> tuple[slice, ...]:
    """(channel, z, y, x) slice with a full-channel selector prepended."""
    return (slice(None),) + self.to_slice_tuple()


def intersections(boxes1: Sequence[BoundingBox],
                  boxes2: Sequence[BoundingBox]) -> list[BoundingBox]:
  """The non-empty intersections of every pair from two box sequences."""
  out = []
  for a in boxes1:
    for b in boxes2:
      isec = a.intersection(b)
      if isec is not None:
        out.append(isec)
  return out


def containing(*boxes: BoundingBox) -> BoundingBox:
  """The smallest box containing all given boxes."""
  if not boxes:
    raise ValueError('At least one box required.')
  ret = boxes[0]
  for b in boxes[1:]:
    ret = ret.hull(b)
  return ret
