"""Tiling of a bounding box into overlapping work boxes.

Twin of sofima_tpu/utils/box_generator.py, kept as the port's own copy
of `BoxGenerator` (warp.ndimage_warp's work boxes): overlapping boxes
with `back_shift_small_boxes` semantics and half-overlap cropped output
boxes for seam-free assembly; `grid_boxes` and `iter_grid`.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from sofima_tpu_torch.utils.bounding_box import BoundingBox


class BoxGenerator:
  """A grid of (possibly overlapping) boxes covering an outer box."""

  def __init__(self, outer_box: BoundingBox, box_size: Sequence[int],
               box_overlap: Sequence[int] | None = None,
               back_shift_small_boxes: bool = False):
    self._outer = outer_box
    rank = outer_box.rank
    box_size = np.array(box_size, dtype=np.int64)
    if box_size.shape != (rank,):
      raise ValueError(f'box_size must have rank {rank}')
    if box_overlap is None:
      box_overlap = np.zeros(rank, dtype=np.int64)
    box_overlap = np.array(box_overlap, dtype=np.int64)
    box_size = np.minimum(box_size, outer_box.size)
    stride = box_size - box_overlap
    if np.any(stride <= 0):
      raise ValueError(f'overlap ({box_overlap}) must be < box size '
                       f'({box_size})')
    self._box_size = box_size
    self._overlap = box_overlap
    self._stride = stride
    self._back_shift = back_shift_small_boxes
    covered = outer_box.size - box_size
    self._grid_shape = np.maximum(-(-covered // stride) + 1,
                                  1).astype(np.int64)

  @property
  def num_boxes(self) -> int:
    return int(np.prod(self._grid_shape))

  @property
  def grid_shape(self) -> np.ndarray:
    return self._grid_shape.copy()

  @property
  def box_size(self) -> np.ndarray:
    return self._box_size.copy()

  @property
  def overlap(self) -> np.ndarray:
    return self._overlap.copy()

  def _index_to_grid(self, index: int) -> np.ndarray:
    coords = []
    for n in self._grid_shape:
      coords.append(index % n)
      index //= n
    return np.array(coords, dtype=np.int64)

  def generate(self, index: int) -> tuple[np.ndarray, BoundingBox]:
    """(grid coordinates, box) of a flat box index."""
    if not 0 <= index < self.num_boxes:
      raise IndexError(f'box index {index} out of range')
    grid = self._index_to_grid(index)
    start = self._outer.start + grid * self._stride
    end = start + self._box_size
    over = np.maximum(end - self._outer.end, 0)
    if self._back_shift:
      start = start - over
      end = start + self._box_size
    else:
      end = end - over
    return grid, BoundingBox(start, end - start)

  def index_to_cropped_box(self, index: int) -> BoundingBox:
    """The box with half the overlap trimmed on sides with a neighbour;
    a back-shifted trailing box is cropped where its predecessor's
    cropped region ends."""
    grid, box = self.generate(index)
    lo_crop = np.where(grid > 0, self._overlap // 2, 0)
    hi_crop = np.where(grid < self._grid_shape - 1,
                       self._overlap - self._overlap // 2, 0)
    if self._back_shift:
      nominal_start = self._outer.start + grid * self._stride
      lo_crop = lo_crop + (nominal_start - box.start)
    start = box.start + lo_crop
    end = box.end - hi_crop
    return BoundingBox(start, end - start)

  def __iter__(self):
    for i in range(self.num_boxes):
      yield self.generate(i)[1]

  def boxes(self) -> list[BoundingBox]:
    return [self.generate(i)[1] for i in range(self.num_boxes)]

  def cropped_boxes(self) -> list[BoundingBox]:
    return [self.index_to_cropped_box(i) for i in range(self.num_boxes)]


def grid_boxes(outer_box: BoundingBox, box_size: Sequence[int],
               overlap: Sequence[int] | None = None) -> list[BoundingBox]:
  """Every box of a back-shifted `BoxGenerator` over `outer_box`."""
  return BoxGenerator(outer_box, box_size, overlap,
                      back_shift_small_boxes=True).boxes()


def iter_grid(shape: Sequence[int]):
  """All coordinates of a grid, in C order."""
  return itertools.product(*[range(int(s)) for s in shape])
