"""Coordinate-map processors: inversion, resampling, filtering, merging.

Twin of sofima_tpu/processor/maps.py, built on the port's map algebra
(sofima_tpu_torch.map_utils: composition, inversion, resampling and
filling on the processor's `device`; the maps are numpy in and out).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np

from sofima_tpu_torch import map_utils
from sofima_tpu_torch.processor.base import (OutputNums, SubvolumeProcessor,
                                             SubvolumeOrMany)
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.subvolume import Subvolume


class ReconcileCrossBlockMaps(SubvolumeProcessor):
  """Blends blockwise meshes with a low-z-res cross-block solution.

  Inputs (all coordinate-map volumes):
    * the processor input: blockwise high-res map ('main')
    * main_inv: its inverse (only block-end sections used)
    * last_inv: inverse of the map giving each block-start section's
      position as if solved within the *previous* block
    * cross_block (+ inverse): low-z-res map fixing one section per block

  Every block-start section lands exactly on the cross-block solution;
  interior sections are blended along z with the composition-algebra
  offset field  offset = (xblock_pre^-1 * block_end^-1) * xblock_post,
  scaled by the relative in-block depth — minimally perturbing
  section-to-section alignment while making geometry globally contiguous.
  """

  crop_at_borders = False

  @dataclasses.dataclass(eq=True)
  class Config:
    cross_block: Any
    cross_block_inv: Any
    last_inv: Any
    main_inv: Any
    z_map: dict[str, int]        # high-res z -> cross-block-volume z
    stride: int
    xy_overlap: int = 128
    backward: bool = False

  def __init__(self, config: 'ReconcileCrossBlockMaps.Config',
               input_volinfo=None, device=None):
    del input_volinfo
    self._config = config
    self._device = device
    self._z_map = {int(k): int(v) for k, v in config.z_map.items()}
    self._sorted_z = sorted(self._z_map)
    self._stride = config.stride
    self._backward = config.backward

  def context(self):
    pre = self._config.xy_overlap // 2
    post = self._config.xy_overlap - pre
    return (pre, pre, 1), (post, post, 0)

  def _block_range(self, z: int) -> tuple[int, int]:
    import bisect
    idx = bisect.bisect_left(self._sorted_z, z)
    if idx == 0:
      return 0, self._sorted_z[0]
    return self._sorted_z[idx - 1], self._sorted_z[idx]

  def _blend_block(self, data, box, z0, z1, loaders, done):
    """Blends one block's sections in place; records processed z in done."""
    load_main_inv, load_last_inv, load_xblock, load_xblock_inv = loaders
    backward = self._backward

    if backward:
      xblock_post = load_xblock(self._z_map[z0])
    else:
      xblock_post = load_xblock(self._z_map[z1])

    if not backward and z0 > 0:
      xblock_pre = load_xblock(self._z_map[z0])
      xblock_pre_inv = load_xblock_inv(self._z_map[z0])
    elif backward and z1 < self._sorted_z[-1]:
      xblock_pre = load_xblock(self._z_map[z1])
      xblock_pre_inv = load_xblock_inv(self._z_map[z1])
    else:
      xblock_pre = xblock_pre_inv = np.zeros_like(xblock_post)

    if backward:
      block_end_inv = (load_last_inv(z0) if z0 != self._sorted_z[0]
                       else load_main_inv(z0))
    else:
      block_end_inv = (load_last_inv(z1) if z1 != self._sorted_z[-1]
                       else load_main_inv(z1))

    flat_box = BoundingBox(start=box.start,
                           size=(int(box.size[0]), int(box.size[1]), 1))
    compose = functools.partial(
        map_utils.compose_maps, box1=flat_box, stride1=self._stride,
        box2=flat_box, stride2=self._stride, device=self._device)

    # offset = (xblock_pre^-1 ∘ block_end^-1) ∘ xblock_post
    offset = compose(
        map1=compose(map1=xblock_pre_inv, map2=block_end_inv),
        map2=xblock_post)

    block_size = z1 - z0
    for z in range(max(int(box.start[2]), z0),
                   min(int(box.end[2]), z1 + 1)):
      if z in done:
        continue
      i = z - z0
      rel_z = z - int(box.start[2])
      if i == block_size:
        data[:, rel_z:rel_z + 1] = xblock_pre if backward else xblock_post
      elif i == 0:
        data[:, rel_z:rel_z + 1] = xblock_post if backward else xblock_pre
      else:
        scale = (block_size - i) / block_size if backward else i / block_size
        interior_aligned = compose(map1=data[:, rel_z:rel_z + 1],
                                   map2=xblock_pre)
        data[:, rel_z:rel_z + 1] = compose(map1=interior_aligned,
                                           map2=offset * scale)
      done.add(z)

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    box = subvol.bbox
    coord_map = np.asarray(subvol.data, np.float32)
    cfg = self._config
    vols = [self._open_volume(v) for v in
            (cfg.main_inv, cfg.last_inv, cfg.cross_block,
             cfg.cross_block_inv)]

    def load(z, vol):
      load_box = BoundingBox(
          start=(int(box.start[0]), int(box.start[1]), z),
          size=(int(box.size[0]), int(box.size[1]), 1))
      return vol[load_box.to_slice4d()]

    loaders = tuple(functools.partial(load, vol=v) for v in vols)

    ranges = []
    z = int(box.start[2])
    while z < int(box.end[2]):
      s, e = self._block_range(z)
      ranges.append((s, e))
      z = e + 1

    ret = coord_map.copy()
    done: set[int] = set()
    for s, e in ranges:
      self._blend_block(ret, box, s, e, loaders, done)
    assert not set(range(int(box.start[2]), int(box.end[2]))) - done

    ret[np.isnan(coord_map)] = np.nan
    return self.crop_box_and_data(box, ret)


class InvertMap(SubvolumeProcessor):
  """Chunked coordinate-map inversion."""

  crop_at_borders = False
  output_num = OutputNums.MULTI

  @dataclasses.dataclass(eq=True)
  class Config:
    stride: map_utils.StrideZYX
    crop_output: bool = True
    input_volume: Any = None
    # 'float32' (default) or 'float64' — double precision (on the
    # device); use for whole-volume grids with absolute coordinates
    # beyond ~1e6 px.
    dtype: str = 'float32'

  def __init__(self, config: 'InvertMap.Config',
               input_path_or_metadata=None, device=None):
    self._config = config
    self._device = device
    source = input_path_or_metadata
    if source is None:
      source = config.input_volume
    if source is None:
      raise ValueError('No source volume specified.')
    meta = self._get_metadata(source)
    self._volume_bbox = BoundingBox(start=(0, 0, 0),
                                    size=meta.volume_size)

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    config = self._config
    box = subvol.bbox
    rel_map = np.asarray(subvol.data, np.float32)
    if np.all(np.isnan(rel_map)):
      return []

    if config.crop_output:
      dst_box = map_utils.inner_box(rel_map, box, config.stride,
                                    device=self._device)
      dst_box = dst_box.intersection(self._volume_bbox)
    else:
      dst_box = box
    if dst_box is None:
      return []

    inv_map = map_utils.invert_map(rel_map, box, dst_box, config.stride,
                                   dtype=np.dtype(config.dtype),
                                   device=self._device)
    return [Subvolume(inv_map.astype(np.float32), dst_box)]


class ResampleMap(SubvolumeProcessor):
  """Chunked coordinate-map resampling to a new stride."""

  crop_at_borders = False
  output_num = OutputNums.MULTI

  @dataclasses.dataclass(eq=True)
  class Config:
    stride: int
    out_stride: int
    scale: float = 1.0
    method: str = 'linear'

  def __init__(self, config: 'ResampleMap.Config', input_volinfo=None,
               device=None):
    del input_volinfo
    self._config = config
    self._device = device

  def pixelsize(self, psize):
    psize = np.asarray(psize).copy().astype(np.float32)
    psize[:2] *= self._config.out_stride / self._config.stride
    return psize

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    config = self._config
    box = subvol.bbox
    if np.all(np.isnan(subvol.data)):
      return []

    rel_map = np.asarray(subvol.data, np.float32) * config.scale
    ratio = config.stride / config.out_stride
    dst_box = self.crop_box(box).scale([ratio, ratio, 1.0])
    out = map_utils.resample_map(rel_map, box, dst_box, config.stride,
                                 config.out_stride, config.method,
                                 device=self._device)
    return [Subvolume(out, dst_box)]


class MaskIrregularities(SubvolumeProcessor):
  """Per-section fold/stretch masking of a coordinate-map volume."""

  crop_at_borders = False

  def __init__(self, stride, frac, input_volinfo=None, device=None):
    del input_volinfo
    self._device = device
    self._stride = stride
    self._frac = frac

  def context(self):
    # Covers the dilation that mask_irregular applies.
    return (3, 3, 0), (3, 3, 0)

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    data = np.asarray(subvol.data, np.float32)
    ret = np.zeros_like(data)
    for z in range(data.shape[1]):
      section = data[:, z].copy()
      map_utils.mask_irregular(section, self._stride, self._frac)
      ret[:, z] = section
    return self.crop_box_and_data(subvol.bbox, ret)


class FillMissing(SubvolumeProcessor):
  """Fills missing coordinate-map entries by inter/extrapolation."""

  crop_at_borders = False

  @dataclasses.dataclass(eq=True)
  class Config:
    pass

  def __init__(self, input_volinfo=None, device=None):
    del input_volinfo
    self._device = device

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    data = np.asarray(subvol.data, np.float32)
    if not np.all(np.isnan(data)):
      data = map_utils.fill_missing(data, extrapolate=True,
                                    device=self._device)
    return self.crop_box_and_data(subvol.bbox, data)
