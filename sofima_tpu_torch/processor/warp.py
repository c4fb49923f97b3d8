"""Rendering processors: 3d tile-grid stitching and map-driven warping.

Twin of sofima_tpu/processor/warp.py:
  * `StitchAndRender3dTiles` — renders a stitched grid of 3d tiles from
    solved meshes (npz {x, key_to_idx}), with per-tile mesh inversion
    caching and distance-transform blending (ops.edt, exact); the render
    is the 3d `warp.ndimage_warp` (kernel K13 at order 1). Its caches
    are class-level, shared by every instance in a process, as in the
    reference; `reset_caches()` empties them.
  * `WarpByMap` — renderer for aligned volumes: loads an inverse-map
    chunk (+context), computes the needed source region via outer_box,
    warps per section through `warp.warp_subvolume` (kernel K4, counted
    as K4p), with optional on-the-fly area-average downsampling (in
    float64), masking through `mask_configs` and an LRU source cache.
    Source boxes wider than `_max_source_extent` are split 2x2
    recursively to bound the memory of one warp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import logging

import numpy as np

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import warp
from sofima_tpu_torch.ops import edt as edt_ops
from sofima_tpu_torch.processor.base import (OutputNums, SubvolumeProcessor,
                                             SubvolumeOrMany)
from sofima_tpu_torch.utils import volume as volume_lib
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.box_generator import BoxGenerator
from sofima_tpu_torch.utils.subvolume import Subvolume

ZYX = tuple[int, int, int]
XYZ = tuple[int, int, int]


class StitchAndRender3dTiles(SubvolumeProcessor):
  """Renders a volume by stitching 3d tiles placed on a 2d grid."""

  # Class-level caches shared across work items of one worker process.
  _tile_meshes: np.ndarray | None = None
  _tile_idx_to_xy: dict[int, tuple[int, int]] | None = None
  _tile_boxes: dict[int, tuple[BoundingBox, BoundingBox]] = {}
  _inverted_meshes: dict[int, tuple[BoundingBox, np.ndarray]] = {}

  crop_at_borders = False

  def __init__(self, *, tile_map: Sequence[Sequence[int]],
               tile_mesh_path: str, tile_pattern_path: str = '',
               stride: ZYX, offset: XYZ = (0, 0, 0), margin: int = 0,
               work_size: XYZ = (128, 128, 128), order: int = 1,
               parallelism: int = 1, input_volinfo=None, device=None):
    """tile_map is the yx grid of tile ids; tile_mesh_path a npz with
    'x' ([3, n, z, y, x] solved meshes) and 'key_to_idx'."""
    del input_volinfo
    self._device = device
    self._tile_map = np.array(tile_map)
    self._tile_mesh_path = tile_mesh_path
    self._tile_pattern_path = tile_pattern_path
    self._stride = stride
    self._offset = offset
    self._margin = margin
    self._order = order
    self._parallelism = parallelism
    self._work_size = work_size
    self._key_to_tile_id = {
        (x, y): tile_id
        for y, row in enumerate(tile_map)
        for x, tile_id in enumerate(row)
    }

  @classmethod
  def reset_caches(cls) -> None:
    """Empties the class-level mesh, box and inverted-mesh caches (the
    next work item reloads the meshes from `tile_mesh_path`)."""
    base = StitchAndRender3dTiles
    base._tile_meshes = None
    base._tile_idx_to_xy = None
    base._tile_boxes = {}
    base._inverted_meshes = {}

  def _open_tile_volume(self, tile_id: int) -> Any:
    """Returns a ZYX ndarray-like with the tile's image data."""
    raise NotImplementedError(
        'This function needs to be defined in a subclass.')

  def _load_meshes(self):
    cls = StitchAndRender3dTiles
    if cls._tile_meshes is not None:
      return False
    with open(self._tile_mesh_path, 'rb') as f:
      data = np.load(f, allow_pickle=True)
      cls._tile_idx_to_xy = {
          v: k for k, v in data['key_to_idx'].item().items()}
      cls._tile_meshes = data['x']
    assert cls._tile_meshes.shape[1] == len(cls._tile_idx_to_xy)
    return True

  def _collect_tile_boxes(self, tile_shape_zyx: ZYX):
    cls = StitchAndRender3dTiles
    meshes = cls._tile_meshes
    map_box = BoundingBox(start=(0, 0, 0), size=meshes.shape[2:][::-1])
    for i in range(meshes.shape[1]):
      tx, ty = cls._tile_idx_to_xy[i]
      tg_box = map_utils.outer_box(meshes[:, i], map_box, self._stride)
      out_box = BoundingBox(
          start=(int(tg_box.start[0]) * self._stride[2]
                 + tx * tile_shape_zyx[-1] + self._offset[0],
                 int(tg_box.start[1]) * self._stride[1]
                 + ty * tile_shape_zyx[-2] + self._offset[1],
                 int(tg_box.start[2]) * self._stride[0] + self._offset[2]),
          size=(int(tg_box.size[0]) * self._stride[2],
                int(tg_box.size[1]) * self._stride[1],
                int(tg_box.size[2]) * self._stride[0]))
      cls._tile_boxes[i] = out_box, tg_box

  def _blend_weights(self, tile_shape_zyx: ZYX, tx: int,
                     ty: int) -> np.ndarray:
    """2d distance-transform weights, margins removed (except grid edges)."""
    mask = np.zeros(tile_shape_zyx[1:], dtype=bool)
    if self._margin > 0:
      x0 = self._margin if tx > 0 else 0
      x1 = -self._margin if tx < self._tile_map.shape[-1] - 1 else -1
      y0 = self._margin if ty > 0 else 0
      y1 = -self._margin if ty < self._tile_map.shape[-2] - 1 else -1
      mask[y0:y1, x0:x1] = 1
    else:
      mask[...] = 1
    return edt_ops.edt(mask, black_border=True)

  def _render_one_tile(self, i: int, box: BoundingBox, tile_shape_zyx: ZYX,
                       volstore, img: np.ndarray, norm: np.ndarray):
    cls = StitchAndRender3dTiles
    out_box, tg_box = cls._tile_boxes[i]
    sub_box = out_box.intersection(box)
    if sub_box is None:
      return
    tx, ty = cls._tile_idx_to_xy[i]
    image_box = BoundingBox(start=(0, 0, 0), size=tile_shape_zyx[::-1])
    map_box = BoundingBox(start=(0, 0, 0),
                          size=cls._tile_meshes.shape[2:][::-1])

    if i not in cls._inverted_meshes:
      grown = tg_box.adjusted_by(start=(-1, -1, -1), end=(1, 1, 1))
      inv = map_utils.invert_map(cls._tile_meshes[:, i], map_box, grown,
                                 self._stride, device=self._device)
      inv = map_utils.fill_missing(inv, extrapolate=True,
                                   interpolate_first=False,
                                   device=self._device)
      cls._inverted_meshes[i] = grown, inv
    tg_box, inverted_map = cls._inverted_meshes[i]

    local_out_box = out_box.translate(
        (-tx * tile_shape_zyx[-1] - self._offset[0],
         -ty * tile_shape_zyx[-2] - self._offset[1], -self._offset[2]))
    local_rel_box = sub_box.translate(-out_box.start)
    local_warp_box = local_rel_box.translate(local_out_box.start)

    s = 1.0 / np.array(self._stride)[::-1]
    local_map_box = local_warp_box.scale(s).adjusted_by(
        start=(-2, -2, -2), end=(2, 2, 2))
    local_map_box = local_map_box.intersection(tg_box)
    if local_map_box is None:
      return
    map_query_box = local_map_box.translate(-tg_box.start)
    sub_map = inverted_map[map_query_box.to_slice4d()]

    data_box = map_utils.outer_box(sub_map, local_map_box, self._stride, 1)
    data_box = data_box.intersection(image_box)
    if data_box is None:
      return

    dts = self._blend_weights(tile_shape_zyx, tx, ty)
    sub_dts = dts[data_box.to_slice3d()[1:]][None]
    sub_dts = np.repeat(sub_dts, int(data_box.size[2]), axis=0)

    image = np.asarray(volstore[data_box.to_slice3d()])

    warped = warp.ndimage_warp(
        image, inverted_map, self._stride, work_size=self._work_size,
        overlap=(0, 0, 0), order=self._order, image_box=data_box,
        map_box=tg_box, out_box=local_warp_box,
        parallelism=self._parallelism, device=self._device)
    warped_dts = warp.ndimage_warp(
        sub_dts, inverted_map, self._stride, work_size=self._work_size,
        overlap=(0, 0, 0), image_box=data_box, map_box=tg_box,
        out_box=local_warp_box, parallelism=self._parallelism,
        device=self._device)

    out_rel = sub_box.translate(-box.start)
    img[out_rel.to_slice3d()] += warped * warped_dts
    norm[out_rel.to_slice3d()] += warped_dts

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    box = subvol.bbox
    mesh_init = self._load_meshes()
    cls = StitchAndRender3dTiles

    volstores = {}
    for i in range(cls._tile_meshes.shape[1]):
      tile_id = self._key_to_tile_id[cls._tile_idx_to_xy[i]]
      volstores[i] = self._open_tile_volume(tile_id)

    tile_shape_zyx = next(iter(volstores.values())).shape
    if mesh_init:
      self._collect_tile_boxes(tile_shape_zyx)

    img = np.zeros(subvol.data.shape[1:], dtype=np.float32)
    norm = np.zeros(subvol.data.shape[1:], dtype=np.float32)

    for i, volstore in volstores.items():
      self._render_one_tile(i, box, tile_shape_zyx, volstore, img, norm)

    # Distance-weighted average -> smooth tile transitions.
    img[norm > 0] /= norm[norm > 0]
    ret = img.astype(self.output_type(subvol.data.dtype))
    return self.crop_box_and_data(box, ret[None])


def area_downsample(data: np.ndarray, factor_xy: int) -> np.ndarray:
  """Area-average XY downsampling of [c, z, y, x] data."""
  c, z, y, x = data.shape
  f = factor_xy
  assert y % f == 0 and x % f == 0
  wide = data.astype(np.float64)
  return wide.reshape(c, z, y // f, f, x // f, f).mean(axis=(3, 5))


class WarpByMap(SubvolumeProcessor):
  """Warps data through an inverse coordinate map volume.

  Run over a template output volume; loads the map and source data from
  configured volumes. Supports map scaling (e.g. resolution changes) and
  on-the-fly area-average downsampling of the warped output.
  """

  crop_at_borders = False
  output_num = OutputNums.MULTI
  ignores_input_data = True

  @dataclasses.dataclass(eq=True)
  class Config:
    stride: float
    map_volinfo: Any = None
    data_volinfo: Any = None
    map_decorator_specs: Any = None
    data_decorator_specs: Any = None
    map_scale: float = 1.0
    interpolation: str | None = None
    downsample: int = 1
    offset: float = 0.0
    mask_configs: Any = None
    source_cache_bytes: int = int(1e9)

  def __init__(self, config: 'WarpByMap.Config', input_volinfo=None,
               device=None):
    del input_volinfo
    self._config = config
    self._device = device
    self._downsample = np.array([config.downsample, config.downsample, 1])
    self._target_stride = config.stride
    self._source_stride = config.stride * config.downsample
    self._map_vol = None
    self._data_vol = None

  def _open_map_volume(self):
    """Map volume with map_decorator_specs applied (cached per instance)."""
    if self._map_vol is None:
      cfg = self._config
      self._map_vol = volume_lib.decorate_volume(
          self._open_volume(cfg.map_volinfo), cfg.map_decorator_specs)
    return self._map_vol

  def _open_data_volume(self):
    """Source volume with data_decorator_specs + LRU chunk cache applied."""
    if self._data_vol is None:
      cfg = self._config
      vol = volume_lib.decorate_volume(
          self._open_volume(cfg.data_volinfo), cfg.data_decorator_specs)
      self._data_vol = volume_lib.maybe_cache(
          vol, cfg.source_cache_bytes, 'WarpByMap_source')
    return self._data_vol

  # Peak-memory bound for a single warp dispatch (pixels per side).
  _max_source_extent = 2**15

  def _load_and_warp(self, data_box, data_vol, map_data, map_box, out_box):
    data = data_vol[data_box.to_slice4d()]
    cfg = self._config
    mask = None
    if cfg.mask_configs is not None:
      mask = self._build_mask(cfg.mask_configs, data_box)
      for ch in range(data.shape[0]):
        data[ch][mask] = 0
      if mask.all():
        return None
    return warp.warp_subvolume(data, data_box, map_data, map_box,
                               self._source_stride, out_box,
                               cfg.interpolation, cfg.offset,
                               device=self._device)

  def _get_map_for_box(self, box):
    cfg = self._config
    s = 1.0 / self._target_stride
    map_box = box.scale([s, s, 1.0]).adjusted_by(start=(-2, -2, 0),
                                                 end=(2, 2, 0))
    map_vol = self._open_map_volume()
    map_box = map_vol.clip_box_to_volume(map_box)
    if map_box is None or np.any(map_box.size == 0):
      return None, None
    rel_map = map_vol[map_box.to_slice4d()].astype(np.float32) * cfg.map_scale
    if np.all(np.isnan(rel_map)):
      return None, None
    return map_box, rel_map

  def _generate_boxes_to_warp(self, data_vol, box):
    map_box, rel_map = self._get_map_for_box(box)
    if map_box is None:
      return
    data_box = map_utils.outer_box(rel_map, map_box, self._source_stride, 1)
    data_box = data_vol.clip_box_to_volume(data_box)
    if data_box is None or np.any(data_box.size == 0):
      return

    if np.all(data_box.size < self._max_source_extent):
      yield box, data_box, rel_map, map_box
      return
    if np.any(box.size[:2] < self._target_stride * 3):
      logging.warning('Output box too small to subdivide: %r', box)
      return

    # 2x2 subdivision to bound the source region per dispatch.
    sub = np.array(list(-(-box.size[:2] // 2)) + [int(box.size[2])])
    sub = -(-sub // self._downsample) * self._downsample
    gen = BoxGenerator(box, sub)
    for sub_box in gen:
      yield from self._generate_boxes_to_warp(data_vol, sub_box)

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    box = subvol.bbox
    cfg = self._config
    data_vol = self._open_data_volume()

    warped = np.zeros([subvol.data.shape[0]]
                      + [int(v) for v in box.size[::-1]],
                      dtype=subvol.data.dtype)

    for z in range(warped.shape[1]):
      curr_box = BoundingBox(
          start=box.start + [0, 0, z],
          size=[int(box.size[0]), int(box.size[1]), 1])
      for out_box, data_box, map_data, map_box in (
          self._generate_boxes_to_warp(data_vol, curr_box)):
        warp_box = out_box.scale(self._downsample)
        sec = self._load_and_warp(data_box, data_vol, map_data, map_box,
                                  warp_box)
        if sec is None:
          continue
        if warp_box != out_box:
          down = area_downsample(np.nan_to_num(sec.astype(np.float64)),
                                 int(self._downsample[0]))
          write_box = out_box.translate(-box.start)
          warped[write_box.to_slice4d()] = down.astype(warped.dtype)
        else:
          write_box = out_box.translate(-box.start)
          warped[write_box.to_slice4d()] = sec

    return [self.crop_box_and_data(box, warped)]
