"""Warping decorators (lazy TensorStore views).

Twin of sofima_tpu/decorators/warp.py: lazy affine warping
(`WarpAffine`) and coordinate-map warping (`WarpCoordMap`), on `device`
(default: the CUDA card), read from a `device=` keyword among the warp
arguments. An affine transform is an affine coordinate map and
`warp.ndimage_warp`: on the card, K4 under the 'ndimage_warp' counter
(K12) in 2d and K13 in 3d; the 'scipy' implementation stays on the host.
`WarpCoordMap` samples through `ops.interp.map_coordinates` (plain
torch, no kernel).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import placement
from sofima_tpu_torch import warp as warp_lib
from sofima_tpu_torch.decorators.base import (Decorator, JsonSpec,
                                              MutableJsonSpec, register,
                                              adjust_schema_for_virtual_chunked)
from sofima_tpu_torch.ops import interp
from sofima_tpu_torch.utils.bounding_box import BoundingBox

MAP_DIMS = ('fc', 'fz', 'fy', 'fx')


def _warp_affine(img_xyz: np.ndarray, matrix_xyz: np.ndarray,
                 order: int = 1, implementation: str = 'native',
                 device=None, **warp_args) -> np.ndarray:
  """Affine-warps a 2d/3d image (xyz axis order, matrix rows are xyz)."""
  ndim = img_xyz.ndim
  if ndim not in (2, 3):
    raise ValueError(f'2d or 3d image required, got {ndim}d')
  rows, cols = matrix_xyz.shape
  if cols != ndim + 1:
    raise ValueError(f'matrix must have {ndim + 1} columns, got {cols}')
  if rows == ndim:
    matrix_h = np.vstack([matrix_xyz, [0.0] * ndim + [1.0]])
  elif rows == ndim + 1:
    matrix_h = matrix_xyz
  else:
    raise ValueError(f'matrix must have {ndim} or {ndim + 1} rows')

  if implementation == 'scipy':
    import scipy.ndimage
    return scipy.ndimage.affine_transform(
        img_xyz, np.linalg.inv(matrix_h), order=order)

  if implementation not in ('native', 'sofima', 'opencv'):
    raise ValueError(f'unknown implementation {implementation!r}')

  # Native path: inverse affine -> coordinate map -> device warp.
  inv = np.linalg.inv(matrix_h)
  if ndim == 2:
    # The reference warps the plane as a one-section volume whose z
    # coordinate is exactly 0; the port warps it as a plane, through the
    # 2d ndimage_warp: the same sampling, taps outside the image reading
    # 0 as in the reference's shift kernel.
    inv3 = np.eye(4)
    inv3[:2, :2] = inv[:2, :2]
    inv3[:2, 3] = inv[:2, 2]
    box = BoundingBox(start=(0, 0, 0), size=tuple(img_xyz.shape) + (1,))
    coord_map = map_utils.make_affine_map(inv3[:3], box, (1, 1, 1))[:2, 0]
    work_size = tuple(warp_args.pop('work_size', img_xyz.shape))[:2]
    return warp_lib.ndimage_warp(
        image=img_xyz.T, coord_map=coord_map, stride=(1, 1),
        work_size=work_size, overlap=(0, 0), order=order, device=device,
        **warp_args).T

  box = BoundingBox(start=(0, 0, 0), size=img_xyz.shape)
  coord_map = map_utils.make_affine_map(inv[:3], box, (1, 1, 1))
  warp_args.setdefault('work_size', img_xyz.shape)
  res = warp_lib.ndimage_warp(
      image=img_xyz.T, coord_map=coord_map, stride=(1, 1, 1), order=order,
      overlap=(0, 0, 0), device=device, **warp_args)
  return res.T


@register
class WarpAffine(Decorator):
  """Lazy affine warping driven by a transform volume.

  The transform volume holds [3, 4] (or homogeneous) matrices in dims
  'r'/'c', batched over the non-image dims of the input.
  """

  def __init__(self, transform_spec: JsonSpec,
               image_dims: Sequence[str] = ('x', 'y'),
               context_spec: Optional[MutableJsonSpec] = None,
               **warp_args):
    super().__init__(context_spec)
    self._transform_spec = transform_spec
    self._image_dims = image_dims
    self._warp_args = warp_args

  def decorate(self, input_ts):
    import tensorstore as ts
    transform_ts = ts.open(self._transform_spec).result()
    input_domain = {dim.label: dim for dim in list(input_ts.domain)}

    for d in self._image_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'image dim {d} not in {input_ts.domain.labels}')
    transform_domain = {dim.label: dim for dim in list(transform_ts.domain)}

    def warp_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      read_domain = ts.IndexDomain([
          input_domain[l] if l in self._image_dims else domain_dict[l]
          for l in input_ts.domain.labels])
      t_domain = ts.IndexDomain([
          transform_domain[l] if l in ('r', 'c') else domain_dict[l]
          for l in transform_ts.domain.labels])
      matrix = np.array(transform_ts[t_domain], np.float64).squeeze()
      # read_domain orders image dims as given (x, y[, z]) -> img is xyz.
      img = np.array(input_ts[read_domain], np.float32).squeeze()
      ndim = len(self._image_dims)
      matrix = matrix[:ndim + 1 if matrix.shape[0] > ndim else ndim,
                      :ndim + 1]
      res = _warp_affine(img, matrix, **self._warp_args)
      array[...] = res.reshape(array.shape)

    chunksize = [dim.size if dim.label in self._image_dims else 1
                 for dim in input_ts.domain]
    schema = adjust_schema_for_virtual_chunked(input_ts.schema)
    json = schema.to_json()
    json['chunk_layout']['read_chunk']['shape'] = chunksize
    json['chunk_layout']['write_chunk']['shape'] = chunksize
    return ts.virtual_chunked(warp_fn, schema=ts.Schema(json),
                              context=self._context)


def _warp_coord_map(img_xyz: np.ndarray, coord_map: np.ndarray,
                    mode: str = 'constant', cval: float = 0.0,
                    scale_xyz: Optional[Sequence[float]] = None,
                    device=None, **warp_args) -> np.ndarray:
  """Warps a 3d xyz image by a [c, z, y, x] coordinate map."""
  if img_xyz.ndim != 3:
    raise ValueError('Only 3d images are supported.')
  warp_args.setdefault('work_size', img_xyz.shape)
  warp_args.setdefault('stride', (1, 1, 1))
  warp_args.setdefault('overlap', (0, 0, 0))
  if scale_xyz is not None:
    coord_map = coord_map * np.asarray(scale_xyz).reshape(-1, 1, 1, 1)
  dev = placement.resolve(device)

  def map_coordinates(data, coords, order):
    return placement.to_host(interp.map_coordinates(
        torch.as_tensor(np.asarray(data, np.float32), device=dev),
        torch.as_tensor(np.array(coords, np.float32), device=dev),
        order=order, mode=mode, cval=cval))

  res_zyx = warp_lib.ndimage_warp(image=img_xyz.T, coord_map=coord_map,
                                  map_coordinates=map_coordinates,
                                  device=dev, **warp_args)
  return res_zyx.T


@register
class WarpCoordMap(Decorator):
  """Lazy 3d warping by a coordinate-map volume (`fc, fz, fy, fx`)."""

  def __init__(self, coord_map_spec: JsonSpec,
               image_dims: Sequence[str] = ('x', 'y', 'z'),
               context_spec: Optional[MutableJsonSpec] = None,
               **warp_args):
    super().__init__(context_spec)
    self._coord_map_spec = coord_map_spec
    self._image_dims = image_dims
    self._warp_args = warp_args

  def decorate(self, input_ts):
    import tensorstore as ts
    if len(self._image_dims) != 3:
      raise ValueError('3 image dims required')
    for d in self._image_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'image dim {d} not in {input_ts.domain.labels}')

    coord_map_ts = ts.open(self._coord_map_spec).result()
    for d in MAP_DIMS:
      if d not in coord_map_ts.domain.labels:
        raise ValueError(f'coord map dim {d} missing')

    def warp_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      cm_domain = ts.IndexDomain([
          dim if dim.label in MAP_DIMS else domain_dict[dim.label]
          for dim in coord_map_ts.domain])
      array[...] = _warp_coord_map(
          np.array(input_ts[domain]).squeeze(),
          np.array(coord_map_ts[cm_domain]).squeeze(),
          **self._warp_args).reshape(array.shape)

    chunksize = [dim.size if dim.label in self._image_dims else 1
                 for dim in input_ts.domain]
    schema = adjust_schema_for_virtual_chunked(input_ts.schema)
    json = schema.to_json()
    json['chunk_layout']['read_chunk']['shape'] = chunksize
    json['chunk_layout']['write_chunk']['shape'] = chunksize
    return ts.virtual_chunked(warp_fn, schema=ts.Schema(json),
                              context=self._context)
