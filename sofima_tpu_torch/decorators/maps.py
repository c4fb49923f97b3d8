"""Coordinate-map decorators (lazy TensorStore views).

Twin of sofima_tpu/decorators/maps.py: lazy composition of coordinate
maps (`ComposeCoordMaps`, `map_utils.compose_maps_fast` on `device`,
default the CUDA card, read from a `device=` keyword among the compose
arguments) and dense affine coordinate maps from 3x4 matrices
(`MakeAffineCoordMap`, numpy on the host as in the reference).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import placement
from sofima_tpu_torch.decorators.base import (Decorator, JsonSpec,
                                              MutableJsonSpec, register,
                                              adjust_schema_for_virtual_chunked)
from sofima_tpu_torch.utils.bounding_box import BoundingBox

MAP_DIMS = ('fc', 'fz', 'fy', 'fx')


def _full_map_domain(domain, store):
  import tensorstore as ts
  read_domain = list(domain)
  for d in range(4):
    read_domain[d] = ts.Dim(inclusive_min=0, exclusive_max=store.shape[d],
                            label=store.domain.labels[d])
  return ts.IndexDomain(read_domain)


def _with_z(m: np.ndarray) -> np.ndarray:
  """Restores the z axis of a map if a squeeze removed a singleton fz."""
  return m[:, np.newaxis] if m.ndim == 3 else m


def _compose_coord_maps(map1: np.ndarray, map2: np.ndarray, device=None,
                        **compose_args) -> np.ndarray:
  """ComposeCoordMaps' chunk: map2 ∘ map1 ([c, z, y, x] numpy in and
  out) by `compose_maps_fast` on `device`."""
  m1 = placement.place(map1, device, torch.float32)
  m2 = placement.place(map2, m1.device, torch.float32)
  return placement.to_host(map_utils.compose_maps_fast(
      map1=m1, map2=m2, **compose_args))


@register
class ComposeCoordMaps(Decorator):
  """Lazy composition: view = coord_map ∘ input (compose_maps_fast)."""

  def __init__(self, coord_map_spec: JsonSpec,
               context_spec: Optional[MutableJsonSpec] = None,
               **compose_args):
    super().__init__(context_spec)
    self._coord_map_spec = coord_map_spec
    self._compose_args = dict(compose_args)
    self._compose_args.setdefault('start1', (0, 0, 0))
    self._compose_args.setdefault('start2', (0, 0, 0))
    self._compose_args.setdefault('stride1', 1.0)
    self._compose_args.setdefault('stride2', 1.0)

  def decorate(self, input_ts):
    import tensorstore as ts
    coord_map_ts = ts.open(self._coord_map_spec).result()

    for d in MAP_DIMS:
      if d not in coord_map_ts.domain.labels:
        raise ValueError(f'coord map dim {d} missing from '
                         f'{coord_map_ts.domain.labels}')
    if input_ts.domain.labels != coord_map_ts.domain.labels:
      raise ValueError('Input and coord map labels must match: '
                       f'{input_ts.domain.labels} vs '
                       f'{coord_map_ts.domain.labels}')

    def read_fn(domain, array, unused_params):
      def load(store):
        return _with_z(np.array(store[_full_map_domain(domain, store)])
                       .squeeze())

      array[...] = _compose_coord_maps(
          load(input_ts), load(coord_map_ts),
          **self._compose_args).reshape(array.shape)

    chunksize = [dim.size if dim.label in MAP_DIMS else 1
                 for dim in input_ts.domain]
    schema = adjust_schema_for_virtual_chunked(input_ts.schema)
    json = schema.to_json()
    json['chunk_layout']['read_chunk']['shape'] = chunksize
    json['chunk_layout']['write_chunk']['shape'] = chunksize
    return ts.virtual_chunked(read_fn, schema=ts.Schema(json),
                              context=self._context)


@register
class MakeAffineCoordMap(Decorator):
  """Lazy dense coordinate map from [3, 4] affine matrices.

  The input volume holds 3x4 matrices in dims 'r'/'c'; extra dims become
  trailing dims of the output (`fc, fz, fy, fx, ...`).
  """

  def __init__(self, size: Sequence[int],
               context_spec: Optional[MutableJsonSpec] = None):
    super().__init__(context_spec)
    self._size_xyz = tuple(int(s) for s in size)
    self._start_xyz = (0, 0, 0)
    self._stride_zyx = (1, 1, 1)
    self._transform_dims = ('r', 'c')

  def decorate(self, input_ts):
    import tensorstore as ts
    for d in self._transform_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'transform dim {d} missing from '
                         f'{input_ts.domain.labels}')

    non_transform = [l for l in input_ts.domain.labels
                     if l not in self._transform_dims]
    input_domain = {dim.label: dim for dim in list(input_ts.domain)}
    box = BoundingBox(start=self._start_xyz, size=self._size_xyz)

    def read_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      read_domain = ts.IndexDomain(
          [input_domain[d] for d in self._transform_dims]
          + [domain_dict[d] for d in non_transform])
      matrix = np.array(input_ts[read_domain], np.float32).squeeze()
      coord_map = map_utils.make_affine_map(matrix, box, self._stride_zyx)
      array[...] = coord_map.reshape(array.shape)

    chunksize = [3] + list(self._size_xyz)[::-1] + [1] * len(non_transform)
    schema = {
        'chunk_layout': {'read_chunk': {'shape': chunksize},
                         'write_chunk': {'shape': chunksize}},
        'domain': {
            'labels': list(MAP_DIMS) + non_transform,
            'inclusive_min': [0, 0, 0, 0] + [
                input_domain[l].inclusive_min for l in non_transform],
            'exclusive_max': chunksize[:4] + [
                input_domain[l].exclusive_max for l in non_transform],
        },
        'dtype': 'float32',
        'rank': len(chunksize),
    }
    return ts.virtual_chunked(read_fn, schema=ts.Schema(schema),
                              context=self._context)
