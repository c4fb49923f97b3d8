"""Volume backends: the I/O plane of the processor layer.

Twin of sofima_tpu/utils/volume.py (numpy only; the port keeps its own
copy). Concrete backends:

  * `InMemoryVolume` — ndarray-backed, used by tests and as the exchange
    format between pipeline stages
  * `TensorStoreVolume` — chunked persistent storage via TensorStore
    (n5/zarr/neuroglancer_precomputed), imported only when used
  * `CachingVolume` — an LRU read cache over another volume

All expose the protocol the processor layer consumes: CZYX `__getitem__`
indexing, `clip_box_to_volume`, `asarray`, `meta` (num_channels,
pixel_size, volume_size) and `write`. Data stays numpy on the host; the
processors move what they compute on to their device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from sofima_tpu_torch.utils.bounding_box import BoundingBox


@dataclasses.dataclass
class VolumeMetadata:
  volume_size: tuple[int, int, int]        # xyz
  pixel_size: tuple[float, float, float]   # xyz
  num_channels: int
  dtype: Any = np.float32

  @property
  def bbox(self) -> BoundingBox:
    return BoundingBox(start=(0, 0, 0), size=self.volume_size)


class BaseVolume:
  """Protocol base for CZYX volumes anchored at the origin."""

  meta: VolumeMetadata

  def __getitem__(self, slices) -> np.ndarray:
    raise NotImplementedError

  def write(self, data: np.ndarray, box: BoundingBox) -> None:
    raise NotImplementedError

  @property
  def asarray(self) -> 'BaseVolume':
    return self

  def clip_box_to_volume(self, box: BoundingBox) -> BoundingBox | None:
    return box.intersection(self.meta.bbox)

  # Convenience accessors used throughout the processor layer.
  def read_box(self, box: BoundingBox) -> np.ndarray:
    return self[box.to_slice4d()]


class InMemoryVolume(BaseVolume):
  """A [c, z, y, x] ndarray with volume semantics.

  Out-of-bounds reads return `fill_value` (NaN by default for float data),
  so processors can request context without explicit clipping.
  """

  def __init__(self, data: np.ndarray,
               pixel_size: Sequence[float] = (1.0, 1.0, 1.0),
               fill_value: float | None = None):
    if data.ndim == 3:
      data = data[np.newaxis]
    assert data.ndim == 4, f'need [c,z,y,x], got {data.shape}'
    self.data = data
    if fill_value is None:
      fill_value = np.nan if np.issubdtype(data.dtype, np.floating) else 0
    self._fill = fill_value
    self.meta = VolumeMetadata(
        volume_size=(data.shape[3], data.shape[2], data.shape[1]),
        pixel_size=tuple(float(p) for p in pixel_size),
        num_channels=data.shape[0],
        dtype=data.dtype)

  def __getitem__(self, slices) -> np.ndarray:
    c_sel, z_sel, y_sel, x_sel = slices
    out_shape = []
    src_sel = []
    dst_sel = []
    for sel, n in zip((z_sel, y_sel, x_sel), self.data.shape[1:]):
      start = 0 if sel.start is None else sel.start
      stop = n if sel.stop is None else sel.stop
      size = stop - start
      lo = max(start, 0)
      hi = min(stop, n)
      out_shape.append(size)
      src_sel.append(slice(lo, max(hi, lo)))
      dst_sel.append(slice(lo - start, (lo - start) + max(hi - lo, 0)))
    nc = len(range(*c_sel.indices(self.data.shape[0])))
    out = np.full([nc] + out_shape, self._fill, dtype=self.data.dtype)
    out[(slice(None),) + tuple(dst_sel)] = self.data[
        (c_sel,) + tuple(src_sel)]
    return out

  def write(self, data: np.ndarray, box: BoundingBox) -> None:
    clipped = self.clip_box_to_volume(box)
    if clipped is None:
      return
    rel = clipped.translate(-box.start)
    self.data[clipped.to_slice4d()] = data[rel.to_slice4d()]


class TensorStoreVolume(BaseVolume):
  """TensorStore-backed chunked volume (czyx on-disk layout)."""

  def __init__(self, store, pixel_size: Sequence[float] = (1.0, 1.0, 1.0)):
    self._ts = store
    shape = store.shape  # [c, z, y, x]
    self.meta = VolumeMetadata(
        volume_size=(shape[3], shape[2], shape[1]),
        pixel_size=tuple(float(p) for p in pixel_size),
        num_channels=shape[0],
        dtype=store.dtype.numpy_dtype)

  @classmethod
  def create(cls, path: str, shape: Sequence[int], dtype,
             chunk_size: Sequence[int] = (1, 1, 512, 512),
             pixel_size: Sequence[float] = (1.0, 1.0, 1.0),
             driver: str = 'zarr') -> 'TensorStoreVolume':
    import tensorstore as ts
    spec = {
        'driver': driver,
        'kvstore': {'driver': 'file', 'path': path},
        'metadata': {
            'shape': list(shape),
            'chunks': list(chunk_size),
            'dtype': np.dtype(dtype).str,
        },
        'create': True,
        'delete_existing': True,
    }
    store = ts.open(spec).result()
    return cls(store, pixel_size)

  @classmethod
  def open(cls, spec_or_path,
           pixel_size: Sequence[float] = (1.0, 1.0, 1.0)
           ) -> 'TensorStoreVolume':
    import tensorstore as ts
    if isinstance(spec_or_path, str):
      spec = {'driver': 'zarr',
              'kvstore': {'driver': 'file', 'path': spec_or_path}}
    else:
      spec = spec_or_path
    return cls(ts.open(spec).result(), pixel_size)

  def __getitem__(self, slices) -> np.ndarray:
    return np.asarray(self._ts[slices].read().result())

  def write(self, data: np.ndarray, box: BoundingBox) -> None:
    clipped = self.clip_box_to_volume(box)
    if clipped is None:
      return
    rel = clipped.translate(-box.start)
    self._ts[clipped.to_slice4d()].write(data[rel.to_slice4d()]).result()


class CachingVolume(BaseVolume):
  """LRU read cache over another volume, bounded by a byte budget.

  Serves the processors' chunk caches (WarpByMap's `source_cache_bytes`,
  EstimateMissingFlow's `image_cache_bytes`): repeated reads of the same
  region (EstimateMissingFlow probing the same sections per work item,
  WarpByMap re-reading overlapping source boxes) are served from
  memory. Keys are the exact normalized slice tuples; entries are evicted
  least-recently-used when the budget is exceeded. Thread-safe.
  """

  def __init__(self, base: BaseVolume, cache_bytes: int,
               namespace: str = 'volume_cache'):
    import collections
    import threading
    self._base = base
    self._budget = int(cache_bytes)
    self._cache: 'collections.OrderedDict[tuple, np.ndarray]' = (
        collections.OrderedDict())
    self._bytes = 0
    self._lock = threading.Lock()
    self._namespace = namespace
    self.hits = 0
    self.misses = 0
    self.meta = base.meta

  @staticmethod
  def _key(slices) -> tuple:
    out = []
    for s in slices:
      if isinstance(s, slice):
        out.append(('s', s.start, s.stop, s.step))
      else:
        out.append(('i', int(s)))
    return tuple(out)

  def __getitem__(self, slices) -> np.ndarray:
    from sofima_tpu_torch.utils import metrics
    key = self._key(slices)
    with self._lock:
      if key in self._cache:
        self._cache.move_to_end(key)
        self.hits += 1
        metrics.counter(self._namespace, 'hits').inc()
        return self._cache[key]
    data = self._base[slices]
    with self._lock:
      self.misses += 1
      metrics.counter(self._namespace, 'misses').inc()
      if self._budget > 0 and data.nbytes <= self._budget:
        self._cache[key] = data
        self._bytes += data.nbytes
        while self._bytes > self._budget and self._cache:
          _, evicted = self._cache.popitem(last=False)
          self._bytes -= evicted.nbytes
    return data

  def write(self, data: np.ndarray, box: BoundingBox) -> None:
    with self._lock:
      self._cache.clear()
      self._bytes = 0
    self._base.write(data, box)

  def clip_box_to_volume(self, box: BoundingBox) -> BoundingBox | None:
    return self._base.clip_box_to_volume(box)


def open_volume(spec) -> BaseVolume:
  """Opens a volume from an ndarray, BaseVolume, or TensorStore spec."""
  if isinstance(spec, BaseVolume):
    return spec
  if isinstance(spec, np.ndarray):
    return InMemoryVolume(spec)
  return TensorStoreVolume.open(spec)


def maybe_cache(vol: BaseVolume, cache_bytes: int,
                namespace: str = 'volume_cache') -> BaseVolume:
  """Wraps `vol` in a CachingVolume when a positive budget is given."""
  if cache_bytes and cache_bytes > 0:
    return CachingVolume(vol, cache_bytes, namespace)
  return vol


def decorate_volume(vol: BaseVolume, decorator_specs) -> BaseVolume:
  """Applies TensorStore decorator specs to a volume.

  Each spec names a registered decorator (sofima_tpu_torch.decorators)
  plus its constructor kwargs, as a `{'decorator': <name>, **kwargs}`
  dict or a `(name, kwargs)` tuple; the decorators are applied in order
  to the underlying TensorStore (WarpByMap's `map_decorator_specs` /
  `data_decorator_specs`). In-memory volumes are adapted through the
  TensorStore array driver. Empty specs return the volume itself; an
  unknown name raises KeyError.
  """
  if not decorator_specs:
    return vol
  import tensorstore as ts
  from sofima_tpu_torch.decorators import base as decorators_base

  if isinstance(vol, TensorStoreVolume):
    store = vol._ts
  elif isinstance(vol, InMemoryVolume):
    store = ts.array(vol.data)
  else:
    raise TypeError(f'Cannot decorate volume of type {type(vol)!r}')

  for spec in decorator_specs:
    if isinstance(spec, dict):
      kwargs = dict(spec)
      name = kwargs.pop('decorator')
    else:
      name, kwargs = spec
    dec = decorators_base.build(name, **(kwargs or {}))
    store = dec.decorate(store)
  return TensorStoreVolume(store, pixel_size=vol.meta.pixel_size)
