"""TensorStore virtual_chunked decorators: the lazy / streaming API plane.

Twin of sofima_tpu/decorators/base.py (the port keeps its own registry):
computations wrapped as lazily evaluated `ts.virtual_chunked` volumes,
so TensorStore pipelines stream flow estimation, map algebra and warping
on demand. A plain name registry (`register` / `build`) stands in for
the upstream `gin` wiring; its names are the reference's. tensorstore is
imported inside the functions that use it, so this package imports on a
machine without it.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, MutableMapping, Sequence

import numpy as np

JsonSpec = Mapping[str, Any]
MutableJsonSpec = MutableMapping[str, Any]

_REGISTRY: dict[str, type] = {}


def register(cls):
  """Class decorator registering a Decorator under its class name."""
  _REGISTRY[cls.__name__] = cls
  return cls


def build(name: str, **kwargs) -> 'Decorator':
  if name not in _REGISTRY:
    raise KeyError(f'Unknown decorator {name!r}; '
                   f'known: {sorted(_REGISTRY)}')
  return _REGISTRY[name](**kwargs)


def registered() -> list[str]:
  return sorted(_REGISTRY)


def _ts():
  import tensorstore as ts
  return ts


class Decorator:
  """Base: wraps an input TensorStore in a computed virtual view."""

  def __init__(self, context_spec: MutableJsonSpec | None = None):
    ts = _ts()
    if context_spec is None:
      context_spec = {'cache_pool': {'total_bytes_limit': 1_000_000_000}}
    # A dedicated data-copy pool is REQUIRED: read_fn callbacks run on
    # the virtual_chunked context's pool, and nested synchronous reads of
    # source stores deadlock if both share the default global pool.
    context_spec.setdefault('data_copy_concurrency', {'limit': 8})
    self._context = ts.Context(context_spec)

  def decorate(self, input_ts):
    raise NotImplementedError


def adjust_schema_for_virtual_chunked(schema):
  """Strips storage-specific fields so a schema fits virtual_chunked."""
  ts = _ts()
  json = schema.to_json()
  json.pop('codec', None)
  json.pop('fill_value', None)
  return ts.Schema(json)


def adjust_schema_for_chunksize(schema, min_chunksize: Sequence[int]):
  ts = _ts()
  json = schema.to_json()
  shape = json['chunk_layout']['read_chunk']['shape']
  new = [max(c, m) for c, m in zip(shape, min_chunksize)]
  json['chunk_layout']['read_chunk']['shape'] = new
  json['chunk_layout']['write_chunk']['shape'] = new
  return ts.Schema(json)


def _full_channel_domain(domain, input_ts):
  """`domain` with its first (channel) dimension widened to the input's
  whole extent."""
  ts = _ts()
  read_domain = list(domain)
  read_domain[0] = ts.Dim(inclusive_min=0, exclusive_max=input_ts.shape[0],
                          label=input_ts.domain.labels[0])
  return ts.IndexDomain(read_domain)


class Filter(Decorator):
  """Applies `filter_fun` to whole-extent reads of the input volume.

  The filter function receives the full [c, z, y, x]-like array for the
  requested chunk (with the channel dimension always read in full) and
  must return an array matching the output chunk.
  """

  def __init__(self, filter_fun: Callable[..., np.ndarray],
               context_spec: MutableJsonSpec | None = None,
               min_chunksize: Sequence[int] | None = None,
               **filter_args):
    super().__init__(context_spec)
    self._filter_fun = filter_fun
    self._filter_args = filter_args
    self._min_chunksize = min_chunksize

  def _read_fn(self, input_ts):
    def read_fn(domain, array, unused_params):
      array[...] = self._filter_fun(
          np.array(input_ts[_full_channel_domain(domain, input_ts)]),
          **self._filter_args)
    return read_fn

  def _schema(self, input_ts):
    schema = input_ts.schema
    if self._min_chunksize is not None:
      schema = adjust_schema_for_chunksize(schema, self._min_chunksize)
    return adjust_schema_for_virtual_chunked(schema)

  def decorate(self, input_ts):
    return _ts().virtual_chunked(self._read_fn(input_ts),
                                 schema=self._schema(input_ts),
                                 context=self._context)
