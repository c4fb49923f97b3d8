"""Affine-registration decorators (lazy TensorStore views).

Twin of sofima_tpu/decorators/affine.py: section-wise ECC affine
estimation (`OptimAffineTransformSectionwise`) and phase-correlation
translation estimation (`OptimTranslationTransform`) against a fixed
volume, emitting float64 [r, c]-dimensioned transform volumes. Both run
on the port's registration ops (ops.registration, plain torch) on
`device` (default: the CUDA card), read from a `device=` keyword among
the optimizer arguments. Each chunk's solve is a module-level function
of arrays (`_optim_affine_sections`, `_optim_translation`).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from sofima_tpu_torch.decorators.base import (Decorator, JsonSpec,
                                              MutableJsonSpec, register)
from sofima_tpu_torch.ops import registration


def _check_same(input_ts, other_ts, what):
  if input_ts.domain.labels != other_ts.domain.labels:
    raise ValueError(f'Input and {what} labels differ: '
                     f'{input_ts.domain.labels} vs '
                     f'{other_ts.domain.labels}')
  if input_ts.shape != other_ts.shape:
    raise ValueError(f'Input and {what} shapes differ: '
                     f'{input_ts.shape} vs {other_ts.shape}')


def _optim_affine_sections(sections: Iterable, transform_initial=None,
                           init_previous: bool = False,
                           **optim_args) -> np.ndarray:
  """ECC transforms of (fixed, moving) section pairs ([x, y] arrays),
  taken in order -> [2, 3, n] float64. With `init_previous`, each solve
  starts from the previous section's transform (drift tracking through
  a stack), else every one from `transform_initial`."""
  init = (np.array(transform_initial, np.float32)
          if transform_initial is not None else None)
  out = []
  for fix, mov in sections:
    _, transform = registration.optim_transform(
        fix=fix, mov=mov, transform_initial=init, **optim_args)
    if init_previous:
      init = transform.astype(np.float32)
    out.append(transform)
  return np.stack(out, axis=-1)


@register
class OptimAffineTransformSectionwise(Decorator):
  """Per-section 2d affine estimation by on-device ECC optimization.

  Emits [2, 3] matrices in dims 'r'/'c' for every non-image coordinate.
  With `batch_dim` + `init_previous`, consecutive sections of a batch
  chain their initial transforms (drift tracking through a stack).
  """

  def __init__(self, fixed_spec: JsonSpec,
               image_dims: Sequence[str] = ('x', 'y'),
               batch_dim: Optional[str] = None,
               init_previous: bool = False,
               context_spec: Optional[MutableJsonSpec] = None,
               **optim_args):
    super().__init__(context_spec)
    self._fixed_spec = fixed_spec
    self._image_dims = image_dims
    self._batch_dim = batch_dim
    self._init_previous = init_previous
    if init_previous and not batch_dim:
      raise ValueError('batch_dim required for init_previous')
    self._transform_initial = optim_args.pop('transform_initial', None)
    self._optim_args = optim_args

  def decorate(self, input_ts):
    import tensorstore as ts
    fixed_ts = ts.open(self._fixed_spec).result()
    _check_same(input_ts, fixed_ts, 'fixed volume')
    if len(self._image_dims) != 2:
      raise ValueError('2 image dims required')
    for d in self._image_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'image dim {d} not in {input_ts.domain.labels}')

    non_image = [l for l in input_ts.domain.labels
                 if l not in self._image_dims]
    input_domain = {dim.label: dim for dim in list(input_ts.domain)}

    def read_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      if not self._batch_dim:
        batch = [None]
      else:
        dim = domain_dict[self._batch_dim]
        batch = range(dim.inclusive_min, dim.exclusive_max)

      def sections():
        # read_domain orders image dims (x, y) last -> arrays are already
        # in the xy convention optim_transform expects.
        for j in batch:
          read_domain = ts.IndexDomain([
              domain_dict[l] if l != self._batch_dim else ts.Dim(
                  inclusive_min=j, exclusive_max=j + 1, label=l)
              for l in non_image] + [input_domain[l]
                                     for l in self._image_dims])
          yield (np.array(fixed_ts[read_domain], np.float32).squeeze(),
                 np.array(input_ts[read_domain], np.float32).squeeze())

      array[...] = _optim_affine_sections(
          sections(), self._transform_initial, self._init_previous,
          **self._optim_args).reshape(array.shape)

    chunksize = [2, 3] + [1] * len(non_image)
    schema = {
        'chunk_layout': {'read_chunk': {'shape': chunksize},
                         'write_chunk': {'shape': chunksize}},
        'domain': {
            'labels': ['r', 'c'] + non_image,
            'inclusive_min': [0, 0] + [
                input_domain[l].inclusive_min for l in non_image],
            'exclusive_max': [2, 3] + [
                input_domain[l].exclusive_max for l in non_image],
        },
        'dtype': 'float64',
        'rank': len(chunksize),
    }
    return ts.virtual_chunked(read_fn, schema=ts.Schema(schema),
                              context=self._context)


def _optim_translation(fix: np.ndarray, mov: np.ndarray,
                       **optim_args) -> np.ndarray:
  """Phase-correlation translation of `mov` onto `fix` (2d or 3d, image
  order) -> [n, n + 1] float64 translation matrix."""
  args = dict(optim_args)
  args.setdefault('normalization', None)
  translation, _, _ = registration.phase_cross_correlation(
      reference_image=fix, moving_image=mov, **args)
  return np.hstack([np.eye(fix.ndim), translation.reshape(-1, 1)])


@register
class OptimTranslationTransform(Decorator):
  """2d/3d translation estimation via on-device phase correlation.

  Emits [n, n+1] translation matrices in dims 'r'/'c' for every
  non-image coordinate.
  """

  def __init__(self, fixed_spec: JsonSpec,
               image_dims: Sequence[str] = ('x', 'y'),
               context_spec: Optional[MutableJsonSpec] = None,
               **optim_args):
    super().__init__(context_spec)
    self._fixed_spec = fixed_spec
    self._image_dims = image_dims
    self._optim_args = optim_args

  def decorate(self, input_ts):
    import tensorstore as ts
    fixed_ts = ts.open(self._fixed_spec).result()
    _check_same(input_ts, fixed_ts, 'fixed volume')
    ndim = len(self._image_dims)
    if ndim not in (2, 3):
      raise ValueError('2 or 3 image dims required')
    for d in self._image_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'image dim {d} not in {input_ts.domain.labels}')

    non_image = [l for l in input_ts.domain.labels
                 if l not in self._image_dims]
    input_domain = {dim.label: dim for dim in list(input_ts.domain)}

    def read_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      read_domain = ts.IndexDomain(
          [domain_dict[l] for l in non_image]
          + [input_domain[l] for l in self._image_dims])
      array[...] = _optim_translation(
          np.array(fixed_ts[read_domain], np.float32).squeeze(),
          np.array(input_ts[read_domain], np.float32).squeeze(),
          **self._optim_args).reshape(array.shape)

    chunksize = [ndim, ndim + 1] + [1] * len(non_image)
    schema = {
        'chunk_layout': {'read_chunk': {'shape': chunksize},
                         'write_chunk': {'shape': chunksize}},
        'domain': {
            'labels': ['r', 'c'] + non_image,
            'inclusive_min': [0, 0] + [
                input_domain[l].inclusive_min for l in non_image],
            'exclusive_max': [ndim, ndim + 1] + [
                input_domain[l].exclusive_max for l in non_image],
        },
        'dtype': 'float64',
        'rank': len(chunksize),
    }
    return ts.virtual_chunked(read_fn, schema=ts.Schema(schema),
                              context=self._context)
