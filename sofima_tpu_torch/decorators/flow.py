"""Flow-field decorators (lazy TensorStore views).

Twin of sofima_tpu/decorators/flow.py: flow estimation against a fixed
volume (`OptimFlow`), flow cleaning (`CleanFlowFilter`), per-chunk mesh
relaxation (`MeshRelaxFlowFilter`) and single-flow reconciliation
(`ReconcileFlowFilter`). Output volumes use the `fc, fz, fy, fx` label
convention.

Each chunk's computation is a module-level function of arrays in and
arrays out (`_optim_flow`, `_clean_flow`, `_mesh_relax_flow`,
`_reconcile_flow`); `decorate` only wraps it in `ts.virtual_chunked`.
They run on `device` (default: the CUDA card): `OptimFlow` reads it from
the reference's `jax_device` ('cpu' is the CPU; None, 'gpu' and 'cuda'
the card), the filters from a `device=` keyword among their arguments.
On the card, `OptimFlow` in a circular mode launches K1 (K5 with masks),
`MeshRelaxFlowFilter` K8 in 2d and K9 in 3d.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from sofima_tpu_torch import flow_field as flow_field_lib
from sofima_tpu_torch import flow_utils
from sofima_tpu_torch import mesh as mesh_lib
from sofima_tpu_torch import placement
from sofima_tpu_torch.decorators.base import (Decorator, Filter, JsonSpec,
                                              MutableJsonSpec, register)


def _clean_flow(flow: np.ndarray, device=None, **filter_args) -> np.ndarray:
  final_shape = list(flow.shape)
  final_shape[0] -= 2
  return flow_utils.clean_flow(
      flow.squeeze(), dim=flow.shape[0] - 2, device=device,
      **filter_args).reshape(final_shape)


@register
class CleanFlowFilter(Filter):
  """Lazy flow cleaning; shrinks the channel dim by the 2 stat channels."""

  def __init__(self, min_chunksize: Optional[Sequence[int]] = None,
               context_spec: Optional[MutableJsonSpec] = None,
               **filter_args):
    super().__init__(filter_fun=_clean_flow, context_spec=context_spec,
                     min_chunksize=min_chunksize, **filter_args)

  def decorate(self, input_ts):
    import tensorstore as ts
    json = self._schema(input_ts).to_json()
    json['chunk_layout']['read_chunk']['shape'][0] -= 2
    json['chunk_layout']['write_chunk']['shape'][0] -= 2
    bound = json['domain']['exclusive_max'][0]
    # Implicit bounds are encoded as 1-element lists in the JSON schema.
    if isinstance(bound, list):
      bound[0] -= 2
    else:
      json['domain']['exclusive_max'][0] = bound - 2
    return ts.virtual_chunked(self._read_fn(input_ts),
                              schema=ts.Schema(json), context=self._context)


def _mesh_relax_flow(flow: np.ndarray, device=None,
                     **filter_args) -> np.ndarray:
  """Relaxes a mesh from x = 0 with `prev = flow` (2 or 3 channels; K8
  in 2d, K9 in 3d on the card); the positions, in `flow`'s shape."""
  cfg = mesh_lib.IntegrationConfig(**filter_args)
  prev = placement.place(flow.squeeze(), device, torch.float32)
  dim = flow.shape[0]
  if dim == 2:
    res = mesh_lib.relax_mesh(torch.zeros_like(prev), prev, cfg)
  elif dim == 3:
    res = mesh_lib.relax_mesh(torch.zeros_like(prev), prev, cfg,
                              mesh_force=mesh_lib.elastic_mesh_3d)
  else:
    raise ValueError(f'flow must have 2 or 3 channels, got {dim}')
  return placement.to_host(res[0]).reshape(flow.shape)


@register
class MeshRelaxFlowFilter(Filter):
  """Lazy per-chunk mesh relaxation of a flow volume."""

  def __init__(self, min_chunksize: Optional[Sequence[int]] = None,
               context_spec: Optional[MutableJsonSpec] = None,
               **filter_args):
    super().__init__(filter_fun=_mesh_relax_flow, context_spec=context_spec,
                     min_chunksize=min_chunksize, **filter_args)


def _reconcile_flow(flow: np.ndarray, device=None,
                    **filter_args) -> np.ndarray:
  return flow_utils.reconcile_flows(
      [flow.squeeze()], device=device, **filter_args).reshape(flow.shape)


@register
class ReconcileFlowFilter(Filter):
  """Lazy gradient/median/patch filtering of a single flow volume."""

  def __init__(self, min_chunksize: Optional[Sequence[int]] = None,
               context_spec: Optional[MutableJsonSpec] = None,
               **filter_args):
    super().__init__(filter_fun=_reconcile_flow, context_spec=context_spec,
                     min_chunksize=min_chunksize, **filter_args)


def _flow_shape(o, p, s):
  return np.ceil((o - p + 1) / s).astype(int)


def _padded_flow_shape(o, p, s):
  return _flow_shape(o, p, s) + p // s - 1


def _torch_device(jax_device: Optional[str]):
  """The torch device of OptimFlow's `jax_device`: None and 'gpu' are the
  CUDA card, anything else names a torch device ('cpu', 'cuda')."""
  return None if jax_device in (None, 'gpu') else jax_device


def _optim_flow(input_image: np.ndarray, fixed_image: np.ndarray,
                patch_zyx: Sequence[int], step_zyx: Sequence[int],
                batch_size: int = 1, pad: bool = True,
                input_mask: Optional[np.ndarray] = None,
                fixed_mask: Optional[np.ndarray] = None,
                invert_masks: bool = False, device=None,
                **flow_args) -> np.ndarray:
  """OptimFlow's chunk: the flow of `input_image` (pre) against
  `fixed_image` (post).

  Images and masks come in xy[z] axis order, as the decorator reads them
  (squeezed), and are transposed to [z]yx. Returns [c, z, y, x] float32
  (a 2d flow gets a singleton z); with `pad`, NaN-padded by
  patch // step // 2 nodes on the left and patch // step - 1 in all.
  """
  def mask(m):
    if m is None:
      return None
    m = np.asarray(m, dtype=bool).T
    return ~m if invert_masks else m

  mfc = flow_field_lib.JAXMaskedXCorrWithStatsCalculator(device=device)
  flow = mfc.flow_field(
      pre_image=np.asarray(input_image, dtype=np.float32).T,
      post_image=np.asarray(fixed_image, dtype=np.float32).T,
      pre_mask=mask(input_mask), post_mask=mask(fixed_mask),
      patch_size=tuple(patch_zyx), step=tuple(step_zyx),
      batch_size=batch_size, **flow_args)
  num_image_dims = np.ndim(input_image)
  if num_image_dims == 2:
    flow = flow[:, np.newaxis]
  if not pad:
    return flow
  pad_total = np.array(patch_zyx) // np.array(step_zyx) - 1
  pad_left = np.array(patch_zyx) // np.array(step_zyx) // 2
  pad_width = [(0, 0)]
  if num_image_dims == 2:
    pad_width.append((0, 0))
  for left, total in zip(pad_left, pad_total):
    pad_width.append((left, total - left))
  return np.pad(flow, pad_width, constant_values=np.nan)


@register
class OptimFlow(Decorator):
  """Lazy flow estimation of the input volume against a fixed volume.

  Output dims: `fc` (flow + stat channels), `fz`, `fy`, `fx`, followed by
  any non-image input dims. With `pad=True` the flow grid is NaN-padded
  to patch/step alignment for downstream composition. `mode=` among
  `flow_args` selects the calculator's padfield (default) or a circular
  mode.
  """

  def __init__(self, fixed_spec: JsonSpec,
               image_dims: Sequence[str] = ('x', 'y'),
               context_spec: Optional[MutableJsonSpec] = None,
               patch_size: Sequence[int] = (32, 32),
               step_size: Sequence[int] = (16, 16),
               batch_size: int = 1,
               pad: bool = True,
               input_mask_spec: Optional[JsonSpec] = None,
               fixed_mask_spec: Optional[JsonSpec] = None,
               invert_masks: bool = False,
               jax_device: Optional[str] = None,
               **flow_args):
    super().__init__(context_spec)
    self._fixed_spec = fixed_spec
    self._image_dims = image_dims
    self._patch_zyx = tuple(patch_size[::-1])
    self._step_zyx = tuple(step_size[::-1])
    self._batch_size = batch_size
    self._pad = pad
    self._input_mask_spec = input_mask_spec
    self._fixed_mask_spec = fixed_mask_spec
    self._invert_masks = invert_masks
    self._jax_device = jax_device
    self._flow_args = flow_args

  def _check_compatible(self, input_ts, other_ts, what: str):
    if input_ts.domain.labels != other_ts.domain.labels:
      raise ValueError(f'Input and {what} must have the same labels: '
                       f'{input_ts.domain.labels} vs '
                       f'{other_ts.domain.labels}')
    if input_ts.shape != other_ts.shape:
      raise ValueError(f'Input and {what} must have the same shape: '
                       f'{input_ts.shape} vs {other_ts.shape}')

  def decorate(self, input_ts):
    import tensorstore as ts

    fixed_ts = ts.open(self._fixed_spec).result()
    self._check_compatible(input_ts, fixed_ts, 'fixed volume')

    num_image_dims = len(self._image_dims)
    if num_image_dims not in (2, 3):
      raise ValueError('2 or 3 image dims required, got '
                       f'{num_image_dims}')
    for d in self._image_dims:
      if d not in input_ts.domain.labels:
        raise ValueError(f'image dim {d} not in {input_ts.domain.labels}')

    mask_ts = []
    for spec, what in ((self._input_mask_spec, 'input mask'),
                       (self._fixed_mask_spec, 'fixed mask')):
      store = None
      if spec is not None:
        store = ts.open(spec).result()
        self._check_compatible(input_ts, store, what)
      mask_ts.append(store)

    non_image_dims = [l for l in input_ts.domain.labels
                      if l not in self._image_dims]
    input_domain = {dim.label: dim for dim in list(input_ts.domain)}
    device = _torch_device(self._jax_device)

    def read_fn(domain, array, unused_params):
      domain_dict = {dim.label: dim for dim in list(domain)}
      read_domain = ts.IndexDomain(
          [domain_dict[l] for l in non_image_dims]
          + [input_domain[l] for l in self._image_dims])

      def read(store, dtype):
        return (None if store is None
                else np.array(store[read_domain], dtype=dtype).squeeze())

      array[...] = _optim_flow(
          read(input_ts, np.float32), read(fixed_ts, np.float32),
          self._patch_zyx, self._step_zyx, self._batch_size, self._pad,
          read(mask_ts[0], bool), read(mask_ts[1], bool),
          self._invert_masks, device, **self._flow_args).reshape(array.shape)

    labels = ['fc', 'fz', 'fy', 'fx'] + non_image_dims
    flow_shape = {'fc': num_image_dims + 2}
    if num_image_dims == 2:
      flow_shape['fz'] = 1
    calc = _padded_flow_shape if self._pad else _flow_shape
    for i, l in enumerate(self._image_dims):
      flow_shape[labels[3 - i]] = calc(
          o=input_domain[l].size, p=self._patch_zyx[-1 - i],
          s=self._step_zyx[-1 - i])

    chunksize = [1 if l in non_image_dims else int(flow_shape[l])
                 for l in labels]
    schema = {
        'chunk_layout': {'read_chunk': {'shape': chunksize},
                         'write_chunk': {'shape': chunksize}},
        'domain': {
            'labels': labels,
            'inclusive_min': [0] * 4 + [
                input_domain[l].inclusive_min for l in non_image_dims],
            'exclusive_max': [int(flow_shape[l]) for l in labels[:4]] + [
                input_domain[l].exclusive_max for l in non_image_dims],
        },
        'dtype': 'float32',
        'rank': len(chunksize),
    }
    return ts.virtual_chunked(read_fn, schema=ts.Schema(schema),
                              context=self._context)
