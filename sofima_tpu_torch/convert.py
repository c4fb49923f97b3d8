"""Carrying configurations and state between sofima_tpu and the port.

SOFIMA has no weights: its parameters are the config dataclasses and its
state is the solved mesh and the coordinate maps. This module moves both
across without importing JAX:

  * `config_from_jax(obj)` builds the port's StackAlignConfig,
    Stitch3dConfig, MontageConfig or IntegrationConfig from a sofima_tpu
    config (any object with the same dataclass fields), via
    `dataclasses.asdict`;
  * `map_from_numpy` / `map_to_numpy` convert [2|3, z, y, x] maps,
    [2, 1, G, G] solved section meshes and [3, n, gz, gy, gx] stitched
    tile meshes between numpy (what `np.asarray` of a JAX array gives)
    and torch, keeping layout, dtype and NaN exactly.

IntegrationConfig.to_json of both packages produces the same string.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sofima_tpu_torch import mesh
from sofima_tpu_torch import placement
from sofima_tpu_torch.pipeline import montage
from sofima_tpu_torch.pipeline import stack_align
from sofima_tpu_torch.pipeline import stitch3d


def config_from_jax(obj):
  """Port config equal field by field to a sofima_tpu config dataclass.

  Accepts sofima_tpu's StackAlignConfig, Stitch3dConfig or MontageConfig
  (nested mesh config included) or IntegrationConfig; the type is
  recognized by its fields.
  """
  if not dataclasses.is_dataclass(obj):
    raise TypeError(f'expected a config dataclass, got {type(obj)!r}')
  d = dataclasses.asdict(obj)
  names = set(d)
  if names == {f.name for f in dataclasses.fields(mesh.IntegrationConfig)}:
    return mesh.IntegrationConfig(**d)
  if names == {f.name for f in dataclasses.fields(
      stack_align.StackAlignConfig)}:
    d['mesh'] = mesh.IntegrationConfig(**d['mesh'])
    return stack_align.StackAlignConfig(**d)
  for cls in (stitch3d.Stitch3dConfig, montage.MontageConfig):
    if names == {f.name for f in dataclasses.fields(cls)}:
      d['mesh_cfg'] = mesh.IntegrationConfig(**d['mesh_cfg'])
      return cls(**d)
  raise TypeError(f'unrecognized config type {type(obj).__name__}')


def _check_map(shape) -> None:
  if len(shape) not in (4, 5) or shape[0] not in (2, 3):
    raise ValueError(f'expected a [2|3, z, y, x] map or a [3, n, z, y, x] '
                     f'mesh stack, got {tuple(shape)}')


def map_from_numpy(array, device=None) -> torch.Tensor:
  """[2|3, z, y, x] map, [2, 1, G, G] mesh or [3, n, gz, gy, gx] tile
  meshes -> torch (same dtype, NaN) on `device` (default: the CUDA card;
  without one, pass device='cpu')."""
  arr = np.asarray(array)
  _check_map(arr.shape)
  return placement.place(arr, device)


def map_to_numpy(tensor: torch.Tensor) -> np.ndarray:
  """torch map or mesh -> numpy (same layout, dtype and NaN)."""
  _check_map(tensor.shape)
  return tensor.detach().cpu().numpy().copy()
