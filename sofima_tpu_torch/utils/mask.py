"""Structured mask configuration: threshold/invert/combine semantics.

Twin of sofima_tpu/utils/mask.py (numpy only; the port keeps its own
copy), the in-framework equivalent of connectomics' MaskConfigs as plain
dataclasses:

  * per-channel value selection — threshold interval [min_value,
    max_value], or an explicit `values` set — with optional inversion;
  * multiple channels within one mask source, OR-combined;
  * multiple mask sources, combined with a configurable boolean op.

Masks follow the framework-wide convention: True = masked (excluded).
Configs round-trip through dicts (`parse`) so they can live in pipeline
configuration files.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np

from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils import volume as volume_lib


@dataclasses.dataclass
class MaskChannelConfig:
  """Selects masked voxels from one channel of a mask volume.

  A voxel is masked when its value falls inside [min_value, max_value]
  (or, when `values` is given, inside that explicit set); `invert` flips
  the selection for this channel.
  """
  channel: int = 0
  min_value: float = 1.0
  max_value: float = math.inf
  values: Sequence[int] | None = None
  invert: bool = False

  def apply(self, data: np.ndarray) -> np.ndarray:
    if self.values is not None:
      sel = np.isin(data, np.asarray(self.values))
    else:
      sel = (data >= self.min_value) & (data <= self.max_value)
    return ~sel if self.invert else sel


@dataclasses.dataclass
class MaskConfig:
  """One mask source: a volume plus per-channel selection rules.

  `volume` is anything `volume_lib.open_volume` accepts (ndarray,
  BaseVolume, TensorStore spec). Channels are OR-combined; `invert`
  flips the combined result.
  """
  volume: Any = None
  channels: Sequence[MaskChannelConfig] = dataclasses.field(
      default_factory=lambda: [MaskChannelConfig()])
  invert: bool = False

  def build(self, box: BoundingBox,
            opener: Callable[[Any], volume_lib.BaseVolume] | None = None
            ) -> np.ndarray:
    opener = opener or volume_lib.open_volume
    vol = opener(self.volume)
    out = None
    for ch in self.channels:
      data = vol[(slice(ch.channel, ch.channel + 1),)
                 + box.to_slice4d()[1:]][0]
      m = ch.apply(data)
      out = m if out is None else (out | m)
    if out is None:
      out = np.zeros(tuple(int(s) for s in box.size[::-1]), bool)
    return ~out if self.invert else out


@dataclasses.dataclass
class MaskConfigs:
  """A combination of mask sources.

  combine: 'or' (union of masked voxels, the reference default), 'and'
  (intersection), or 'xor'.
  """
  masks: Sequence[MaskConfig] = dataclasses.field(default_factory=list)
  combine: str = 'or'

  def build(self, box: BoundingBox,
            opener: Callable[[Any], volume_lib.BaseVolume] | None = None
            ) -> np.ndarray:
    op = {'or': np.logical_or, 'and': np.logical_and,
          'xor': np.logical_xor}[self.combine]
    out = None
    for cfg in self.masks:
      m = cfg.build(box, opener)
      out = m if out is None else op(out, m)
    if out is None:
      out = np.zeros(tuple(int(s) for s in box.size[::-1]), bool)
    return out


def parse(obj) -> MaskConfigs:
  """Builds MaskConfigs from dataclasses, dicts, or lists thereof.

  Accepted inputs: MaskConfigs, MaskConfig, a dict matching either
  dataclass, or a sequence of MaskConfig/dicts (OR-combined).
  """
  if isinstance(obj, MaskConfigs):
    return obj
  if isinstance(obj, MaskConfig):
    return MaskConfigs(masks=[obj])
  if isinstance(obj, dict):
    if 'masks' in obj:
      return MaskConfigs(
          masks=[_parse_one(m) for m in obj['masks']],
          combine=obj.get('combine', 'or'))
    return MaskConfigs(masks=[_parse_one(obj)])
  if isinstance(obj, (list, tuple)):
    return MaskConfigs(masks=[_parse_one(m) for m in obj])
  raise TypeError(f'Cannot parse mask configs from {type(obj)!r}')


def _parse_one(obj) -> MaskConfig:
  if isinstance(obj, MaskConfig):
    return obj
  if not isinstance(obj, dict):
    raise TypeError(f'Cannot parse mask config from {type(obj)!r}')
  kwargs = dict(obj)
  channels = kwargs.pop('channels', None)
  if channels is not None:
    kwargs['channels'] = [
        ch if isinstance(ch, MaskChannelConfig) else MaskChannelConfig(**ch)
        for ch in channels
    ]
  return MaskConfig(**kwargs)


def build_mask(configs, box: BoundingBox,
               opener: Callable[[Any], volume_lib.BaseVolume] | None = None
               ) -> np.ndarray:
  """Returns the ZYX boolean mask (True = masked) for `box`."""
  return parse(configs).build(box, opener)
