"""Warp/render pipeline configuration.

Twin of sofima_tpu/pipeline/warp_config.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from sofima_tpu_torch.processor import warp
from sofima_tpu_torch.processor.defaults import em_2d
from sofima_tpu_torch.utils import config_utils


@dataclasses.dataclass(frozen=True)
class WarpPipelineConfig:
  warp: warp.WarpByMap.Config


def default_em_2d(overrides: dict[str, Any] | None = None
                  ) -> WarpPipelineConfig:
  config = WarpPipelineConfig(warp=em_2d.warp_config())
  if overrides is not None:
    config = config_utils.update_dataclass(config, overrides)
  return config


config_utils.register_default_config(em_2d.EM_2D, WarpPipelineConfig,
                                     default_em_2d)
