"""Flow-pipeline configuration (4 stages, EM-2D defaults).

Twin of sofima_tpu/pipeline/flow_config.py: estimate -> reconcile ->
estimate_missing -> reconcile_missing, with scheduling/processing
geometry attached to the estimate stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from sofima_tpu_torch.processor import flow
from sofima_tpu_torch.processor.defaults import em_2d
from sofima_tpu_torch.utils import config_utils


@dataclasses.dataclass(frozen=True)
class ProcessingConfig:
  """Chunking geometry for a pipeline stage (XYZ)."""

  overlap: tuple[int, int, int] = (160, 160, 1)
  subvolume_size: tuple[int, int, int] = (3200, 3200, 128)

  def __post_init__(self):
    object.__setattr__(self, 'overlap', tuple(self.overlap))
    object.__setattr__(self, 'subvolume_size', tuple(self.subvolume_size))


@dataclasses.dataclass(frozen=True)
class EstimateFlowStage:
  config: flow.EstimateFlow.Config
  processing: ProcessingConfig
  schedule_batch_size: int = 16384
  ignore_existing: bool = False
  delete_existing: bool = False
  corner_whitelist: frozenset = frozenset()


@dataclasses.dataclass(frozen=True)
class FlowPipeline:
  """End-to-end flow estimation pipeline configuration."""

  estimate_flow: EstimateFlowStage
  reconcile_flows: flow.ReconcileAndFilterFlows.Config
  estimate_missing_flow: flow.EstimateMissingFlow.Config
  reconcile_missing_flows: flow.ReconcileAndFilterFlows.Config


def default_em_2d(overrides: dict[str, Any] | None = None) -> FlowPipeline:
  """Default flow pipeline configuration for EM 2D data."""
  estimate_config = em_2d.estimate_flow_config()
  if (overrides is not None and 'estimate_flow' in overrides
      and 'config' in overrides['estimate_flow']):
    estimate_config = config_utils.update_dataclass(
        estimate_config, overrides['estimate_flow']['config'])

  config = FlowPipeline(
      estimate_flow=EstimateFlowStage(
          config=estimate_config,
          processing=ProcessingConfig(
              overlap=(160, 160, estimate_config.z_stride),
              subvolume_size=(3200, 3200, 128))),
      reconcile_flows=em_2d.reconcile_flows_config(),
      estimate_missing_flow=em_2d.estimate_missing_flow_config(),
      reconcile_missing_flows=em_2d.reconcile_missing_flows_config())
  if overrides is not None:
    config = config_utils.update_dataclass(config, overrides)
  return config


config_utils.register_default_config(em_2d.EM_2D, FlowPipeline,
                                     default_em_2d)
