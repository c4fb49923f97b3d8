"""Mesh-relaxation pipeline configuration (hierarchical block solve).

Twin of sofima_tpu/pipeline/mesh_config.py: the within-block,
last-section, and cross-block RelaxMesh configs plus the cross-block
reconciliation stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from sofima_tpu_torch.processor import maps, mesh
from sofima_tpu_torch.processor.defaults import em_2d
from sofima_tpu_torch.utils import config_utils


@dataclasses.dataclass(frozen=True)
class MeshRelaxationConfig:
  within_block_config: mesh.RelaxMesh.Config
  last_section_config: mesh.RelaxMesh.Config
  cross_block_config: mesh.RelaxMesh.Config
  reconcile_cross_block_config: maps.ReconcileCrossBlockMaps.Config


def default_em_2d(overrides: dict[str, Any] | None = None
                  ) -> MeshRelaxationConfig:
  config = MeshRelaxationConfig(
      within_block_config=em_2d.within_block_config(),
      last_section_config=em_2d.last_section_config(),
      cross_block_config=em_2d.cross_block_config(),
      reconcile_cross_block_config=em_2d.reconcile_cross_block_config())
  if overrides is not None:
    config = config_utils.update_dataclass(config, overrides)
  return config


config_utils.register_default_config(em_2d.EM_2D, MeshRelaxationConfig,
                                     default_em_2d)
