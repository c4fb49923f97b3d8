"""Canonical parameter sets for 2d serial-section EM alignment.

Twin of sofima_tpu/processor/defaults/em_2d.py: the same factories with
the same values (the production settings of the em_2d workflow); each
takes optional deep-override dicts and is registered in the port's own
default-config registry (sofima_tpu_torch.utils.config_utils).
"""

from __future__ import annotations

from typing import Any

from sofima_tpu_torch import mesh as mesh_lib
from sofima_tpu_torch.processor import flow, maps, mesh, warp
from sofima_tpu_torch.utils import config_utils

EM_2D = 'em_2d'


def _with_overrides(config, overrides):
  if overrides is not None:
    config = config_utils.update_dataclass(config, overrides)
  return config


def estimate_flow_config(overrides: dict[str, Any] | None = None
                         ) -> flow.EstimateFlow.Config:
  return _with_overrides(
      flow.EstimateFlow.Config(
          patch_size=160, stride=40, z_stride=1, fixed_current=False,
          mask_configs=None, mask_only_for_patch_selection=True,
          selection_mask_configs=None, batch_size=1024), overrides)


def reconcile_flows_config(overrides: dict[str, Any] | None = None
                           ) -> flow.ReconcileAndFilterFlows.Config:
  return _with_overrides(
      flow.ReconcileAndFilterFlows.Config(
          flow_volinfos=None, mask_configs=None, min_peak_ratio=1.6,
          min_peak_sharpness=1.6, max_magnitude=40, max_deviation=10,
          max_gradient=40, min_patch_size=400, multi_section=False,
          base_delta_z=1), overrides)


def estimate_missing_flow_config(overrides: dict[str, Any] | None = None
                                 ) -> flow.EstimateMissingFlow.Config:
  return _with_overrides(
      flow.EstimateMissingFlow.Config(
          patch_size=160, stride=40, delta_z=1, max_delta_z=4,
          max_attempts=2, mask_configs=None,
          mask_only_for_patch_selection=True, selection_mask_configs=None,
          min_peak_ratio=1.6, min_peak_sharpness=1.6, max_magnitude=40,
          batch_size=1024, image_volinfo=None,
          image_cache_bytes=int(1e9), mask_cache_bytes=int(1e9),
          search_radius=0), overrides)


def reconcile_missing_flows_config(overrides: dict[str, Any] | None = None
                                   ) -> flow.ReconcileAndFilterFlows.Config:
  config = config_utils.update_dataclass(
      reconcile_flows_config(),
      {'multi_section': True, 'max_magnitude': 0, 'max_deviation': 10,
       'max_gradient': 10, 'min_patch_size': 400, 'base_delta_z': 1})
  return _with_overrides(config, overrides)


def relax_mesh_config(overrides: dict[str, Any] | None = None
                      ) -> mesh.RelaxMesh.Config:
  return _with_overrides(
      mesh.RelaxMesh.Config(
          output_dir='NONE',
          integration_config=mesh_lib.IntegrationConfig(
              dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40, 40),
              num_iters=1000, max_iters=100000, stop_v_max=0.005,
              dt_max=1000, start_cap=0.01, final_cap=10,
              prefer_orig_order=True),
          mesh=None, flows=[], sections_to_skip=[], ranges_to_skip=[],
          mask=None, block_starts=[], block_ends=[], backward=False,
          mesh_min_frac=0.5, mesh_max_frac=2.0, coming_in=[],
          options=mesh.MeshOptions(irregular_mask_radius=5)), overrides)


def within_block_config(overrides: dict[str, Any] | None = None
                        ) -> mesh.RelaxMesh.Config:
  return _with_overrides(relax_mesh_config(), overrides)


def last_section_config(overrides: dict[str, Any] | None = None
                        ) -> mesh.RelaxMesh.Config:
  return _with_overrides(relax_mesh_config(), overrides)


def cross_block_config(overrides: dict[str, Any] | None = None
                       ) -> mesh.RelaxMesh.Config:
  config = relax_mesh_config({
      'integration_config': {
          'k0': 0.001, 'stride': (320, 320), 'stop_v_max': 0.001},
      'options': {'init_state': mesh.MeshInitState.PREV_MEDIAN},
  })
  return _with_overrides(config, overrides)


def reconcile_cross_block_config(overrides: dict[str, Any] | None = None
                                 ) -> maps.ReconcileCrossBlockMaps.Config:
  return _with_overrides(
      maps.ReconcileCrossBlockMaps.Config(
          cross_block='NONE', cross_block_inv='NONE', last_inv='NONE',
          main_inv='NONE', z_map={}, stride=40, xy_overlap=128,
          backward=False), overrides)


def warp_config(overrides: dict[str, Any] | None = None
                ) -> warp.WarpByMap.Config:
  return _with_overrides(
      warp.WarpByMap.Config(
          stride=40, map_volinfo='UNSET', data_volinfo='UNSET',
          map_decorator_specs=None, data_decorator_specs=None,
          map_scale=1.0, interpolation='nearest', downsample=1, offset=0.0,
          mask_configs=None, source_cache_bytes=int(1e9)), overrides)


for _cls, _factory in [
    (flow.EstimateFlow.Config, estimate_flow_config),
    (flow.ReconcileAndFilterFlows.Config, reconcile_flows_config),
    (flow.EstimateMissingFlow.Config, estimate_missing_flow_config),
    (mesh.RelaxMesh.Config, relax_mesh_config),
    (maps.ReconcileCrossBlockMaps.Config, reconcile_cross_block_config),
    (warp.WarpByMap.Config, warp_config),
]:
  config_utils.register_default_config(EM_2D, _cls, _factory)
