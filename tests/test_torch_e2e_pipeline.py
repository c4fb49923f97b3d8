"""examples/e2e_pipeline.py's chain in sofima_tpu and sofima_tpu_torch (CPU).

The processor pipeline EstimateFlow -> ReconcileAndFilterFlows ->
RelaxMesh (sequential z, solved sections kept in memory) -> InvertMap
-> WarpByMap (Lanczos) on the example's synthetic 3-section stack at its
640^2 (at 320^2 the reference misses its own gate: the 8 x 8 flow grid
is mostly border), through `runner.process_volume` in both
packages (the port with device='cpu'). Both chains must pass the
example's gate (the z=1 residual against section 0 after alignment
below half of the residual before), and each stage's output is held
against the reference's:
  * flows: integer x/y peaks and NaN placement exact, statistics by
    share >= 0.998 within 3e-4, clean-gate decisions exact;
  * cleaned flows exact;
  * solved meshes and inverted maps within 0.01 x stride, NaN pattern
    equal;
  * the port's WarpByMap on the reference's inverted maps within 1e-2
    gray levels of the reference's render (tests/test_torch_warp_api.py's
    float bar) on all but 1e-3 of the pixels, and within 2e-2 on those
    (Lanczos sums 64 float32 taps over 10^6 pixels).
The example's solver settings are kept except the force cap, which
starts at its final value (10): escalating from 0.01 takes ~36 000 steps
a section, a minute in the plain solver on one CPU core.
"""

import dataclasses
import types

import numpy as np
import torch

from sofima_tpu.ops import interp as j_interp
from sofima_tpu.processor import flow as j_flow
from sofima_tpu.processor import maps as j_maps
from sofima_tpu.processor import mesh as j_mesh
from sofima_tpu.processor import runner as j_runner
from sofima_tpu.processor import warp as j_warp
from sofima_tpu.processor.defaults import em_2d as j_em
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu.utils.subvolume import Subvolume as JSub
from sofima_tpu.utils.volume import InMemoryVolume as JVol
from sofima_tpu_torch.processor import flow as t_flow
from sofima_tpu_torch.processor import maps as t_maps
from sofima_tpu_torch.processor import mesh as t_mesh
from sofima_tpu_torch.processor import runner as t_runner
from sofima_tpu_torch.processor import warp as t_warp
from sofima_tpu_torch.processor.defaults import em_2d as t_em
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox
from sofima_tpu_torch.utils.subvolume import Subvolume as TSub
from sofima_tpu_torch.utils.volume import InMemoryVolume as TVol

torch.set_num_threads(2)

N, STRIDE, PATCH = 640, 40, 80

J = types.SimpleNamespace(flow=j_flow, maps=j_maps, mesh=j_mesh,
                          runner=j_runner, warp=j_warp, em=j_em, Box=JBox,
                          Sub=JSub, Vol=JVol, kw={})
T = types.SimpleNamespace(flow=t_flow, maps=t_maps, mesh=t_mesh,
                          runner=t_runner, warp=t_warp, em=t_em, Box=TBox,
                          Sub=TSub, Vol=TVol, kw={'device': 'cpu'})


def _stack():
  """The example's stack: a texture, then warped by 1x and 2x a smooth
  8 px field (examples/e2e_alignment.py's helpers)."""
  from examples.e2e_alignment import make_texture, smooth_deformation
  import jax.numpy as jnp
  tex = make_texture(N)
  deform = smooth_deformation(N, 8.0)
  grid = np.mgrid[:N, :N].astype(np.float32)

  def warp_fwd(scale):
    return np.asarray(j_interp.sample(
        jnp.asarray(tex.astype(np.float32)),
        jnp.asarray(np.stack([grid[0] + scale * deform[1],
                              grid[1] + scale * deform[0]])),
        method='linear', mode='nearest'))

  return np.stack([tex.astype(np.float32), warp_fwd(1.0), warp_fwd(2.0)])


def _relax_config(P):
  return P.em.relax_mesh_config({
      'integration_config': {'stride': (STRIDE, STRIDE), 'k0': 0.1,
                             'num_iters': 500, 'start_cap': 10.0},
      'block_starts': [0]})


def _relax(P, clean):
  """RelaxMesh one section per work item, solved sections in memory."""
  solved = {0: np.zeros((2, 1) + clean.shape[2:], np.float32)}

  class MemRelax(P.mesh.RelaxMesh):

    def _load_stitched_tile(self, output_dir, box):
      z = int(box.start[2])
      return solved[z].copy() if z in solved else None

  cfg = dataclasses.replace(_relax_config(P), flows=[
      P.mesh.FlowVolume(delta_z=1, volume=P.Vol(clean))])
  proc = MemRelax(cfg, **P.kw)
  gy, gx = clean.shape[2:]
  for z in range(1, 3):
    out = proc.process(P.Sub(np.zeros((2, 1, gy, gx), np.float32),
                             P.Box(start=(0, 0, z), size=(gx, gy, 1))))
    solved[z] = out.data.astype(np.float32)
  return np.concatenate([solved[z] for z in range(3)], axis=1)


def _invert(P, solved):
  gy, gx = solved.shape[2:]
  vol = P.Vol(solved.copy())
  cfg = P.maps.InvertMap.Config(stride=float(STRIDE), crop_output=False,
                                input_volume=vol)
  return P.runner.process_volume(P.maps.InvertMap(cfg, **P.kw), vol,
                                 subvolume_size=(gx, gy, 3)).data


def _render(P, stack, inv):
  image_vol = P.Vol(stack[np.newaxis].copy(), fill_value=0.0)
  cfg = P.em.warp_config({'stride': float(STRIDE),
                          'interpolation': 'lanczos'})
  cfg = dataclasses.replace(cfg, map_volinfo=P.Vol(inv.copy()),
                            data_volinfo=image_vol)
  return P.runner.process_volume(P.warp.WarpByMap(cfg, **P.kw), image_vol,
                                 subvolume_size=(N, N, 3)).data[0]


def _chain(P, stack):
  image_vol = P.Vol(stack[np.newaxis].copy(), fill_value=0.0)
  flow_cfg = P.em.estimate_flow_config({
      'patch_size': PATCH, 'stride': STRIDE, 'batch_size': 64})
  flow_vol = P.runner.process_volume(
      P.flow.EstimateFlow(flow_cfg, **P.kw), image_vol,
      subvolume_size=(N // 2 + PATCH, N // 2 + PATCH, 3))
  rec_cfg = P.em.reconcile_flows_config({'min_patch_size': 0})
  clean = P.runner.process_volume(
      P.flow.ReconcileAndFilterFlows(rec_cfg, flow_vol, **P.kw),
      flow_vol).data
  solved = _relax(P, clean)
  inv = _invert(P, solved)
  return dict(flow=flow_vol.data, clean=clean, solved=solved, inv=inv,
              rendered=_render(P, stack, inv))


def _gate(stack, rendered):
  sel = np.s_[PATCH:-PATCH, PATCH:-PATCH]
  before = np.abs(stack[1] - stack[0])[sel].mean()
  after = np.abs(rendered[1] - stack[0])[sel].mean()
  assert after < 0.5 * before, (before, after)


def test_e2e_pipeline_chain():
  stack = _stack()
  ref, got = (_chain(P, stack) for P in (J, T))
  _gate(stack, ref['rendered'])
  _gate(stack, got['rendered'])

  f, rf = got['flow'], ref['flow']
  np.testing.assert_array_equal(np.nan_to_num(f[:2], nan=9e9),
                                np.nan_to_num(rf[:2], nan=9e9))
  fin = np.isfinite(rf[2:])
  np.testing.assert_array_equal(np.isfinite(f[2:]), fin)
  d = np.abs(f[2:] - rf[2:])[fin]
  assert np.mean(d <= 3e-4 + 3e-4 * np.abs(rf[2:][fin])) >= 0.998
  np.testing.assert_array_equal(np.nan_to_num(got['clean'], nan=9e9),
                                np.nan_to_num(ref['clean'], nan=9e9))
  assert np.isfinite(got['clean'][0, 1:]).mean() > 0.5
  for key in ('solved', 'inv'):
    np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]))
    np.testing.assert_allclose(got[key], ref[key], atol=0.01 * STRIDE,
                               equal_nan=True)
  d = np.abs(_render(T, stack, ref['inv']) - ref['rendered'])
  assert np.mean(d > 1e-2) <= 1e-3 and d.max() < 2e-2, (np.mean(d > 1e-2),
                                                        d.max())
