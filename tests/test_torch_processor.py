"""The processor layer of sofima_tpu_torch against sofima_tpu (CPU).

Twins of the 25 cases of tests/test_processor.py, plus RelaxMesh's fold
recovery (SolutionStatus.REGULARIZED) and StitchAndRender3dTiles on a
2 x 1 grid of small tiles. Each case feeds the same seeded numpy inputs
through the sofima_tpu processor and the sofima_tpu_torch processor
(device='cpu': the kernels' plain versions), checks the reference
test's own assertions on the port's output, and holds the two outputs
together. Tolerances (the bars the existing twins hold for the same
functions):
  * flows: integer x/y peaks and NaN placement exact; sharpness / ratio
    within rtol = atol = 3e-4 on at least 0.998 of the entries, every
    clean-gate decision (|sharpness| >= 1.6, ratio 0 or >= 1.6) equal
    (tests/test_torch_flow.py); cleaned and reconciled flows exact;
  * meshes within 0.01 x stride (tests/test_torch_mesh.py);
  * maps within 0.01 x stride, NaN pattern equal, boxes and masks exact
    (tests/test_torch_map_utils.py);
  * renders within 1e-2 gray levels (tests/test_torch_warp_api.py).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from sofima_tpu import mesh as j_mesh_lib
from sofima_tpu.processor import client_utils as j_client
from sofima_tpu.processor import flow as j_flow
from sofima_tpu.processor import maps as j_maps
from sofima_tpu.processor import mesh as j_mesh
from sofima_tpu.processor import runner as j_runner
from sofima_tpu.processor import warp as j_warp
from sofima_tpu.processor.defaults import em_2d as j_em
from sofima_tpu.utils import bounding_box as j_bbox
from sofima_tpu.utils import config_utils as j_cfg
from sofima_tpu.utils import metrics as j_metrics
from sofima_tpu.utils import subvolume as j_sub
from sofima_tpu.utils import volume as j_vol
from sofima_tpu_torch import mesh as t_mesh_lib
from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.processor import client_utils as t_client
from sofima_tpu_torch.processor import flow as t_flow
from sofima_tpu_torch.processor import maps as t_maps
from sofima_tpu_torch.processor import mesh as t_mesh
from sofima_tpu_torch.processor import runner as t_runner
from sofima_tpu_torch.processor import warp as t_warp
from sofima_tpu_torch.processor.defaults import em_2d as t_em
from sofima_tpu_torch.utils import bounding_box as t_bbox
from sofima_tpu_torch.utils import config_utils as t_cfg
from sofima_tpu_torch.utils import metrics as t_metrics
from sofima_tpu_torch.utils import subvolume as t_sub
from sofima_tpu_torch.utils import volume as t_vol

torch.set_num_threads(2)

J = types.SimpleNamespace(
    flow=j_flow, maps=j_maps, mesh=j_mesh, runner=j_runner, warp=j_warp,
    em=j_em, mesh_lib=j_mesh_lib, Box=j_bbox.BoundingBox,
    Sub=j_sub.Subvolume, Vol=j_vol.InMemoryVolume, metrics=j_metrics,
    cfg=j_cfg, kw={})
T = types.SimpleNamespace(
    flow=t_flow, maps=t_maps, mesh=t_mesh, runner=t_runner, warp=t_warp,
    em=t_em, mesh_lib=t_mesh_lib, Box=t_bbox.BoundingBox,
    Sub=t_sub.Subvolume, Vol=t_vol.InMemoryVolume, metrics=t_metrics,
    cfg=t_cfg, kw={'device': 'cpu'})
BOTH = (J, T)


def _texture(n, seed=0, sigma=0.1):
  rng = np.random.RandomState(seed)
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(n)[:, None]
  fx = np.fft.rfftfreq(n)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * sigma**2)))
  tex = np.fft.irfft2(f, s=(n, n))
  tex = (tex - tex.min()) / np.ptp(tex)
  return (tex * 255).astype(np.float32)


def _flow_close(got, ref, fraction=0.998):
  """Integer x/y and NaN exact, statistics by share, gates exact."""
  got, ref = np.asarray(got), np.asarray(ref)
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  if got.shape[0] == 2:
    return
  fin = np.isfinite(got[2:]) & np.isfinite(ref[2:])
  assert np.array_equal(fin, np.isfinite(got[2:]))
  d = np.abs(got[2:] - ref[2:])[fin]
  assert np.mean(d <= 3e-4 + 3e-4 * np.abs(ref[2:][fin])) >= fraction

  def gates(f):
    with np.errstate(invalid='ignore'):
      ratio = np.abs(f[3])
      return (np.abs(f[2]) >= 1.6) & ((ratio == 0) | (ratio >= 1.6))

  np.testing.assert_array_equal(gates(got), gates(ref))


def _maps_close(got, ref, stride):
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  np.testing.assert_allclose(got, ref, atol=0.01 * stride, equal_nan=True)


# -- client_utils --------------------------------------------------------


@pytest.mark.parametrize('backward, starts', [
    (False, [0, 50, 100, 150, 200]), (True, [50, 100, 150, 200])])
def test_client_utils(backward, starts):
  for z in range(0, 230, 7):
    assert (t_client.get_block_id(z, starts, backward)
            == j_client.get_block_id(z, starts, backward))
  if backward:
    assert [t_client.get_block_id(z, starts, True)
            for z in (10, 50, 51, 100)] == [0, 0, 1, 1]
  else:
    assert [t_client.get_block_id(z, starts, False)
            for z in (10, 0, 49, 50)] == [1, 1, 1, 2]


# -- EstimateFlow ----------------------------------------------------------


def _flow_volume(P, stack, cfg, size, **cfg_over):
  cfg = P.em.estimate_flow_config(dict(cfg, **cfg_over))
  vol = P.Vol(stack[np.newaxis].astype(np.float32), fill_value=0.0)
  return P.runner.process_volume(P.flow.EstimateFlow(cfg, **P.kw), vol,
                                 subvolume_size=size)


def test_z_stack_flow():
  tex = _texture(240)
  stack = np.stack([np.roll(tex, 2 * z, axis=1) for z in range(3)])
  cfg = {'patch_size': 80, 'stride': 40, 'batch_size': 16}
  ref, out = (_flow_volume(P, stack, cfg, (240, 240, 3)) for P in BOTH)
  assert out.meta.num_channels == 4
  data = out.data
  assert data.shape[1] == 3
  assert np.isnan(data[0, 0]).all()
  interior = data[:, 1:, 1:-1, 1:-1]
  valid = np.isfinite(interior[0])
  assert valid.any()
  np.testing.assert_array_equal(interior[0][valid], -2.0)
  np.testing.assert_array_equal(interior[1][np.isfinite(interior[1])], 0.0)
  _flow_close(out.data, ref.data)


def test_context_and_overlap():
  procs = [P.flow.EstimateFlow(P.em.estimate_flow_config(), **P.kw)
           for P in BOTH]
  for p in procs:
    pre, post = p.context()
    assert pre == (80, 80, 1) and post == (80, 80, 0)
    assert p.overlap() == (120, 120, 1)
  jp, tp = procs
  assert tuple(tp.subvolume_size()) == tuple(jp.subvolume_size())
  assert tp.num_channels(1) == jp.num_channels(1) == 4
  np.testing.assert_array_equal(tp.pixelsize((1, 1, 1)),
                                jp.pixelsize((1, 1, 1)))
  jb = jp.expected_output_box(J.Box(start=(0, 0, 0), size=(1280, 1280, 16)))
  tb = tp.expected_output_box(T.Box(start=(0, 0, 0), size=(1280, 1280, 16)))
  np.testing.assert_array_equal(tb.start, jb.start)
  np.testing.assert_array_equal(tb.size, jb.size)


def test_estimate_flow_coarse_to_fine_matches_padfield():
  """The reference's coarse-to-fine mode correlates in bfloat16 (the
  default of its `coarse_to_fine_flow`), the port's in float32: against
  the reference only the integer peaks and the NaN placement are held
  (ROADMAP.md's bar for the bf16 path is peak agreement >= 0.999)."""
  tex = _texture(320, seed=11)
  stack = np.stack([tex, np.roll(tex, (5, -4), (0, 1))])
  base = {'patch_size': 80, 'stride': 40, 'batch_size': 64}
  a, b = (np.asarray(_flow_volume(T, stack, base, (320, 320, 2),
                                  flow_mode=m).data)
          for m in ('padfield', 'coarse_to_fine'))
  jb = _flow_volume(J, stack, base, (320, 320, 2),
                    flow_mode='coarse_to_fine').data
  sl = np.s_[2:-2, 2:-2]
  assert np.isfinite(a[0, 1]).any() and np.isfinite(b[0, 1]).any()
  fin = np.isfinite(a[0, 1][sl]) & np.isfinite(b[0, 1][sl])
  agree = np.mean((np.abs(a[0, 1][sl] - b[0, 1][sl]) <= 1.0)
                  & (np.abs(a[1, 1][sl] - b[1, 1][sl]) <= 1.0) | ~fin)
  assert agree > 0.97, agree
  _flow_close(b[:2], jb[:2])


def test_estimate_flow_default_is_fast_and_parity_gated():
  for P in BOTH:
    cfg = P.em.estimate_flow_config({'patch_size': 80, 'stride': 40,
                                     'batch_size': 16})
    assert cfg.flow_mode == 'circular_dft'
    assert P.flow.EstimateFlow.Config(
        **dataclasses.asdict(cfg)).flow_mode == 'circular_dft'
  tex = _texture(260, seed=13)
  stack = np.stack([tex[10:250, 10:250], tex[7:247, 14:254]])
  base = {'patch_size': 80, 'stride': 40, 'batch_size': 16}
  got = _flow_volume(T, stack, base, (240, 240, 2)).data
  oracle = _flow_volume(T, stack, base, (240, 240, 2),
                        flow_mode='padfield').data
  sl = np.s_[:, :, 1:-1, 1:-1]
  a, b = oracle[sl], got[sl]
  fin = np.isfinite(a[0]) & np.isfinite(b[0])
  assert fin.any()
  np.testing.assert_array_equal(a[0][fin], b[0][fin])
  np.testing.assert_array_equal(a[1][fin], b[1][fin])
  _flow_close(got, _flow_volume(J, stack, base, (240, 240, 2)).data)


def test_estimate_flow_circular_dft_batched_matches_padfield():
  tex = _texture(240, seed=7)
  stack = np.stack([np.roll(tex, 2 * z, axis=1) for z in range(3)])
  base = {'patch_size': 80, 'stride': 40, 'batch_size': 16}
  ref = _flow_volume(T, stack, base, (240, 240, 3), flow_mode='padfield')
  fast = _flow_volume(T, stack, base, (240, 240, 3),
                      flow_mode='circular_dft')
  ref_v = np.isfinite(ref.data[0])
  fast_v = np.isfinite(fast.data[0])
  np.testing.assert_array_equal(ref_v, fast_v)
  agree = np.mean((ref.data[0][ref_v] == fast.data[0][ref_v])
                  & (ref.data[1][ref_v] == fast.data[1][ref_v]))
  assert agree > 0.9, agree
  assert (np.nanmedian(fast.data[0][fast_v])
          == np.nanmedian(ref.data[0][ref_v]))
  _flow_close(fast.data, _flow_volume(J, stack, base, (240, 240, 3),
                                      flow_mode='circular_dft').data)


# -- ReconcileAndFilterFlows -----------------------------------------------


def test_reconcile_clean_passthrough():
  flow_data = np.full((4, 1, 10, 10), 0.0, np.float32)
  flow_data[0] = 3.0
  flow_data[2] = 10.0
  outs = []
  for P in BOTH:
    proc = P.flow.ReconcileAndFilterFlows(
        P.em.reconcile_flows_config({'min_patch_size': 0}), **P.kw)
    outs.append(proc.process(P.Sub(flow_data.copy(), P.Box(
        start=(0, 0, 0), size=(10, 10, 1)))))
  assert outs[1].data.shape[0] == 2
  np.testing.assert_array_equal(outs[1].data[0], 3.0)
  np.testing.assert_array_equal(outs[1].data, outs[0].data)


def test_reconcile_lowres_fill():
  base = np.full((4, 1, 10, 10), np.nan, np.float32)
  lowres = np.zeros((4, 1, 5, 5), np.float32)
  lowres[0] = 4.0
  lowres[2] = 10.0
  outs = []
  for P in BOTH:
    low_vol = P.Vol(lowres.copy(), pixel_size=(2, 2, 1))
    base_vol = P.Vol(base.copy(), pixel_size=(1, 1, 1))
    cfg = P.em.reconcile_flows_config({'min_patch_size': 0,
                                       'max_gradient': 0,
                                       'max_deviation': 0})
    proc = P.flow.ReconcileAndFilterFlows(cfg, base_vol, **P.kw)
    proc._sources = [None, P.flow.FlowSource(volume=low_vol)]
    outs.append(proc.process(P.Sub(base.copy(), P.Box(start=(0, 0, 0),
                                                      size=(10, 10, 1)))))
  valid = np.isfinite(outs[1].data[0])
  assert valid.any()
  np.testing.assert_allclose(outs[1].data[0][valid], 8.0, atol=1e-3)
  np.testing.assert_array_equal(np.isnan(outs[1].data),
                                np.isnan(outs[0].data))
  np.testing.assert_allclose(outs[1].data, outs[0].data, atol=1e-5)


# -- EstimateMissingFlow ---------------------------------------------------


def _missing_flow(P, stack, flow_in, force_host=None):
  cfg = P.em.estimate_missing_flow_config({
      'patch_size': 80, 'stride': 40, 'batch_size': 16, 'max_delta_z': 3})
  proc = P.flow.EstimateMissingFlow(
      dataclasses.replace(cfg, image_volinfo=P.Vol(stack[np.newaxis],
                                                   fill_value=0.0)), **P.kw)
  if force_host is not None:
    proc._force_host_waves = force_host
  grid = flow_in.shape[-1]
  return proc.process(P.Sub(flow_in.copy(), P.Box(
      start=(0, 0, 3), size=(grid, grid, 1)))).data


def test_missing_flow_fills_with_lookback():
  tex = _texture(200, seed=2)
  stack = np.stack([tex, np.roll(tex, 3, axis=1), np.full_like(tex, 128.0),
                    np.roll(tex, 3, axis=1)])
  flow_in = np.full((2, 1, 5, 5), np.nan, np.float32)
  ref, out = (_missing_flow(P, stack, flow_in) for P in BOTH)
  assert out.shape[0] == 3
  valid = np.isfinite(out[0, 0])
  assert valid.any()
  assert (out[2, 0][valid] == 2).any()
  np.testing.assert_array_equal(np.nan_to_num(out, nan=9e9),
                                np.nan_to_num(ref, nan=9e9))


def test_missing_flow_device_wave_matches_host_path():
  tex = _texture(200, seed=3)
  stack = np.stack([tex, np.roll(tex, (2, -4), axis=(0, 1)),
                    np.full_like(tex, 128.0),
                    np.roll(tex, (2, -4), axis=(0, 1))])
  flow_in = np.full((2, 1, 5, 5), np.nan, np.float32)
  flow_in[:, 0, 0, 0] = 1.0
  (j_dev, j_host), (t_dev, t_host) = (
      [_missing_flow(P, stack, flow_in, h) for h in (False, True)]
      for P in BOTH)
  np.testing.assert_allclose(t_dev, t_host, atol=1e-4, equal_nan=True)
  assert np.isfinite(t_dev[0, 0]).sum() > 1
  for got, ref in ((t_dev, j_dev), (t_host, j_host)):
    np.testing.assert_array_equal(np.nan_to_num(got, nan=9e9),
                                  np.nan_to_num(ref, nan=9e9))


# -- map processors --------------------------------------------------------


def _smooth_map(grid_n, z=1):
  y, x = np.mgrid[:grid_n, :grid_n].astype(np.float32)
  dx = 2 * np.sin(2 * np.pi * y / grid_n)
  dy = 2 * np.cos(2 * np.pi * x / grid_n)
  return np.stack([np.tile(dx, (z, 1, 1)), np.tile(dy, (z, 1, 1))])


def _box_equal(a, b):
  np.testing.assert_array_equal(a.start, b.start)
  np.testing.assert_array_equal(a.size, b.size)


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_invert_map_processor(dtype):
  m = _smooth_map(20)
  outs = []
  for P in BOTH:
    cfg = P.maps.InvertMap.Config(stride=10.0, crop_output=True,
                                  input_volume=P.Vol(m.copy()), dtype=dtype)
    outs.append(P.maps.InvertMap(cfg, **P.kw).process(
        P.Sub(m.copy(), P.Box(start=(0, 0, 0), size=(20, 20, 1)))))
  assert len(outs[1]) == 1
  assert np.isfinite(outs[1][0].data).all()
  _box_equal(outs[1][0].bbox, outs[0][0].bbox)
  _maps_close(outs[1][0].data, outs[0][0].data, 10.0)


def test_resample_map_processor():
  m = np.full((2, 1, 8, 8), 5.0, np.float32)
  m[:, 0] += _smooth_map(8)[:, 0]
  outs = []
  for P in BOTH:
    proc = P.maps.ResampleMap(P.maps.ResampleMap.Config(stride=40,
                                                        out_stride=80),
                              **P.kw)
    outs.append(proc.process(P.Sub(m.copy(), P.Box(start=(0, 0, 0),
                                                   size=(8, 8, 1))))[0])
  assert outs[1].data.shape == (2, 1, 4, 4)
  flat = T.maps.ResampleMap(T.maps.ResampleMap.Config(
      stride=40, out_stride=80), device='cpu').process(T.Sub(
          np.full((2, 1, 8, 8), 5.0, np.float32),
          T.Box(start=(0, 0, 0), size=(8, 8, 1))))[0]
  np.testing.assert_allclose(flat.data, 5.0, atol=1e-4)
  _box_equal(outs[1].bbox, outs[0].bbox)
  _maps_close(outs[1].data, outs[0].data, 40)


def test_fill_missing_processor():
  m = _smooth_map(12)
  m[:, :, 5, 5] = np.nan
  m[:, :, 0:2, 9:] = np.nan
  outs = [P.maps.FillMissing(**P.kw).process(P.Sub(m.copy(), P.Box(
      start=(0, 0, 0), size=(12, 12, 1)))) for P in BOTH]
  assert np.isfinite(outs[1].data).all()
  _maps_close(outs[1].data, outs[0].data, 10.0)


def test_mask_irregularities_processor():
  m = np.zeros((2, 1, 12, 12), np.float32)
  m[0, 0, 6, 6] = -30.0
  outs = [P.maps.MaskIrregularities(stride=(10.0, 10.0), frac=0.5,
                                    **P.kw).process(
      P.Sub(m.copy(), P.Box(start=(0, 0, 0), size=(12, 12, 1))))
          for P in BOTH]
  assert np.isnan(outs[1].data[0, 0]).any()
  _box_equal(outs[1].bbox, outs[0].bbox)
  np.testing.assert_array_equal(np.nan_to_num(outs[1].data, nan=9e9),
                                np.nan_to_num(outs[0].data, nan=9e9))


# -- RelaxMesh -------------------------------------------------------------


def _fake_relax(P, config, store):

  class FakeTileRelaxMesh(P.mesh.RelaxMesh):

    def _load_stitched_tile(self, output_dir, box):
      z = int(box.start[2])
      return store[z].copy() if z in store else None

  return FakeTileRelaxMesh(config, **P.kw)


def test_relax_mesh_sequential_solve():
  grid = 12
  flow_data = np.zeros((2, 1, grid, grid), np.float32)
  flow_data[0] = 4.0
  flow_data[0, 0, 3:6, 4:8] = 3.0
  outs = []
  for P in BOTH:
    cfg = P.em.relax_mesh_config({
        'integration_config': {'stride': (10, 10), 'num_iters': 200,
                               'max_iters': 20000, 'k0': 0.1,
                               'start_cap': 10.0},
        'block_starts': [0]})
    cfg = dataclasses.replace(cfg, flows=[P.mesh.FlowVolume(
        delta_z=1, volume=P.Vol(np.tile(flow_data, (1, 2, 1, 1))))])
    proc = _fake_relax(P, cfg, {0: np.zeros((2, 1, grid, grid), np.float32)})
    outs.append(proc.process(P.Sub(np.zeros((2, 1, grid, grid), np.float32),
                                   P.Box(start=(0, 0, 1),
                                         size=(grid, grid, 1)))).data)
  interior = outs[1][:, 0, 2:-2, 2:-2]
  np.testing.assert_allclose(interior[0], 4.0, atol=1.1)
  np.testing.assert_allclose(interior[1], 0.0, atol=0.5)
  np.testing.assert_allclose(outs[1], outs[0], atol=0.01 * 10)


def test_relax_mesh_block_start_not_optimized():
  for P in BOTH:
    proc = _fake_relax(P, P.em.relax_mesh_config({'block_starts': [5]}), {})
    out = proc.process(P.Sub(np.zeros((2, 1, 8, 8), np.float32),
                             P.Box(start=(0, 0, 5), size=(8, 8, 1))))
    np.testing.assert_array_equal(out.data, 0.0)


def test_relax_mesh_skipped_sections():
  procs = []
  for P in BOTH:
    cfg = dataclasses.replace(
        P.em.relax_mesh_config(), sections_to_skip=[3],
        ranges_to_skip=[P.mesh.BadSectionRange(
            start=10, end=12, flow=P.mesh.FlowVolume(delta_z=1,
                                                     volume=None))])
    procs.append(_fake_relax(P, cfg, {}))
  assert procs[1].is_skipped_section(3)
  assert procs[1].is_skipped_section(11)
  assert not procs[1].is_skipped_section(13)
  assert ([procs[1].is_skipped_section(z) for z in range(20)]
          == [procs[0].is_skipped_section(z) for z in range(20)])


def test_relax_mesh_fold_recovery():
  """A reference state with a fold (a column of nodes pulled 2.5
  strides past its neighbours) makes the first solve irregular; the
  processor re-solves from rest at k0 / 10 and once more
  (SolutionStatus.REGULARIZED)."""
  grid, stride = 12, 10
  flow_data = np.zeros((2, 1, grid, grid), np.float32)
  flow_data[0, 0, :, 6] = -25.0
  results = []
  for P in BOTH:
    cfg = P.em.relax_mesh_config({
        'integration_config': {'stride': (stride, stride), 'num_iters': 200,
                               'max_iters': 4000, 'k0': 0.1, 'k': 0.1,
                               'start_cap': 10.0, 'final_cap': 10.0},
        'block_starts': [0]})
    proc = _fake_relax(P, cfg, {})
    x = np.zeros((2, 1, grid, grid), np.float32)
    results.append(proc.relax_mesh(x, flow_data.copy(),
                                   cfg.integration_config, None))
  (jx, _, jsteps, jstatus), (tx, _, tsteps, tstatus) = results
  assert jstatus == j_mesh.SolutionStatus.REGULARIZED
  assert int(tstatus) == int(jstatus)
  assert t_mesh.SolutionStatus(int(tstatus)).name == 'REGULARIZED'
  assert tsteps == jsteps
  np.testing.assert_allclose(tx, jx, atol=0.01 * stride)


# -- runner ----------------------------------------------------------------


def test_runner_identity_processor():
  rng = np.random.RandomState(0)
  data = rng.rand(1, 4, 50, 60).astype(np.float32)
  outs = []
  for P in BOTH:

    class Doubler(P.runner.SubvolumeProcessor):

      def context(self):
        return (2, 2, 0), (2, 2, 0)

      def process(self, subvol):
        return self.crop_box_and_data(subvol.bbox, subvol.data * 2)

    outs.append(P.runner.process_volume(Doubler(), P.Vol(data.copy()),
                                        subvolume_size=(32, 32, 4)).data)
  np.testing.assert_allclose(outs[1], data * 2, atol=1e-6)
  np.testing.assert_array_equal(outs[1], outs[0])


def test_runner_parallel():
  data = np.zeros((1, 2, 40, 40), np.float32)
  outs = []
  for P in BOTH:

    class Inc(P.runner.SubvolumeProcessor):

      def process(self, subvol):
        return P.Sub(subvol.data + 1, subvol.bbox)

    before = P.metrics.registry().get_counter('Inc', 'subvolumes-done')
    outs.append(P.runner.process_volume(Inc(), P.Vol(data.copy()),
                                        subvolume_size=(16, 16, 2),
                                        parallelism=4).data)
    done = P.metrics.registry().get_counter('Inc', 'subvolumes-done')
    assert done - before >= 9
  np.testing.assert_array_equal(outs[1], 1.0)
  np.testing.assert_array_equal(outs[1], outs[0])


def test_runner_threads_count_exactly(monkeypatch):
  """The kernels' plain versions run on CPU tensors and count nothing, so
  the test counts the staged solver's force calls through the same
  `_build.count` the kernel wrappers use, from four runner threads, and
  sets them against a sequential run of the same work."""
  grid = 10
  flow = np.zeros((2, 3, grid, grid), np.float32)
  flow[0] = 2.0
  plain = t_mesh_lib.inplane_force_plain

  def counted(*args, **kwargs):
    _build.count('force2d')
    return plain(*args, **kwargs)

  monkeypatch.setattr(t_mesh_lib, 'inplane_force_plain', counted)

  class Relax(t_mesh.RelaxMesh):

    def get_prev_state(self, stride, bbox):
      return np.asarray(flow[:, int(bbox.start[2]):int(bbox.start[2]) + 1],
                        np.float64)

  cfg = t_em.relax_mesh_config({
      'integration_config': {'stride': (10, 10), 'num_iters': 50,
                             'max_iters': 50}})
  counts = []
  for parallelism in (1, 4, 1):
    _build.reset_launch_counts()
    t_runner.process_volume(Relax(cfg, device='cpu'),
                            T.Vol(np.zeros((2, 3, grid, grid), np.float32)),
                            subvolume_size=(grid, grid, 1),
                            parallelism=parallelism)
    counts.append(_build.launch_counts['force2d'])
  assert counts[0] == counts[1] == counts[2] > 0
  _build.reset_launch_counts()


# -- defaults --------------------------------------------------------------


def test_registry_roundtrip():
  from sofima_tpu.pipeline import flow_config as jfc
  from sofima_tpu_torch.pipeline import flow_config as tfc
  cfg = tfc.default_em_2d()
  assert cfg.estimate_flow.config.patch_size == 160
  assert cfg.reconcile_missing_flows.multi_section
  over = tfc.default_em_2d({'estimate_flow': {'config': {'patch_size': 80}}})
  assert over.estimate_flow.config.patch_size == 80
  assert over.estimate_flow.config.stride == 40
  assert (t_cfg.dataclass_to_dict(over)
          == j_cfg.dataclass_to_dict(jfc.default_em_2d(
              {'estimate_flow': {'config': {'patch_size': 80}}})))
  assert (t_cfg.dataclass_to_dict(tfc.default_em_2d())
          == j_cfg.dataclass_to_dict(jfc.default_em_2d()))
  assert t_cfg.default_config('em_2d', tfc.FlowPipeline) == cfg


def test_mesh_pipeline_defaults():
  from sofima_tpu.pipeline import mesh_config as jmc
  from sofima_tpu.pipeline import warp_config as jwc
  from sofima_tpu_torch.pipeline import mesh_config as tmc
  from sofima_tpu_torch.pipeline import warp_config as twc
  cfg = tmc.default_em_2d()
  assert cfg.cross_block_config.integration_config.k0 == 0.001
  assert cfg.cross_block_config.integration_config.stride == (320, 320)
  assert (cfg.cross_block_config.options.init_state
          == t_mesh.MeshInitState.PREV_MEDIAN)
  assert cfg.within_block_config.integration_config.k0 == 0.01
  assert t_cfg.to_json(cfg) == j_cfg.to_json(jmc.default_em_2d())
  assert (t_cfg.to_json(twc.default_em_2d())
          == j_cfg.to_json(jwc.default_em_2d()))


# -- WarpByMap -------------------------------------------------------------


def test_area_downsample():
  data = np.arange(16, dtype=np.float64).reshape(1, 1, 4, 4)
  down = t_warp.area_downsample(data, 2)
  assert down.shape == (1, 1, 2, 2)
  np.testing.assert_allclose(down[0, 0], [[2.5, 4.5], [10.5, 12.5]])
  rng = np.random.RandomState(3)
  data = rng.rand(2, 3, 12, 18).astype(np.float32)
  np.testing.assert_array_equal(t_warp.area_downsample(data, 3),
                                j_warp.area_downsample(data, 3))


def _warp_by_map(P, src, cmap, over, box_size, monkeypatch=None, cap=None):
  cfg = P.em.warp_config(over)
  cfg = dataclasses.replace(cfg, map_volinfo=P.Vol(cmap.copy()),
                            data_volinfo=P.Vol(src.copy(), fill_value=0.0))
  if cap is not None:
    monkeypatch.setattr(P.warp.WarpByMap, '_max_source_extent', cap)
  proc = P.warp.WarpByMap(cfg, **P.kw)
  box = P.Box(start=(0, 0, 0), size=(box_size, box_size, 1))
  return proc.process(P.Sub(np.zeros((1, 1, box_size, box_size),
                                     np.float32), box))[0].data


def test_warp_by_map_with_downsample():
  rng = np.random.RandomState(0)
  src = rng.randint(0, 250, (1, 1, 64, 64)).astype(np.float32)
  cmap = np.zeros((2, 1, 8, 8), np.float32)
  over = {'stride': 8.0, 'interpolation': 'linear', 'downsample': 2}
  ref, out = (_warp_by_map(P, src, cmap, over, 32) for P in BOTH)
  assert out.shape == (1, 1, 32, 32)
  expected = src.reshape(1, 1, 32, 2, 32, 2).mean(axis=(3, 5))
  np.testing.assert_allclose(out[0, 0, 2:-2, 2:-2],
                             expected[0, 0, 2:-2, 2:-2], atol=0.5)
  np.testing.assert_allclose(out, ref, atol=1e-2)


def test_warp_by_map_subdivision_matches_unsubdivided(monkeypatch):
  rng = np.random.RandomState(1)
  src = rng.randint(0, 250, (1, 1, 96, 96)).astype(np.float32)
  gy, gx = np.mgrid[:12, :12].astype(np.float32)
  cmap = np.stack([(3.0 * np.sin(2 * np.pi * gy / 12))[None],
                   (3.0 * np.cos(2 * np.pi * gx / 12))[None]])
  over = {'stride': 8.0, 'interpolation': 'linear'}
  whole = _warp_by_map(T, src, cmap, over, 64)
  sub = _warp_by_map(T, src, cmap, over, 64, monkeypatch, 48)
  np.testing.assert_allclose(sub, whole, atol=5e-3)
  assert np.abs(sub).sum() > 0
  np.testing.assert_allclose(sub, _warp_by_map(J, src, cmap, over, 64),
                             atol=1e-2)


# -- StitchAndRender3dTiles ------------------------------------------------


def test_stitch_and_render_3d_tiles(tmp_path, monkeypatch):
  """A 2 x 1 grid of 4 x 32 x 32 tiles cut from one volume with 8 px of x
  overlap: the second tile's mesh carries the cut's -8 px and a smooth
  1.5 px wobble, so some of its taps fall outside the tile. On the TPU
  the reference renders 3d boxes with its shift kernel (taps outside the
  volume read 0), which K13 ports; on the CPU its cost model prefers a
  gather whose outside taps poison the voxel, so the gather's cost is
  raised here (as in tests/test_torch_warp_api.py) and the CPU reference
  takes the shift path. The reference's 3d `fill_missing` compiles for
  ~30 s on one CPU core, so its processor runs with the port's
  (tests/test_torch_map_utils.py::test_invert_then_fill_3d holds the
  two 3d fills together). Both packages render through the runner; the
  class-level caches are reset before and after each."""
  from sofima_tpu import map_utils as jmap
  from sofima_tpu.ops import shift_warp as jsw
  from sofima_tpu_torch import map_utils as tmap
  monkeypatch.setattr(jsw, 'GATHER_COST_PER_TAP', 1.0)
  monkeypatch.setattr(jmap, 'fill_missing', lambda *a, **k: tmap.fill_missing(
      *a, device='cpu', **k))
  rng = np.random.RandomState(4)
  depth, edge, overlap = 4, 32, 8
  vol = rng.rand(depth, edge, 2 * edge - overlap).astype(np.float32) * 200
  tiles = {0: vol[:, :, :edge], 1: vol[:, :, edge - overlap:]}
  x = np.zeros((3, 2, 3, 5, 5), np.float32)
  yy = np.mgrid[:5, :5][0].astype(np.float32)
  x[0, 1] = -overlap + 1.5 * np.sin(yy / 2.0)[None]
  path = tmp_path / 'meshes.npz'
  np.savez(path, x=x, key_to_idx=np.array({(0, 0): 0, (1, 0): 1}))
  size = (2 * edge - overlap, edge, depth)

  outs = []
  for P in BOTH:

    class Tiles(P.warp.StitchAndRender3dTiles):

      def _open_tile_volume(self, tile_id):
        return tiles[tile_id]

    _reset_caches(P)
    proc = Tiles(tile_map=[[0, 1]], tile_mesh_path=str(path),
                 stride=(2, 8, 8), work_size=(64, 64, 8), **P.kw)
    canvas = P.Vol(np.zeros((1,) + size[::-1], np.float32))
    outs.append(P.runner.process_volume(proc, canvas,
                                        subvolume_size=size).data)
    _reset_caches(P)
  jout, tout = outs
  # Tile 0 alone (x < 24) renders its own voxels.
  np.testing.assert_allclose(tout[0, :, :, :edge - overlap],
                             vol[:, :, :edge - overlap], atol=1e-3)
  assert (tout[0, :, :, edge:] != 0).mean() > 0.9
  np.testing.assert_allclose(tout, jout, atol=1e-2)


def _reset_caches(P):
  if P is T:
    t_warp.StitchAndRender3dTiles.reset_caches()
    return
  cls = j_warp.StitchAndRender3dTiles
  cls._tile_meshes = None
  cls._tile_idx_to_xy = None
  cls._tile_boxes = {}
  cls._inverted_meshes = {}


# -- placement -------------------------------------------------------------


@pytest.mark.parametrize('name', ['EstimateFlow', 'ReconcileAndFilterFlows',
                                  'EstimateMissingFlow', 'RelaxMesh',
                                  'InvertMap', 'ResampleMap', 'FillMissing',
                                  'WarpByMap'])
def test_default_device_without_a_card_raises(name):
  """`device=None` means the CUDA card: without one, numpy work items
  raise (as every earlier entry point does) instead of running on the
  CPU."""
  if torch.cuda.is_available():
    pytest.skip('a card is present: device=None runs there')
  tex = _texture(200, seed=2)
  stack = np.stack([tex, np.roll(tex, 3, axis=1), np.full_like(tex, 9.0)])
  flow = np.full((4, 1, 5, 5), 1.0, np.float32)
  flow[:, :, 2, 2] = np.nan
  grid = T.Box(start=(0, 0, 2), size=(5, 5, 1))
  if name == 'EstimateFlow':
    proc = t_flow.EstimateFlow(t_em.estimate_flow_config(
        {'patch_size': 80, 'stride': 40}))
    sv = T.Sub(stack[None], T.Box(start=(0, 0, 0), size=(200, 200, 3)))
  elif name == 'ReconcileAndFilterFlows':
    proc = t_flow.ReconcileAndFilterFlows(t_em.reconcile_flows_config())
    sv = T.Sub(flow, grid)
  elif name == 'EstimateMissingFlow':
    cfg = dataclasses.replace(t_em.estimate_missing_flow_config(
        {'patch_size': 80, 'stride': 40}),
                              image_volinfo=T.Vol(stack[None]))
    proc = t_flow.EstimateMissingFlow(cfg)
    sv = T.Sub(flow[:2], grid)
  elif name == 'RelaxMesh':
    cfg = dataclasses.replace(t_em.relax_mesh_config(), flows=[
        t_mesh.FlowVolume(delta_z=1, volume=T.Vol(np.zeros((2, 3, 5, 5))))])
    proc = _fake_relax(T, cfg, {1: np.zeros((2, 1, 5, 5), np.float32)})
    proc._device = None
    sv = T.Sub(flow[:2], grid)
  elif name == 'InvertMap':
    proc = t_maps.InvertMap(t_maps.InvertMap.Config(
        stride=40.0, crop_output=False, input_volume=T.Vol(flow[:2])))
    sv = T.Sub(np.zeros((2, 1, 5, 5), np.float32), grid)
  elif name == 'ResampleMap':
    proc = t_maps.ResampleMap(t_maps.ResampleMap.Config(stride=40,
                                                        out_stride=80))
    sv = T.Sub(flow[:2], grid)
  elif name == 'FillMissing':
    proc = t_maps.FillMissing()
    sv = T.Sub(flow[:2], grid)
  else:
    cfg = dataclasses.replace(
        t_em.warp_config({'stride': 40.0}),
        map_volinfo=T.Vol(np.zeros((2, 3, 5, 5), np.float32)),
        data_volinfo=T.Vol(stack[None]))
    proc = t_warp.WarpByMap(cfg)
    sv = T.Sub(np.zeros((1, 1, 200, 200), np.float32),
               T.Box(start=(0, 0, 0), size=(200, 200, 1)))
  assert proc.device is None
  with pytest.raises(RuntimeError, match='device="cpu"'):
    proc.process(sv)
