"""3d tile stitching of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

The same seeded numpy inputs go through both packages:
  * 3d `dense_flow_field` (strip path): integer x/y/z peaks and NaN rows
    exact; sharpness and ratio within rtol 1e-3 (f32 FFT summation
    order);
  * 3d `_invert_section` (general path, 3x3 Newton) within 1e-3 px with
    the NaN pattern equal, and 3d `fill_invalid` within 1e-4;
  * 3d `compose_maps_fast` in 'constant' mode within 1e-4 px;
  * the batched `TargetMeshPlan` that the solver evaluates against the
    reference's vmapped `compute_target_mesh`, within 1e-4 px;
  * `stitch_and_render_3d` end to end at tests/test_stitching3d.py's
    two-tile geometry: solved meshes within 0.01 * stride (0.08 px),
    equal solve steps, the canvas within mean 0.05 / max 2.0 gray
    levels where both weight sums are positive (the solver's global
    translation gauge makes absolute positions differ by f32 noise);
  * `config_from_jax(Stitch3dConfig)` JSON-equal.
And the entry point's placement: host tiles go to the CUDA card unless
the caller asks for device='cpu'.
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jflow
from sofima_tpu import map_utils as jmap
from sofima_tpu import stitch_elastic as jse
from sofima_tpu.ops import fill as jfill
from sofima_tpu.pipeline import stitch3d as js3
from sofima_tpu_torch import convert
from sofima_tpu_torch import flow_field as tflow
from sofima_tpu_torch import map_utils as tmap
from sofima_tpu_torch import stitch_elastic as tse
from sofima_tpu_torch.ops import fill as tfill
from sofima_tpu_torch.pipeline import stitch3d as ts3

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


def _texture3d(shape_zyx, seed=0):
  rng = np.random.RandomState(seed)
  f = np.fft.rfftn(rng.rand(*shape_zyx).astype(np.float32))
  freqs = np.meshgrid(*[np.fft.fftfreq(s) for s in shape_zyx[:-1]]
                      + [np.fft.rfftfreq(shape_zyx[-1])], indexing='ij')
  f *= np.exp(-sum(fr ** 2 for fr in freqs) / (2 * 0.12 ** 2))
  tex = np.fft.irfftn(f, s=shape_zyx, axes=(0, 1, 2))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


class _Tile:
  """[1, z, y, x] array-like, as compute_flow_map3d expects."""

  def __init__(self, data):
    self.data = data[None]
    self.shape = self.data.shape

  def __getitem__(self, sel):
    return self.data[sel]


# tests/test_stitching3d.py's two-tile geometry.
def _two_tiles():
  vol = _texture3d((24, 48, 80), seed=3)
  overlap = 16
  t0, t1 = vol[:, :, :48].copy(), vol[:, :, 32:].copy()
  cx = np.full((3, 1, 1, 2), np.nan)
  cx[:, 0, 0, 0] = (-overlap, 0, 0)
  cy = np.full((3, 1, 1, 2), np.nan)
  coarse = np.zeros((3, 1, 1, 2), np.float32)
  coarse[0, 0, 0, 1] = -overlap
  return vol, t0, t1, cx, cy, coarse


def _mesh_cfg(mod):
  return mod.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1,
      stride=(8, 8, 8), num_iters=200, max_iters=5000, stop_v_max=0.01,
      dt_max=100.0)


@pytest.fixture(scope='module')
def reference():
  """The JAX chain's flows, packed arrays and end-to-end result."""
  from sofima_tpu import mesh as jmesh
  _, t0, t1, cx, cy, coarse = _two_tiles()
  stride = (8, 8, 8)
  flows_x, off_x = jse.compute_flow_map3d(
      {(0, 0): _Tile(t0), (1, 0): _Tile(t1)}, tile_shape=(48, 48, 24),
      offset_map=cx, axis=0, patch_size=(16, 16, 16), stride=stride,
      batch_size=8)
  packed = jse.aggregate_arrays(
      (cx[:, 0], flows_x, off_x), (cy[:, 0], {}, {}), [(0, 0), (1, 0)],
      coarse[:, 0], stride, tile_shape=(24, 48, 48))
  cfg3 = js3.Stitch3dConfig(stride=stride, patch_size=(16, 16, 16),
                            flow_batch=8, margin=2,
                            mesh_cfg=_mesh_cfg(jmesh))
  out = js3.stitch_and_render_3d({(0, 0): t0, (1, 0): t1}, cx, cy, coarse,
                                 cfg3)
  return dict(flows_x=flows_x, off_x=off_x, packed=packed, cfg3=cfg3,
              canvas=np.asarray(out['canvas']),
              weights=np.asarray(out['weights']),
              solved=np.asarray(out['solved']), steps=out['solve_steps'])


class TestPieces:

  def test_dense_flow_3d(self):
    vol = _texture3d((40, 48, 56), seed=1)
    pre = vol[:, :, :48]
    post = np.roll(vol, (1, -2, 3), (0, 1, 2))[:, :, :48]
    ref = np.asarray(jflow.dense_flow_field(
        jnp.asarray(pre), jnp.asarray(post), (16, 16, 16), (8, 8, 8),
        circular=True))
    got = tflow.dense_flow_field(_t(pre), _t(post), (16, 16, 16),
                                 (8, 8, 8), circular=True).numpy()
    assert got.shape == ref.shape == (5, 4, 5, 5)
    np.testing.assert_array_equal(np.nan_to_num(got[:3], nan=9e9),
                                  np.nan_to_num(ref[:3], nan=9e9))
    np.testing.assert_allclose(got[3:], ref[3:], rtol=1e-3, atol=1e-3)

  def test_compute_flow_map3d(self, reference):
    _, t0, t1, cx, _, _ = _two_tiles()
    flows, offs = tse.compute_flow_map3d(
        {(0, 0): _Tile(_t(t0)), (1, 0): _Tile(_t(t1))},
        tile_shape=(48, 48, 24), offset_map=cx, axis=0,
        patch_size=(16, 16, 16), stride=(8, 8, 8))
    assert offs == reference['off_x']
    got, ref = flows[(0, 0)].numpy(), reference['flows_x'][(0, 0)]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.nan_to_num(got[:3], nan=9e9),
                                  np.nan_to_num(ref[:3], nan=9e9))

  def test_invert_section_3d(self):
    rng = np.random.RandomState(4)
    g = (5, 6, 7)
    stride = np.asarray([8.0, 10.0, 12.0], np.float32)  # zyx
    zz, yy, xx = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in g],
                             indexing='ij')
    rel = np.stack([2.0 * np.sin(yy / 2.0 + zz / 3.0),
                    1.5 * np.cos(xx / 2.5), 1.2 * np.sin(xx / 3.0 + yy)])
    rel = (rel + rng.randn(3, *g) * 0.2).astype(np.float32)
    grid_xyz = np.stack([xx * stride[2], yy * stride[1], zz * stride[0]])
    abs_map = (rel + grid_xyz).astype(np.float32)
    abs_map[:, 2, 3, 4] = np.nan
    qz, qy, qx = np.meshgrid(*[(np.arange(n, dtype=np.float32) + 0.3) * s
                               for n, s in zip(g, stride)], indexing='ij')
    query = np.stack([qx, qy, qz]).astype(np.float32)
    kw = dict(num_iters=16, newton_iters=4)
    ref = np.asarray(jmap._invert_section(
        jnp.asarray(abs_map), jnp.zeros(3), jnp.asarray(query),
        jnp.asarray(stride), **kw))
    got = tmap._invert_section(_t(abs_map), (0.0, 0.0, 0.0), _t(query),
                               tuple(stride), **kw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isfinite(ref).mean() > 0.5
    assert np.nanmax(np.abs(got - ref)) < 1e-3

  @pytest.mark.parametrize('extrapolate', [False, True])
  def test_fill_invalid_3d(self, extrapolate):
    rng = np.random.RandomState(5)
    v = rng.randn(3, 6, 9, 11).astype(np.float32)
    valid = rng.rand(6, 9, 11) > 0.35
    valid[:, :2, :] = False
    ref = np.asarray(jfill.fill_invalid(jnp.asarray(v), jnp.asarray(valid),
                                        extrapolate=extrapolate))
    got = tfill.fill_invalid(_t(v), _t(valid), extrapolate=extrapolate,
                             dim=3).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 1e-4

  def test_compose_maps_fast_3d_constant(self):
    rng = np.random.RandomState(6)
    m1 = (rng.randn(3, 4, 5, 6) * 3).astype(np.float32)
    m2 = (rng.randn(3, 6, 7, 8) * 3).astype(np.float32)
    m1[:, 1, 2, 3] = np.nan
    m2[:, 2, 2, 2] = np.nan
    start1, stride = (1, 2, 1), (8, 8, 8)
    ref = np.asarray(jmap.compose_maps_fast(
        jnp.asarray(m1), start1, stride, jnp.asarray(m2), (0, 0, 0), stride,
        mode='constant'))
    got = tmap.compose_maps_fast(_t(m1), start1, stride, _t(m2), (0, 0, 0),
                                 stride, mode='constant').numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).any() and np.isfinite(ref).any()
    assert np.nanmax(np.abs(got - ref)) < 1e-4

  def test_compute_target_mesh(self, reference):
    fx, fy, x0, nbors, _ = reference['packed']
    rng = np.random.RandomState(7)
    x = (x0 + rng.randn(*x0.shape) * 0.5).astype(np.float32)
    stride = (8, 8, 8)
    ref = np.asarray(jax.vmap(functools.partial(
        jse.compute_target_mesh, x=jnp.asarray(x), fx=jnp.asarray(fx),
        fy=jnp.asarray(fy), stride=stride))(jnp.asarray(nbors)))
    tfx = _t(fx.astype(np.float32))
    tfy = _t(fy.astype(np.float32))
    plan = tse.TargetMeshPlan(nbors, tfx, tfy, stride, x.shape[-3:])
    batched = plan(_t(x)).numpy()
    for i in range(nbors.shape[0]):
      got = batched[:, i]
      np.testing.assert_array_equal(np.isnan(got), np.isnan(ref[i]))
      assert np.isfinite(got).any()
      assert np.nanmax(np.abs(got - ref[i])) < 1e-4
      one = tse.compute_target_mesh(nbors[i], _t(x), tfx, tfy,
                                    stride).numpy()
      np.testing.assert_array_equal(one, got)

  def test_aggregate_arrays(self, reference):
    _, _, _, cx, cy, coarse = _two_tiles()
    fx, fy, x0, nbors, key_to_idx = tse.aggregate_arrays(
        (cx[:, 0], {k: _t(v.astype(np.float32))
                    for k, v in reference['flows_x'].items()},
         reference['off_x']), (cy[:, 0], {}, {}), [(0, 0), (1, 0)],
        coarse[:, 0], (8, 8, 8), tile_shape=(24, 48, 48))
    rfx, rfy, rx0, rnbors, rkey = reference['packed']
    np.testing.assert_array_equal(nbors, rnbors)
    np.testing.assert_array_equal(x0, rx0)
    assert key_to_idx == rkey and tuple(fy.shape) == rfy.shape
    np.testing.assert_array_equal(fx.numpy(), rfx.astype(np.float32))


class TestStitchAndRender:

  def test_matches_reference(self, reference):
    _, t0, t1, cx, cy, coarse = _two_tiles()
    cfg = convert.config_from_jax(reference['cfg3'])
    timings = {}
    out = ts3.stitch_and_render_3d({(0, 0): t0, (1, 0): t1}, cx, cy,
                                   coarse, cfg, device='cpu',
                                   timings=timings)
    assert out['canvas'].device.type == 'cpu'
    assert set(timings) == {'flow', 'solve', 'render'}
    assert out['solve_steps'] == reference['steps']
    solved = out['solved'].numpy()
    assert solved.shape == reference['solved'].shape == (3, 2, 3, 6, 6)
    assert np.abs(solved - reference['solved']).max() < 0.08
    canvas, weights = out['canvas'].numpy(), out['weights'].numpy()
    assert canvas.shape == reference['canvas'].shape == (24, 48, 96)
    both = (weights > 0) & (reference['weights'] > 0)
    assert both.mean() > 0.5
    d = np.abs(canvas - reference['canvas'])[both]
    assert d.mean() < 0.05 and d.max() < 2.0, (d.mean(), d.max())
    np.testing.assert_allclose(weights, reference['weights'], atol=0.05)

  def test_device_tiles_replace_the_upload(self, reference):
    """`device_tiles` in the reference's 6th place: the tiles' values come
    from it (the host dict gives only the keys), and no upload is made."""
    _, t0, t1, cx, cy, coarse = _two_tiles()
    cfg = convert.config_from_jax(reference['cfg3'])
    host = {(0, 0): np.zeros_like(t0), (1, 0): np.zeros_like(t1)}
    dev = {(0, 0): torch.from_numpy(t0), (1, 0): torch.from_numpy(t1)}
    out = ts3.stitch_and_render_3d(host, cx, cy, coarse, cfg, dev)
    assert out['canvas'].device.type == 'cpu'
    assert out['solve_steps'] == reference['steps']
    assert np.abs(out['solved'].numpy() - reference['solved']).max() < 0.08

  def test_host_tiles_need_a_device(self):
    if torch.cuda.is_available():
      pytest.skip('the CPU-only behaviour')
    _, t0, t1, cx, cy, coarse = _two_tiles()
    with pytest.raises(RuntimeError, match='device="cpu"'):
      ts3.stitch_and_render_3d({(0, 0): t0, (1, 0): t1}, cx, cy, coarse)

  def test_config_from_jax(self):
    jcfg = js3.Stitch3dConfig()
    tcfg = convert.config_from_jax(jcfg)
    assert tcfg == ts3.Stitch3dConfig()
    assert (json.dumps(dataclasses.asdict(tcfg))
            == json.dumps(dataclasses.asdict(jcfg)))

  def test_tile_meshes_round_trip(self):
    m = np.random.RandomState(0).randn(3, 4, 2, 5, 6).astype(np.float32)
    m[:, 1, 0, 0, 0] = np.nan
    t = convert.map_from_numpy(m, device='cpu')
    np.testing.assert_array_equal(convert.map_to_numpy(t), m)


def test_align_stack_places_host_stack():
  from sofima_tpu_torch.pipeline import stack_align
  stack = np.zeros((2, 200, 200), np.uint8)
  cfg = stack_align.StackAlignConfig(max_displacement=32)
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='device="cpu"'):
      stack_align.align_stack(stack, cfg)
  rendered, solved, _ = stack_align.align_stack(stack, cfg, device='cpu')
  assert rendered.device.type == 'cpu' and solved.shape == (2, 2, 1, 5, 5)


def test_new_modules_import_no_jax():
  mods = ['sofima_tpu_torch.pipeline.stitch3d',
          'sofima_tpu_torch.stitch_elastic', 'sofima_tpu_torch.warp',
          'sofima_tpu_torch.utils.bounding_box', 'sofima_tpu_torch.placement',
          'sofima_tpu_torch.utils.subvolume', 'sofima_tpu_torch.utils.volume',
          'sofima_tpu_torch.utils.metrics',
          'sofima_tpu_torch.utils.config_utils',
          'sofima_tpu_torch.utils.mask', 'sofima_tpu_torch.ops.edt',
          'sofima_tpu_torch.processor.base',
          'sofima_tpu_torch.processor.runner',
          'sofima_tpu_torch.processor.client_utils',
          'sofima_tpu_torch.processor.flow', 'sofima_tpu_torch.processor.mesh',
          'sofima_tpu_torch.processor.maps', 'sofima_tpu_torch.processor.warp',
          'sofima_tpu_torch.processor.defaults.em_2d',
          'sofima_tpu_torch.pipeline.flow_config',
          'sofima_tpu_torch.pipeline.mesh_config',
          'sofima_tpu_torch.pipeline.warp_config']
  code = ('import sys\n' + ''.join(f'import {m}\n' for m in mods)
          + "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'sofima_tpu.'))]\n"
            "assert not bad, bad\nprint('ok')\n")
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0 and 'ok' in out.stdout, out.stderr
