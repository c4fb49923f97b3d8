"""The 2d montage slice of sofima_tpu_torch against sofima_tpu (CPU).

At tests/test_stitching.py's geometry (a 260^2 texture cut into 2 x 2
tiles of 160 with 60 px overlap, stride 20, patch 40), each stage of the
port's montage_align_2d against its JAX counterpart on the same inputs,
the JAX chain computed once for the module with flow_mode
'circular_dft' (float32 correlation, as the port's):
  * flow_field.masked_xcorr, batch and per-item thresholds;
  * stitch_rigid: compute_coarse_offsets_batched (offsets equal, also
    with a tile missing), optimize_coarse_mesh;
  * stitch_elastic: compute_flow_map (x/y and NaN equal, statistics
    within 3e-4), aggregate_arrays (nbors, meshes, flows equal), the
    2d targets of TargetMeshPlan / compute_target_mesh;
  * pipeline.montage: render_tiles_device (the reference renders with
    pallas_shift_warp_tiled in interpret mode at origin -pad) and
    montage_align_2d end to end;
  * convert.config_from_jax for MontageConfig.

Tolerances: masked NCC within 1e-4 (float32 FFT rounding on values in
[-1, 1]); solved meshes within 0.01 * stride = 0.2 px; canvases, where
both masks are set, within 0.01 gray levels in the mean and 0.05 at
most (measured 5e-6 / 5.5e-4: Lanczos weights from differently rounded
displacements); the montage's own quality gates as the JAX test's
(error < 10, coverage > 0.9). Against the reference's default bf16
correlation, the port's float32 fine flows move the solved meshes by at
most 0.4 px (the stack slice's bar for bf16).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jflow
from sofima_tpu import mesh as jmesh
from sofima_tpu import stitch_elastic as jse
from sofima_tpu import stitch_rigid as jsr
from sofima_tpu.pipeline import montage as jmont
from sofima_tpu_torch import convert
from sofima_tpu_torch import flow_field as tflow
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch import stitch_elastic as tse
from sofima_tpu_torch import stitch_rigid as tsr
from sofima_tpu_torch.pipeline import montage as tmont

torch.set_num_threads(2)
OVERLAPS = ((65, 75), (65, 75))
STRIDE = (20, 20)
PATCH = (40, 40)
TILE = (160, 160)
MESH_TOL = 0.2          # 0.01 * stride
CANVAS_TOL = (0.01, 0.05)  # gray levels: mean, max where both masks set


def _texture(n, seed=0, sigma=0.1):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * sigma ** 2)))
  tex = np.fft.irfft2(f, s=(n, n))
  tex = (tex - tex.min()) / np.ptp(tex)
  return (tex * 255).astype(np.uint8)


def _cut_tiles(img, tile=160, overlap=60, grid=2):
  step = tile - overlap
  return {(tx, ty): img[ty * step:ty * step + tile,
                        tx * step:tx * step + tile]
          for ty in range(grid) for tx in range(grid)}


def _mesh_kw():
  return dict(dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(20.0, 20.0),
              num_iters=400, max_iters=20000, stop_v_max=0.005,
              dt_max=100.0)


def _montage_cfg(module, mesh_module, **kw):
  return module.MontageConfig(
      stride=20, patch_size=40, coarse_overlaps=(65, 75), min_overlap=10,
      margin=4, flow_batch=16, mesh_cfg=mesh_module.IntegrationConfig(
          **_mesh_kw()), **kw)


def _flows(module, tiles, cx, cy, mode, **kw):
  fx, ox = module.compute_flow_map(tiles, cx[:, 0], axis=0, patch_size=PATCH,
                                   stride=STRIDE, flow_mode=mode, **kw)
  fy, oy = module.compute_flow_map(tiles, cy[:, 0], axis=1, patch_size=PATCH,
                                   stride=STRIDE, flow_mode=mode, **kw)
  return fx, ox, fy, oy


def _to_torch(flows):
  return {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in flows.items()}


@pytest.fixture(scope='module')
def ref():
  """The JAX chain once: stages, then montage_align_2d."""
  img = _texture(260, seed=3)
  tiles = _cut_tiles(img)
  cx, cy = jsr.compute_coarse_offsets_batched(
      (2, 2), tiles, overlaps_xy=OVERLAPS, min_overlap=10)
  cx = jsr.interpolate_missing_offsets(cx, axis=-1)
  cy = jsr.interpolate_missing_offsets(cy, axis=-2)
  coarse = jsr.optimize_coarse_mesh(cx, cy)
  fx, ox, fy, oy = _flows(jse, tiles, cx, cy, 'circular_dft',
                          batch_size=16)
  agg = jse.aggregate_arrays((cx[:, 0], fx, ox), (cy[:, 0], fy, oy),
                             list(tiles), coarse[:, 0], STRIDE,
                             tile_shape=TILE)
  out = jmont.montage_align_2d(
      {k: jnp.asarray(v) for k, v in tiles.items()}, (2, 2),
      _montage_cfg(jmont, jmesh, flow_mode='circular_dft'))
  return dict(img=img, tiles=tiles, cx=cx, cy=cy, coarse=coarse, fx=fx,
              ox=ox, fy=fy, oy=oy, agg=agg,
              out={k: (np.asarray(v) if isinstance(v, jnp.ndarray) else v)
                   for k, v in out.items()})


@pytest.mark.parametrize('per_item', [False, True])
def test_masked_xcorr(per_item):
  rng = np.random.RandomState(0)
  prev = rng.rand(3, 30, 24).astype(np.float32)
  curr = rng.rand(3, 26, 20).astype(np.float32)
  prev[1] *= 0.01  # a low-contrast item: per-item thresholds differ
  prev_mask = rng.rand(*prev.shape) < 0.2
  curr_mask = rng.rand(*curr.shape) < 0.3
  ref = np.asarray(jflow.masked_xcorr(prev, curr, prev_mask, curr_mask,
                                      per_item=per_item))
  got = tflow.masked_xcorr(torch.from_numpy(prev), torch.from_numpy(curr),
                           torch.from_numpy(prev_mask),
                           torch.from_numpy(curr_mask), per_item=per_item)
  assert got.shape == ref.shape == (3, 55, 43)
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
  # Unmasked: the plain linear correlation, from numpy inputs.
  ref_u = np.asarray(jflow.masked_xcorr(prev, curr))
  got_u = tflow.masked_xcorr(prev, curr)
  assert isinstance(got_u, torch.Tensor)
  np.testing.assert_allclose(got_u.numpy(), ref_u, rtol=1e-4, atol=1e-3)
  for n in (1, 2, 7, 97, 7199, 879):
    assert tflow.next_fast_len(n) == jflow.next_fast_len(n)


def test_coarse_offsets(ref):
  cx, cy = tsr.compute_coarse_offsets_batched(
      (2, 2), ref['tiles'], overlaps_xy=OVERLAPS, min_overlap=10,
      device='cpu')
  np.testing.assert_array_equal(tsr.interpolate_missing_offsets(cx, -1),
                                ref['cx'])
  np.testing.assert_array_equal(tsr.interpolate_missing_offsets(cy, -2),
                                ref['cy'])
  # A missing tile: its pairs stay NaN, the rest equal the reference.
  tiles = {k: v for k, v in ref['tiles'].items() if k != (1, 1)}
  jx, jy = jsr.compute_coarse_offsets_batched(
      (2, 2), tiles, overlaps_xy=OVERLAPS, min_overlap=10)
  tx, ty = tsr.compute_coarse_offsets_batched(
      (2, 2), {k: torch.from_numpy(v) for k, v in tiles.items()},
      overlaps_xy=OVERLAPS, min_overlap=10)
  np.testing.assert_array_equal(tx, jx)
  np.testing.assert_array_equal(ty, jy)
  assert np.isnan(tx[0, 0, 1, 0])


def test_optimize_coarse_mesh(ref):
  got = tsr.optimize_coarse_mesh(ref['cx'], ref['cy'], device='cpu')
  assert got.dtype == np.float32 and got.shape == ref['coarse'].shape
  np.testing.assert_allclose(got, ref['coarse'], atol=1e-3, rtol=0)


def test_compute_flow_map(ref):
  fx, ox, fy, oy = _flows(tse, ref['tiles'], ref['cx'], ref['cy'],
                          'circular_dft', device='cpu')
  assert ox == ref['ox'] and oy == ref['oy']
  for got, want in ((fx, ref['fx']), (fy, ref['fy'])):
    assert got.keys() == want.keys()
    for k in want:
      g, w = got[k].numpy(), want[k]
      assert g.shape == w.shape
      np.testing.assert_array_equal(np.nan_to_num(g[:2], nan=9e9),
                                    np.nan_to_num(w[:2], nan=9e9))
      np.testing.assert_allclose(g[2:], w[2:], rtol=3e-4, atol=3e-4)
  # The default 'padfield' mode, once a raise, gives the reference's
  # padfield flows (in depth in test_torch_stitch_api.py).
  tiles = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in ref['tiles'].items()}
  pf, pf_off = tse.compute_flow_map(tiles, ref['cx'][:, 0], axis=0,
                                    patch_size=PATCH, stride=STRIDE,
                                    batch_size=64)
  want, want_off = jse.compute_flow_map(ref['tiles'], ref['cx'][:, 0],
                                        axis=0, patch_size=PATCH,
                                        stride=STRIDE, batch_size=64)
  assert pf_off == want_off and pf.keys() == want.keys()
  for k in want:
    np.testing.assert_array_equal(np.nan_to_num(pf[k][:2].numpy(), nan=9e9),
                                  np.nan_to_num(want[k][:2], nan=9e9))
  with pytest.raises(ValueError, match='unknown flow mode'):
    tse.compute_flow_map(ref['tiles'], ref['cx'][:, 0], axis=0,
                         flow_mode='circular_bf16', device='cpu')


def test_aggregate_arrays(ref):
  got = tse.aggregate_arrays(
      (ref['cx'][:, 0], _to_torch(ref['fx']), ref['ox']),
      (ref['cy'][:, 0], _to_torch(ref['fy']), ref['oy']),
      list(ref['tiles']), ref['coarse'][:, 0], STRIDE, tile_shape=TILE)
  fx, fy, x0, nbors, key_to_idx = ref['agg']
  assert nbors.shape == (4, 4, 8) and x0.shape == (2, 4, 8, 8)
  np.testing.assert_array_equal(got[3], nbors)
  np.testing.assert_array_equal(got[2], x0)
  assert got[4] == key_to_idx
  for g, w in ((got[0], fx), (got[1], fy)):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.float32))


def test_target_meshes(ref):
  fx, fy, x0, nbors, _ = ref['agg']
  fx_j, fy_j = jnp.asarray(fx), jnp.asarray(fy)
  x = x0 + np.random.RandomState(0).randn(*x0.shape).astype(np.float32)
  want = np.moveaxis(np.asarray(jax.vmap(functools.partial(
      jse.compute_target_mesh, x=jnp.asarray(x), fx=fx_j, fy=fy_j,
      stride=STRIDE))(jnp.asarray(nbors))), 0, 1)
  fx_t, fy_t = (torch.from_numpy(np.asarray(v, np.float32)) for v in (fx, fy))
  plan = tse.TargetMeshPlan(nbors, fx_t, fy_t, STRIDE, x.shape[-2:])
  got = plan(torch.from_numpy(x)).numpy()
  assert got.shape == x.shape
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  assert np.isfinite(got[:, 0, :, -1]).any()  # right edge of tile 0
  np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
  one = tse.compute_target_mesh(nbors[1], torch.from_numpy(x), fx_t, fy_t,
                                STRIDE).numpy()
  np.testing.assert_array_equal(one, got[:, 1])


def _canvas_close(got_c, got_m, want_c, want_m):
  both = got_m & want_m
  assert both.mean() > 0.5
  d = np.abs(got_c - want_c)[both]
  assert d.mean() < CANVAS_TOL[0] and d.max() < CANVAS_TOL[1], (d.mean(),
                                                                 d.max())
  assert (got_m ^ want_m).mean() < 0.002


def test_render_tiles_device(ref):
  out = ref['out']
  maps = {k: out['solved'][:, i:i + 1] for k, i in out['key_to_idx'].items()}
  want_c, want_m, want_o = jmont.render_tiles_device(
      {k: jnp.asarray(v) for k, v in ref['tiles'].items()}, maps, stride=20,
      margin=4)
  tiles_t = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in ref['tiles'].items()}
  got_c, got_m, got_o = tmont.render_tiles_device(tiles_t, maps, stride=20,
                                                  margin=4)
  assert bool(got_o) == bool(want_o)
  _canvas_close(got_c.numpy(), got_m.numpy(), np.asarray(want_c),
                np.asarray(want_m))
  # Tensor maps take the on-device reduction: the same canvas.
  maps_t = {k: torch.from_numpy(np.array(v)) for k, v in maps.items()}
  dev_c, dev_m, _ = tmont.render_tiles_device(tiles_t, maps_t, stride=20,
                                              margin=4)
  torch.testing.assert_close(dev_c, got_c, rtol=0, atol=1e-4)
  assert torch.equal(dev_m, got_m)


def test_montage_align_2d(ref):
  tcfg = convert.config_from_jax(
      _montage_cfg(jmont, jmesh, flow_mode='circular_dft'))
  timings = {}
  got = tmont.montage_align_2d(ref['tiles'], (2, 2), tcfg, device='cpu',
                               timings=timings)
  out = ref['out']
  assert list(timings) == ['coarse', 'place', 'fine', 'solve', 'render']
  np.testing.assert_array_equal(got['cx'], out['cx'])
  np.testing.assert_array_equal(got['cy'], out['cy'])
  np.testing.assert_allclose(got['coarse'], out['coarse'], atol=1e-3)
  assert got['key_to_idx'] == out['key_to_idx']
  assert got['solve_steps'] == out['solve_steps']
  assert bool(got['overflow']) == bool(out['overflow']) is False
  solved = got['solved'].numpy()
  np.testing.assert_array_equal(np.isnan(solved), np.isnan(out['solved']))
  assert np.nanmax(np.abs(solved - out['solved'])) < MESH_TOL
  canvas, mask = got['canvas'].numpy(), got['mask'].numpy()
  _canvas_close(canvas, mask, out['canvas'], out['mask'])
  # The quality gates of tests/test_stitching.py, modulo tile (0, 0)'s
  # gauge shift.
  i0 = got['key_to_idx'][(0, 0)]
  sx, sy = (int(round(float(solved[c, i0, 0, 0]))) for c in (0, 1))
  sel = np.s_[30 + sy:130 + sy, 30 + sx:130 + sx]
  valid = mask[sel]
  assert valid.mean() > 0.9
  err = np.abs(canvas[sel] - ref['img'][30:130, 30:130].astype(
      np.float32))[valid].mean()
  assert err < 10.0, err


def test_bf16_flows_move_meshes_little(ref):
  # The reference's default correlates in bf16: its fine flows, solved
  # with the port's solver, against the port's float32 flows.
  cfg = tmesh.IntegrationConfig(**_mesh_kw())
  solved = []
  for fx, fy in (_flows(jse, ref['tiles'], ref['cx'], ref['cy'],
                        'circular_dft_bf16', batch_size=16)[::2],
                 (ref['fx'], ref['fy'])):
    fx_a, fy_a, x0, nbors, _ = tse.aggregate_arrays(
        (ref['cx'][:, 0], _to_torch(fx), ref['ox']),
        (ref['cy'][:, 0], _to_torch(fy), ref['oy']), list(ref['tiles']),
        ref['coarse'][:, 0], STRIDE, tile_shape=TILE)
    plan = tse.TargetMeshPlan(nbors, fx_a, fy_a, STRIDE, x0.shape[-2:])
    solved.append(tmesh.relax_mesh(torch.from_numpy(x0), None, cfg,
                                   prev_fn=plan)[0].numpy())
  assert np.nanmax(np.abs(solved[0] - solved[1])) < 0.4


def test_config_from_jax():
  for jcfg in (jmont.MontageConfig(),
               _montage_cfg(jmont, jmesh, flow_mode='circular_dft')):
    tcfg = convert.config_from_jax(jcfg)
    assert isinstance(tcfg, tmont.MontageConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.mesh_cfg.to_json() == jcfg.mesh_cfg.to_json()
  assert convert.config_from_jax(jmont.MontageConfig()) == (
      tmont.MontageConfig())


def test_unported_branches_raise():
  # The sequential search, once a raise, runs (in depth in
  # test_torch_stitch_api.py); with no tiles every pair is missing.
  got = tsr.compute_coarse_offsets((2, 2), {})
  want = jsr.compute_coarse_offsets((2, 2), {})
  for g, w in zip(got, want):
    assert g.shape == w.shape == (2, 1, 2, 2) and np.isnan(g).all()
