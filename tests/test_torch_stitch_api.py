"""The tile-stitching library API of sofima_tpu_torch against sofima_tpu (CPU).

The same numpy-seeded tiles go through the JAX functions and the port's
(device='cpu', plain versions of the kernels):
  * stitch_rigid.compute_coarse_offsets, the sequential search: on
    tests/test_stitching.py's 2 x 2 tiles of 160 px, on a jittered cut
    (every pair's offset differs), with a tile missing and with a
    `mask_map` (one mask blanks a whole strip, which the search drops);
    equal to the reference's offsets and, without masks, to the port's
    compute_coarse_offsets_batched;
  * elastic_tile_mesh_3d (forces within f32 noise) and
    optimize_coarse_mesh with it;
  * stitch_elastic.compute_flow_map in its default padfield mode;
  * mesh.relax_mesh_fused with `prev_fn` (within 0.01 * stride);
  * compute_target_mesh's default stride;
  * two chains, self-checking: examples/e2e_stitching.py at 2 x 2 tiles
    of 160 px (e2e's own gate, err < 10 and coverage > 0.95, on the
    port's render; solved meshes within 0.01 * stride of the reference
    chain's, which stops before its render) and the flow-and-solve
    part of the LICONN in-plane stitching notebook (coarse offsets on
    the mid slices, the 3d tile mesh, compute_flow_map3d, clean_flow,
    aggregate_arrays, relax_mesh with prev_fn and elastic_mesh_3d;
    solved meshes within 0.01 * stride).
Flow bars: integer x/y peaks and NaN placement exact; sharpness and
ratio within rtol = atol = 3e-4 for at least 99% of the nodes
(FLOW_STAT_TOL) and within rtol 2e-3 for all.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_utils as jfu
from sofima_tpu import mesh as jmesh
from sofima_tpu import stitch_elastic as jse
from sofima_tpu import stitch_rigid as jsr
from sofima_tpu_torch import flow_utils as tfu
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch import stitch_elastic as tse
from sofima_tpu_torch import stitch_rigid as tsr
from sofima_tpu_torch import warp as twarp

torch.set_num_threads(2)
OVERLAPS = ((65, 75), (65, 75))
FLOW_STAT_TOL = 3e-4


def _texture(n, seed=0, sigma=0.1):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * sigma ** 2)))
  tex = np.fft.irfft2(f, s=(n, n))
  tex = (tex - tex.min()) / np.ptp(tex)
  return (tex * 255).astype(np.uint8)


def _cut_tiles(img, tile=160, overlap=60, grid=2, jitter=None):
  step = tile - overlap
  tiles = {}
  for ty in range(grid):
    for tx in range(grid):
      dy, dx = (0, 0) if jitter is None else jitter[(tx, ty)]
      y0, x0 = ty * step + dy, tx * step + dx
      tiles[(tx, ty)] = img[y0:y0 + tile, x0:x0 + tile].copy()
  return tiles


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _same_flow(got, ref, d=2):
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:d], nan=9e9),
                                np.nan_to_num(ref[:d], nan=9e9))
  np.testing.assert_array_equal(np.isnan(got[d:]), np.isnan(ref[d:]))
  fin = np.isfinite(ref[d:])
  diff = np.abs(got[d:][fin] - ref[d:][fin])
  close = diff <= FLOW_STAT_TOL + FLOW_STAT_TOL * np.abs(ref[d:][fin])
  assert close.mean() >= 0.99, close.mean()
  np.testing.assert_allclose(got[d:], ref[d:], rtol=2e-3, atol=FLOW_STAT_TOL)


def _jittered_tiles():
  """2 x 2 tiles of 160 cut at 100 px steps, each moved by a few px."""
  jitter = {(0, 0): (15, 5), (1, 0): (18, 1), (0, 1): (13, 10),
            (1, 1): (19, 7)}
  return _cut_tiles(_texture(280, seed=1), jitter=jitter)


@pytest.mark.parametrize('case', ['exact', 'jitter', 'missing'])
def test_coarse_offsets_sequential(case):
  tiles = (_cut_tiles(_texture(260)) if case != 'jitter'
           else _jittered_tiles())
  if case == 'missing':
    del tiles[(1, 1)]
  kw = dict(overlaps_xy=OVERLAPS, min_overlap=10)
  want = jsr.compute_coarse_offsets((2, 2), tiles, **kw)
  tt = {k: _t(v) for k, v in tiles.items()}
  got = tsr.compute_coarse_offsets((2, 2), tt, **kw)
  batched = tsr.compute_coarse_offsets_batched((2, 2), tt, **kw)
  for g, w, b in zip(got, want, batched):
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(g, b)
  assert np.isfinite(got[0][:, 0, 0, 0]).all()
  if case == 'jitter':  # every pair's offset is its own
    assert len({tuple(got[0][:, 0, y, 0]) for y in range(2)}
               | {tuple(got[1][:, 0, 0, x]) for x in range(2)}) == 4
  if case == 'missing':
    assert np.isnan(got[0][0, 0, 1, 0]) and np.isnan(got[1][0, 0, 0, 1])


def test_coarse_offsets_mask_map(monkeypatch):
  # The reference ORs the caller's masks into np.asarray of a JAX array,
  # which is read-only (sofima_tpu/stitch_rigid.py:60 raises ValueError);
  # here its range masks come back as writable copies, and nothing else
  # of it changes.
  range_mask = jsr._dynamic_range_mask
  monkeypatch.setattr(jsr, '_dynamic_range_mask',
                      lambda *a: np.array(range_mask(*a)))
  tiles = _jittered_tiles()
  rng = np.random.RandomState(4)
  masks = {k: np.zeros(v.shape, bool) for k, v in tiles.items()}
  masks[(0, 0)][20:70, 90:] = True   # part of the right strip
  masks[(1, 0)][:, :80] = True       # the whole left strip: dropped
  masks[(0, 1)] = rng.rand(*masks[(0, 1)].shape) < 0.2
  kw = dict(overlaps_xy=OVERLAPS, min_overlap=10)
  want = jsr.compute_coarse_offsets((2, 2), tiles, mask_map=masks, **kw)
  got = tsr.compute_coarse_offsets(
      (2, 2), {k: _t(v) for k, v in tiles.items()},
      mask_map={k: _t(v) for k, v in masks.items()}, **kw)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)
  assert np.isfinite(got[0][:, 0, 0, 0]).all()


def test_estimate_offset_single_peak_ratio_is_zero():
  # A strip-sized surface with one peak gives a ratio of exactly 0.0,
  # the early exit of _select_offset.
  tiles = _cut_tiles(_texture(260))
  a, b = tsr._overlap_crops(_t(tiles[(0, 0)]), _t(tiles[(1, 0)]), 65, 0)
  off, pr = tsr._estimate_offset(a, b, 0)
  want_off, want_pr = jsr._estimate_offset(
      *jsr._overlap_crops(tiles[(0, 0)], tiles[(1, 0)], 65, 0), 0)
  assert pr == 0.0 and want_pr == 0.0
  assert [float(v) for v in off] == [float(v) for v in want_off]


def _tile_mesh_inputs(seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(3, 1, 3, 4).astype(np.float32) * 5
  cx = rng.randn(3, 1, 3, 4).astype(np.float32) * 10
  cy = rng.randn(3, 1, 3, 4).astype(np.float32) * 10
  cx[:, 0, 1, 3] = np.nan  # a missing pair adds no force
  return x, cx, cy


def test_elastic_tile_mesh_3d():
  x, cx, cy = _tile_mesh_inputs(0)
  want = np.asarray(jsr.elastic_tile_mesh_3d(jnp.asarray(x), jnp.asarray(cx),
                                             jnp.asarray(cy)))
  got = tsr.elastic_tile_mesh_3d(_t(x), _t(cx), _t(cy), k=0.1, stride=1)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
  assert np.abs(want[2]).max() > 1  # the z coupling acts


def test_optimize_coarse_mesh_3d():
  _, cx, cy = _tile_mesh_inputs(1)
  cx[:, 0, :, 3] = np.nan
  cy[:, 0, 2, :] = np.nan
  want = jsr.optimize_coarse_mesh(cx, cy,
                                  mesh_fn=jsr.elastic_tile_mesh_3d)
  got = tsr.optimize_coarse_mesh(cx, cy, mesh_fn=tsr.elastic_tile_mesh_3d,
                                 device='cpu')
  assert got.shape == want.shape == (3, 1, 3, 4)
  np.testing.assert_allclose(got, want, rtol=0, atol=0.01)


def test_compute_flow_map_padfield():
  tiles = _jittered_tiles()
  cx, cy = jsr.compute_coarse_offsets((2, 2), tiles, overlaps_xy=OVERLAPS,
                                      min_overlap=10)
  tt = {k: _t(v) for k, v in tiles.items()}
  for axis, conn in ((0, cx), (1, cy)):
    want, want_off = jse.compute_flow_map(tiles, conn[:, 0], axis=axis,
                                          patch_size=(40, 40),
                                          stride=(20, 20), batch_size=16)
    got, got_off = tse.compute_flow_map(tt, conn[:, 0], axis=axis,
                                        patch_size=(40, 40), stride=(20, 20),
                                        batch_size=16)
    assert got_off == want_off and got.keys() == want.keys()
    for k in want:
      assert isinstance(got[k], torch.Tensor)
      _same_flow(got[k].numpy(), want[k])


def test_relax_mesh_fused_prev_fn():
  rng = np.random.RandomState(2)
  x0 = rng.randn(2, 1, 6, 7).astype(np.float32)
  tgt = rng.randn(2, 1, 6, 7).astype(np.float32) * 3
  tgt[:, 0, 2, 3] = np.nan
  kw = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(20.0, 20.0),
            num_iters=100, max_iters=5000, stop_v_max=0.005, dt_max=100.0)
  tgt_j, tgt_t = jnp.asarray(tgt), _t(tgt)
  want, _, want_steps = jmesh.relax_mesh_fused(
      jnp.asarray(x0), None, jmesh.IntegrationConfig(**kw),
      prev_fn=lambda x: tgt_j + 0.1 * x)
  got, _, steps = tmesh.relax_mesh_fused(
      _t(x0), None, tmesh.IntegrationConfig(**kw),
      prev_fn=lambda x: tgt_t + 0.1 * x)
  assert int(steps) == int(want_steps)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                             atol=0.2)  # 0.01 * stride


def test_compute_target_mesh_default_stride():
  nbors = np.full((1, 4, 8), -1)
  x = torch.zeros(2, 1, 3, 3)
  f = torch.zeros(2, 1, 3, 3)
  assert torch.isnan(tse.compute_target_mesh(nbors[0], x, f, f)).all()


def _e2e_chain(tiles, sr, se, relax, render, asarray, prev_fn_of):
  """examples/e2e_stitching.py's steps, on one package."""
  stride = (20, 20)
  ov = (65, 75)
  cx, cy = sr.compute_coarse_offsets((2, 2), tiles, overlaps_xy=(ov, ov),
                                     min_overlap=10)
  cx = sr.interpolate_missing_offsets(cx, axis=-1)
  cy = sr.interpolate_missing_offsets(cy, axis=-2)
  coarse = np.asarray(sr.optimize_coarse_mesh(cx, cy))
  fine_x, off_x = se.compute_flow_map(tiles, cx[:, 0], axis=0,
                                      patch_size=(40, 40), stride=stride,
                                      batch_size=64)
  fine_y, off_y = se.compute_flow_map(tiles, cy[:, 0], axis=1,
                                      patch_size=(40, 40), stride=stride,
                                      batch_size=64)
  fx, fy, x0, nbors, key_to_idx = se.aggregate_arrays(
      (cx[:, 0], fine_x, off_x), (cy[:, 0], fine_y, off_y), list(tiles),
      coarse[:, 0], stride, tile_shape=(160, 160))
  solved, steps = relax(asarray(x0), prev_fn_of(fx, fy, nbors, stride,
                                                 x0.shape[-2:]))
  solved = np.asarray(solved)
  out = dict(cx=cx, cy=cy, solved=solved, key_to_idx=key_to_idx,
             steps=steps)
  if render is not None:
    maps = {k: solved[:, i:i + 1] for k, i in key_to_idx.items()}
    out['canvas'], out['mask'] = render(tiles, maps, stride=stride, margin=4)
  return out


def _e2e_gate(out, img):
  """e2e_stitching.py's check: mean |err| < 10, coverage > 0.95."""
  solved, key_to_idx = out['solved'], out['key_to_idx']
  sx = int(round(solved[0, key_to_idx[(0, 0)], 0, 0]))
  sy = int(round(solved[1, key_to_idx[(0, 0)], 0, 0]))
  n, tile = img.shape[0], 160
  lo, hi = tile // 4, n - tile // 4
  c = out['canvas'][lo + sy:hi + sy, lo + sx:hi + sx].astype(np.float32)
  m = out['mask'][lo + sy:hi + sy, lo + sx:hi + sx]
  t = img[lo:hi, lo:hi].astype(np.float32)
  return float(np.abs(c - t)[m].mean()), float(m.mean())


def _e2e_cfg(mod):
  return mod.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(20, 20), num_iters=400,
      max_iters=20000, stop_v_max=0.005, dt_max=100.0)


def test_e2e_stitching_chain():
  img = _texture(260, seed=5)
  tiles = _cut_tiles(img)

  def jax_prev_fn(fx, fy, nbors, stride, mesh_shape):
    del mesh_shape
    fx_j, fy_j, nb = jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(nbors)

    def prev_fn(x):
      return jnp.moveaxis(jax.vmap(functools.partial(
          jse.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
          stride=stride))(nb), 0, 1)
    return prev_fn

  def jax_relax(x0, prev_fn):
    x, _, steps = jmesh.relax_mesh(x0, None, _e2e_cfg(jmesh),
                                   prev_fn=prev_fn)
    return x, steps

  want = _e2e_chain(tiles, jsr, jse, jax_relax, None, jnp.asarray,
                    jax_prev_fn)

  def torch_prev_fn(fx, fy, nbors, stride, mesh_shape):
    # The reference's vmap of compute_target_mesh over the tiles.
    return tse.TargetMeshPlan(nbors, fx, fy, stride, mesh_shape)

  def torch_relax(x0, prev_fn):
    x, _, steps = tmesh.relax_mesh(x0, None, _e2e_cfg(tmesh),
                                   prev_fn=prev_fn)
    return x, steps

  tt = {k: _t(v) for k, v in tiles.items()}
  got = _e2e_chain(
      tt, _CpuRigid, tse, torch_relax,
      functools.partial(twarp.render_tiles, device='cpu'), _t,
      torch_prev_fn)
  for g, w in zip((got['cx'], got['cy']), (want['cx'], want['cy'])):
    np.testing.assert_array_equal(g, w)
  err, cover = _e2e_gate(got, img)
  assert err < 10.0 and cover > 0.95, (err, cover)
  assert got['key_to_idx'] == want['key_to_idx']
  np.testing.assert_array_equal(np.isnan(got['solved']),
                                np.isnan(want['solved']))
  np.testing.assert_allclose(got['solved'], want['solved'], rtol=0,
                             atol=0.2)  # 0.01 * stride


class _CpuRigid:
  """stitch_rigid with its host inputs placed on the CPU."""
  compute_coarse_offsets = staticmethod(functools.partial(
      tsr.compute_coarse_offsets, device='cpu'))
  elastic_tile_mesh_3d = staticmethod(tsr.elastic_tile_mesh_3d)
  interpolate_missing_offsets = staticmethod(tsr.interpolate_missing_offsets)
  optimize_coarse_mesh = staticmethod(functools.partial(
      tsr.optimize_coarse_mesh, device='cpu'))


class _Tile:
  """[1, z, y, x] view of a tile, as the stitching API consumes it."""

  def __init__(self, data):
    self.data = data[None]
    self.shape = self.data.shape

  def __getitem__(self, sel):
    return self.data[sel]


def _liconn_volume():
  """The LICONN notebook's synthetic volume: 24 x 80 x 80 (seed 3)."""
  shape = (24, 80, 80)
  rng = np.random.RandomState(3)
  f = np.fft.rfftn(rng.rand(*shape).astype(np.float32), axes=(0, 1, 2))
  freqs = np.meshgrid(*[np.fft.fftfreq(s) for s in shape[:-1]]
                      + [np.fft.rfftfreq(shape[-1])], indexing='ij')
  f *= np.exp(-sum(fr ** 2 for fr in freqs) / (2 * 0.12 ** 2))
  vol = np.fft.irfftn(f, s=shape, axes=(0, 1, 2))
  return ((vol - vol.min()) / np.ptp(vol) * 255).astype(np.float32)


def _liconn_chain(tile_data, sr, se, fu, relax, asarray, view, prev_fn_of):
  """The notebook's flow-and-solve cells on one package."""
  tile_size, overlap, nzt = 48, 16, 24
  mid = {k: v[nzt // 2] for k, v in tile_data.items()}
  ov = (overlap - 4, overlap + 8)
  cx, cy = sr.compute_coarse_offsets((2, 2), mid, overlaps_xy=(ov, ov),
                                     min_overlap=8)

  def lift(c):
    out = np.full((3,) + c.shape[1:], np.nan, np.float32)
    out[:2] = c
    out[2] = np.where(np.isfinite(c[0]), 0.0, np.nan)
    return out

  cx3, cy3 = lift(cx), lift(cy)
  coarse_mesh = np.asarray(sr.optimize_coarse_mesh(
      cx3, cy3, mesh_fn=sr.elastic_tile_mesh_3d))
  stride3 = (8, 8, 8)
  tile_map = {k: view(v) for k, v in tile_data.items()}
  kw = dict(tile_shape=(tile_size, tile_size, nzt), patch_size=(16, 16, 16),
            stride=stride3, batch_size=16)
  flow_x, off_x = se.compute_flow_map3d(tile_map, offset_map=cx3, axis=0,
                                        **kw)
  flow_y, off_y = se.compute_flow_map3d(tile_map, offset_map=cy3, axis=1,
                                        **kw)

  def clean(flows):
    return {k: fu.clean_flow(v, min_peak_ratio=1.2, min_peak_sharpness=1.2,
                             max_magnitude=0, max_deviation=5, dim=3)
            for k, v in flows.items()}

  fine_x, fine_y = clean(flow_x), clean(flow_y)
  fx, fy, x0, nbors, key_to_idx = se.aggregate_arrays(
      (cx3[:, 0], fine_x, off_x), (cy3[:, 0], fine_y, off_y),
      list(tile_map), coarse_mesh[:, 0], stride3,
      tile_shape=(nzt, tile_size, tile_size))
  solved, steps = relax(asarray(x0), prev_fn_of(fx, fy, nbors, stride3,
                                                 x0.shape[-3:]))
  return dict(cx=cx, cy=cy, coarse=coarse_mesh, flow_x=flow_x,
              solved=np.asarray(solved), key_to_idx=key_to_idx, steps=steps)


def _liconn_cfg(mod):
  return mod.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(8, 8, 8), num_iters=200,
      max_iters=10000, stop_v_max=0.01, dt_max=100.0)


def test_liconn_flow_and_solve_chain():
  vol = _liconn_volume()
  tile_data = {(tx, ty): vol[:, ty * 32:ty * 32 + 48, tx * 32:tx * 32 + 48]
               for ty in range(2) for tx in range(2)}

  def jax_prev_fn(fx, fy, nbors, stride, mesh_shape):
    del mesh_shape
    fx_j, fy_j, nb = jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(nbors)
    return lambda x: jnp.moveaxis(jax.vmap(functools.partial(
        jse.compute_target_mesh, x=x, fx=fx_j, fy=fy_j,
        stride=stride))(nb), 0, 1)

  def jax_relax(x0, prev_fn):
    x, _, steps = jmesh.relax_mesh(x0, None, _liconn_cfg(jmesh),
                                   prev_fn=prev_fn,
                                   mesh_force=jmesh.elastic_mesh_3d)
    return x, steps

  want = _liconn_chain(tile_data, jsr, jse, jfu, jax_relax, jnp.asarray,
                       _Tile, jax_prev_fn)

  def torch_prev_fn(fx, fy, nbors, stride, mesh_shape):
    return tse.TargetMeshPlan(nbors, fx, fy, stride, mesh_shape)

  def torch_relax(x0, prev_fn):
    x, _, steps = tmesh.relax_mesh(x0, None, _liconn_cfg(tmesh),
                                   prev_fn=prev_fn,
                                   mesh_force=tmesh.elastic_mesh_3d)
    return x, steps

  flow_utils = type('FlowUtils', (), {'clean_flow': staticmethod(
      functools.partial(tfu.clean_flow, device='cpu'))})
  got = _liconn_chain(tile_data, _CpuRigid, tse, flow_utils, torch_relax, _t,
                      lambda v: _Tile(_t(v)), torch_prev_fn)
  for g, w in ((got['cx'], want['cx']), (got['cy'], want['cy'])):
    np.testing.assert_array_equal(g, w)
  np.testing.assert_allclose(got['coarse'], want['coarse'], rtol=0,
                             atol=0.01)
  for k in want['flow_x']:
    _same_flow(got['flow_x'][k].numpy(), want['flow_x'][k], d=3)
  assert got['key_to_idx'] == want['key_to_idx']
  np.testing.assert_array_equal(np.isnan(got['solved']),
                                np.isnan(want['solved']))
  np.testing.assert_allclose(got['solved'], want['solved'], rtol=0,
                             atol=0.08)  # 0.01 * stride
