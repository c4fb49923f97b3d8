"""The decorator layer of sofima_tpu_torch against sofima_tpu (CPU).

The same numpy-seeded volumes are written to zarr stores under
`tmp_path`, and each decorator of both packages decorates the same
store (the port with device='cpu': `jax_device='cpu'` for OptimFlow, a
`device='cpu'` keyword for the others). Tolerances:
  * CleanFlowFilter, ReconcileFlowFilter, ComposeCoordMaps,
    MakeAffineCoordMap: the same NaN pattern and 1e-5 abs;
  * OptimFlow, padfield and circular, 2d and 3d, with and without masks,
    `pad` True and False: x/y and NaN placement exact, statistics by
    share (test_torch_flow_padfield.py's `_same`);
  * MeshRelaxFlowFilter 2d within 0.01 x stride of the reference; 3d
    equal to the port's own `mesh.relax_mesh` with `elastic_mesh_3d`
    (test_torch_mesh3d.py holds that against the reference);
  * WarpAffine (native and scipy) and WarpCoordMap: rendered grays
    within 1e-2 (the port's render bar) where both sample inside the
    image, and within one gray level (docs/PARITY.md's bound) on the
    whole image. As in test_torch_warp_api.py's 3d case, the CPU
    reference is sent down its shift path (taps outside the image read
    0, as on the TPU and in the port) by raising its gather's cost;
  * OptimAffineTransformSectionwise (with `batch_dim` and
    `init_previous`) and OptimTranslationTransform: ECC matrices within
    1e-3, translations exact.
Plus the registry's names, decorate_volume's spec forms, and twins of
the decorator-spec cases of tests/test_caching_and_masks.py: WarpByMap
with `map_decorator_specs` (ComposeCoordMaps) and `data_decorator_specs`
(a registered DoubleFilterForTest filter) against the reference's
processor; and, without a card, the chunk functions raise unless given
the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

ts = pytest.importorskip('tensorstore')

from sofima_tpu import decorators as j_decorators
from sofima_tpu import mesh as j_mesh
from sofima_tpu.decorators import affine as j_affine
from sofima_tpu.decorators import base as j_base
from sofima_tpu.decorators import flow as j_flow
from sofima_tpu.decorators import maps as j_maps
from sofima_tpu.decorators import warp as j_warp
from sofima_tpu.ops import registration as j_reg
from sofima_tpu.processor import warp as j_warp_proc
from sofima_tpu.processor.defaults import em_2d as j_em
from sofima_tpu.utils import bounding_box as j_bbox
from sofima_tpu.utils import subvolume as j_sub
from sofima_tpu.utils import volume as j_vol
from sofima_tpu_torch import decorators as t_decorators
from sofima_tpu_torch import mesh as t_mesh
from sofima_tpu_torch.decorators import affine as t_affine
from sofima_tpu_torch.decorators import base as t_base
from sofima_tpu_torch.decorators import flow as t_flow
from sofima_tpu_torch.decorators import maps as t_maps
from sofima_tpu_torch.decorators import warp as t_warp
from sofima_tpu_torch.processor import warp as t_warp_proc
from sofima_tpu_torch.processor.defaults import em_2d as t_em
from sofima_tpu_torch.utils import bounding_box as t_bbox
from sofima_tpu_torch.utils import subvolume as t_sub
from sofima_tpu_torch.utils import volume as t_vol
from tests.test_torch_flow_padfield import _same

torch.set_num_threads(2)

NAMES = {'OptimFlow', 'CleanFlowFilter', 'MeshRelaxFlowFilter',
         'ReconcileFlowFilter', 'ComposeCoordMaps', 'MakeAffineCoordMap',
         'WarpAffine', 'WarpCoordMap', 'OptimAffineTransformSectionwise',
         'OptimTranslationTransform'}
CPU = {'device': 'cpu'}


def _store(tmp_path, data, labels, name):
  spec = {
      'driver': 'zarr',
      'kvstore': {'driver': 'file', 'path': str(tmp_path / name)},
      'metadata': {'shape': list(data.shape), 'chunks': list(data.shape),
                   'dtype': np.dtype(data.dtype).str},
      'create': True,
      'delete_existing': True,
  }
  store = ts.open(spec).result()
  store = store[ts.d[:].label[labels]]
  store.write(data).result()
  return store, store.spec().to_json()


def _texture(shape, seed=0, sigma=0.1):
  rng = np.random.RandomState(seed)
  f = np.fft.rfftn(rng.rand(*shape).astype(np.float32))
  freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]],
                      np.fft.rfftfreq(shape[-1]), indexing='ij')
  f *= np.exp(-sum(q ** 2 for q in freqs) / (2 * sigma ** 2))
  tex = np.fft.irfftn(f, s=shape, axes=tuple(range(len(shape))))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


def _noisy_flow(seed=3, z=1):
  """A 4-channel flow with outliers, weak peaks and a NaN hole."""
  rng = np.random.RandomState(seed)
  flow = np.zeros((4, z, 12, 14), np.float32)
  flow[0] = 2.0 + rng.randn(z, 12, 14) * 0.5
  flow[1] = -1.0 + rng.randn(z, 12, 14) * 0.5
  flow[2] = 2.5 + rng.rand(z, 12, 14)
  flow[3] = 2.0 + rng.rand(z, 12, 14)
  flow[0, 0, 3, 4] = 55.0
  flow[1, 0, 7, 2] = 9.0
  flow[2, 0, 5, 5] = 0.1
  flow[3, 0, 8, 9] = 1.0
  flow[:, 0, 2, 10] = np.nan
  return flow


def _same_nan(got, ref, atol=1e-5):
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                             atol=atol, rtol=0)


def test_registry_names():
  # Other test files may register a DoubleFilterForTest in either
  # registry; the decorators of the packages are the same ten.
  for mod in (j_decorators, t_decorators):
    assert set(mod.registered()) - {'DoubleFilterForTest'} == NAMES
  with pytest.raises(KeyError, match='Unknown decorator'):
    t_base.build('NoSuchDecorator')
  assert isinstance(t_base.build('CleanFlowFilter', min_peak_ratio=1.6),
                    t_flow.CleanFlowFilter)


# -- flow ----------------------------------------------------------------


def test_clean_flow_filter(tmp_path):
  store, _ = _store(tmp_path, _noisy_flow(), ['fc', 'fz', 'fy', 'fx'], 'f')
  args = dict(min_peak_ratio=1.6, min_peak_sharpness=1.6, max_magnitude=40,
              max_deviation=3)
  ref = np.array(j_flow.CleanFlowFilter(**args).decorate(store))
  got = t_flow.CleanFlowFilter(**args, **CPU).decorate(store)
  assert got.shape == ref.shape == (2, 1, 12, 14)
  _same_nan(np.array(got), ref)


def test_reconcile_flow_filter(tmp_path):
  flow = np.concatenate([_noisy_flow()[:2], _noisy_flow(seed=5)[:2]], 1)
  flow[0, 0, 4, 6] = 30.0
  store, _ = _store(tmp_path, flow, ['fc', 'fz', 'fy', 'fx'], 'f')
  args = dict(max_gradient=5.0, max_deviation=3.0, min_patch_size=4)
  ref = np.array(j_flow.ReconcileFlowFilter(**args).decorate(store))
  got = np.array(t_flow.ReconcileFlowFilter(**args, **CPU).decorate(store))
  _same_nan(got, ref)
  assert np.isnan(got).any() and np.isfinite(got).any()


MESH_ARGS = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, num_iters=200,
                 max_iters=20000, stop_v_max=1e-4, dt_max=100.0)


def test_mesh_relax_flow_filter_2d(tmp_path):
  y, x = np.mgrid[:10, :12].astype(np.float32)
  flow = np.stack([
      np.stack([1.5 * np.sin(y / 3), 0.8 * np.sin(y / 2)]),
      np.stack([1.0 * np.cos(x / 4), -0.6 * np.cos(x / 5)]),
  ]).astype(np.float32)
  flow[:, 0, 4, 5] = np.nan
  store, _ = _store(tmp_path, flow, ['fc', 'fz', 'fy', 'fx'], 'f')
  args = dict(MESH_ARGS, stride=(40, 40))
  ref = np.array(j_flow.MeshRelaxFlowFilter(**args).decorate(store))
  got = np.array(t_flow.MeshRelaxFlowFilter(**args, **CPU).decorate(store))
  assert got.shape == flow.shape
  np.testing.assert_allclose(got, ref, atol=0.01 * 40)
  assert np.abs(got).max() > 0.3  # the mesh followed the flow


def test_mesh_relax_flow_filter_3d(tmp_path):
  rng = np.random.RandomState(6)
  flow = rng.randn(3, 4, 5, 6).astype(np.float32)
  flow[:, 1, 2, 3] = np.nan
  store, _ = _store(tmp_path, flow, ['fc', 'fz', 'fy', 'fx'], 'f')
  args = dict(MESH_ARGS, stride=(40, 40, 30), max_iters=2000)
  got = np.array(t_flow.MeshRelaxFlowFilter(**args, **CPU).decorate(store))
  prev = torch.from_numpy(flow)
  direct, _, _ = t_mesh.relax_mesh(
      torch.zeros_like(prev), prev, t_mesh.IntegrationConfig(**args),
      mesh_force=t_mesh.elastic_mesh_3d)
  np.testing.assert_array_equal(got, direct.numpy())
  assert np.isfinite(got).all()


def _flow_stores(tmp_path, ndim, masked):
  """Input (moved) and fixed stores ([x, y(, z)] + a trailing 'b' batch
  dim of 1 in 2d) and, if `masked`, mask stores of both."""
  if ndim == 2:
    tex = _texture((96, 112), seed=0)
    moved = np.roll(tex, (3, -2), (0, 1))
    to_store = lambda a: a.T[:, :, None]
    labels = ['x', 'y', 'b']
  else:
    tex = _texture((24, 40, 36), seed=1)
    moved = np.roll(tex, (1, 2, -3), (0, 1, 2))
    to_store = lambda a: a.T
    labels = ['x', 'y', 'z']
  in_ts, _ = _store(tmp_path, to_store(moved), labels, 'in')
  _, fixed_spec = _store(tmp_path, to_store(tex), labels, 'fixed')
  masks = {}
  if masked:
    rng = np.random.RandomState(7)
    for name in ('input_mask_spec', 'fixed_mask_spec'):
      m = np.zeros(tex.shape, bool)
      m[tuple(slice(s // 3, s // 3 + s // 4) for s in tex.shape)] = True
      m |= rng.rand(*tex.shape) < 0.02
      masks[name] = _store(tmp_path, to_store(m), labels, name)[1]
  return in_ts, fixed_spec, masks


@pytest.mark.parametrize('ndim, mode, masked, pad', [
    (2, 'padfield', False, False),
    (2, 'padfield', True, True),
    (2, 'circular_dft', False, True),
    (2, 'circular_dft', True, False),
    (3, 'padfield', False, True),
    (3, 'padfield', True, False),
    (3, 'circular', False, True),
])
def test_optim_flow(tmp_path, ndim, mode, masked, pad):
  in_ts, fixed_spec, masks = _flow_stores(tmp_path, ndim, masked)
  if ndim == 2:
    kw = dict(patch_size=(32, 32), step_size=(16, 16), image_dims=('x', 'y'))
  else:
    kw = dict(patch_size=(16, 16, 12), step_size=(8, 8, 6),
              image_dims=('x', 'y', 'z'))
  kw.update(fixed_spec=fixed_spec, batch_size=8, pad=pad, mode=mode, **masks)
  ref = np.array(j_flow.OptimFlow(**kw).decorate(in_ts))
  view = t_flow.OptimFlow(**kw, jax_device='cpu').decorate(in_ts)
  assert view.domain.labels == (('fc', 'fz', 'fy', 'fx')
                                + (('b',) if ndim == 2 else ()))
  got = np.array(view)
  assert got.shape == ref.shape
  _same(got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1))
  core = got[(slice(None), 0) if ndim == 2 else (slice(None),)]
  if pad:
    assert np.isnan(core[(slice(None),) + (0,) * ndim]).all()
  assert np.isfinite(core[0]).mean() > 0.3


def test_optim_flow_matches_the_calculator(tmp_path):
  in_ts, fixed_spec, _ = _flow_stores(tmp_path, 2, False)
  got = np.array(t_flow.OptimFlow(
      fixed_spec=fixed_spec, patch_size=(32, 32), step_size=(16, 16),
      batch_size=8, pad=False, jax_device='cpu').decorate(in_ts))
  moved = np.array(in_ts)[..., 0].T
  fixed = np.array(ts.open(fixed_spec).result())[..., 0].T
  direct = t_flow.flow_field_lib.JAXMaskedXCorrWithStatsCalculator(
      device='cpu').flow_field(moved, fixed, (32, 32), (16, 16),
                               batch_size=8)
  np.testing.assert_array_equal(got[:, 0, :, :, 0], direct)
  assert t_flow._torch_device('gpu') is None
  assert t_flow._torch_device(None) is None
  assert t_flow._torch_device('cpu') == 'cpu'


# -- maps ----------------------------------------------------------------


def test_compose_coord_maps(tmp_path):
  rng = np.random.RandomState(8)
  m1 = rng.randn(2, 1, 8, 9).astype(np.float32) * 3
  m2 = rng.randn(2, 1, 8, 9).astype(np.float32) * 3
  m1[:, 0, 2, 2] = np.nan
  in_ts, _ = _store(tmp_path, m1, ['fc', 'fz', 'fy', 'fx'], 'm1')
  _, m2_spec = _store(tmp_path, m2, ['fc', 'fz', 'fy', 'fx'], 'm2')
  for extra in ({}, {'stride1': 8.0, 'stride2': 8.0}):
    ref = np.array(j_maps.ComposeCoordMaps(
        coord_map_spec=m2_spec, **extra).decorate(in_ts))
    got = np.array(t_maps.ComposeCoordMaps(
        coord_map_spec=m2_spec, **extra, **CPU).decorate(in_ts))
    _same_nan(got, ref)


def test_make_affine_coord_map(tmp_path):
  rng = np.random.RandomState(9)
  mats = np.stack([np.hstack([np.eye(3) + 0.01 * rng.randn(3, 3),
                              rng.randn(3, 1) * 5]) for _ in range(2)], -1)
  in_ts, _ = _store(tmp_path, mats, ['r', 'c', 'b'], 'mat')
  ref = np.array(j_maps.MakeAffineCoordMap(size=(6, 5, 4)).decorate(in_ts))
  got = t_maps.MakeAffineCoordMap(size=(6, 5, 4)).decorate(in_ts)
  assert got.shape == (3, 4, 5, 6, 2)
  _same_nan(np.array(got), ref)


# -- warp ----------------------------------------------------------------


def _render_close(got, ref, inside):
  np.testing.assert_allclose(got[inside], ref[inside], atol=1e-2, rtol=0)
  np.testing.assert_allclose(got, ref, atol=1.0, rtol=0)


@pytest.fixture
def shift_path(monkeypatch):
  from sofima_tpu.ops import shift_warp as jsw
  monkeypatch.setattr(jsw, 'GATHER_COST_PER_TAP', 1.0)


@pytest.mark.parametrize('implementation, order', [
    ('native', 1), ('native', 3), ('native', 0), ('scipy', 1)])
def test_warp_affine_2d(tmp_path, shift_path, implementation, order):
  tex = _texture((64, 72), seed=10)
  in_ts, _ = _store(tmp_path, np.stack([tex.T, tex.T[::-1]], -1),
                    ['x', 'y', 'z'], 'img')
  th = np.deg2rad(3.0)
  mats = np.stack([
      np.array([[np.cos(th), -np.sin(th), 5.3], [np.sin(th), np.cos(th),
                                                 -2.6]]),
      np.array([[1.02, 0.0, -1.5], [0.01, 0.98, 2.25]])], -1)
  _, mat_spec = _store(tmp_path, mats, ['r', 'c', 'z'], 'mat')
  kw = dict(transform_spec=mat_spec, implementation=implementation,
            order=order)
  ref = np.array(j_warp.WarpAffine(**kw).decorate(in_ts))
  got = np.array(t_warp.WarpAffine(**kw, **CPU).decorate(in_ts))
  assert got.shape == ref.shape == (72, 64, 2)
  inside = np.zeros(got.shape, bool)
  inside[8:-8, 8:-8] = True
  _render_close(got, ref, inside)


def test_warp_affine_3d(tmp_path, shift_path):
  vol = _texture((12, 20, 18), seed=11)  # zyx
  in_ts, _ = _store(tmp_path, vol.T, ['x', 'y', 'z'], 'vol')
  mat = np.array([[1.0, 0.02, 0.0, 1.25], [-0.02, 1.0, 0.0, -0.5],
                  [0.0, 0.0, 1.0, 0.75]])
  _, mat_spec = _store(tmp_path, mat, ['r', 'c'], 'mat')
  kw = dict(transform_spec=mat_spec, image_dims=('x', 'y', 'z'))
  ref = np.array(j_warp.WarpAffine(**kw).decorate(in_ts))
  got = np.array(t_warp.WarpAffine(**kw, **CPU).decorate(in_ts))
  inside = np.zeros(got.shape, bool)
  inside[3:-3, 3:-3, 2:-2] = True
  _render_close(got, ref, inside)


def test_warp_coord_map(tmp_path):
  rng = np.random.RandomState(12)
  vol = rng.rand(16, 14, 8).astype(np.float32)  # xyz
  in_ts, _ = _store(tmp_path, vol, ['x', 'y', 'z'], 'vol')
  cmap = 0.7 * rng.randn(3, 8, 14, 16).astype(np.float32)
  _, cm_spec = _store(tmp_path, cmap, ['fc', 'fz', 'fy', 'fx'], 'cmap')
  for kw in ({}, {'order': 3, 'mode': 'nearest'},
             {'scale_xyz': (1.0, 1.0, 0.5), 'cval': 0.25}):
    ref = np.array(j_warp.WarpCoordMap(coord_map_spec=cm_spec,
                                       **kw).decorate(in_ts))
    got = np.array(t_warp.WarpCoordMap(coord_map_spec=cm_spec, **kw,
                                       **CPU).decorate(in_ts))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


# -- affine --------------------------------------------------------------


def _section_stack(tmp_path, n_sec=3, n=72):
  """Fixed sections and moving ones, each moved by a growing affine
  (mov(M p) = fix(p)), as [x, y, z] stores."""
  from scipy import ndimage
  fixed, moving = [], []
  for z in range(n_sec):
    fix = _texture((n, n), seed=20 + z).T
    th = np.deg2rad(0.8 * (z + 1))
    m = np.array([[np.cos(th), -np.sin(th), 1.2 * (z + 1)],
                  [np.sin(th), np.cos(th), -0.9 * z], [0, 0, 1]])
    inv = np.linalg.inv(m)
    moving.append(ndimage.affine_transform(fix, inv[:2, :2], inv[:2, 2],
                                           order=1, mode='nearest'))
    fixed.append(fix)
  in_ts, _ = _store(tmp_path, np.stack(moving, -1).astype(np.float32),
                    ['x', 'y', 'z'], 'mov')
  _, fixed_spec = _store(tmp_path, np.stack(fixed, -1).astype(np.float32),
                         ['x', 'y', 'z'], 'fix')
  return in_ts, fixed_spec, fixed, moving


@pytest.mark.parametrize('motion, batch', [('affine', False),
                                           ('euclidean', True)])
def test_optim_affine_transform_sectionwise(tmp_path, motion, batch):
  in_ts, fixed_spec, _, _ = _section_stack(tmp_path)
  kw = dict(fixed_spec=fixed_spec, motion=motion, num_iters=40)
  if batch:
    kw.update(batch_dim='z', init_previous=True,
              transform_initial=[[1, 0, 0.5], [0, 1, 0]])
  ref = np.array(j_affine.OptimAffineTransformSectionwise(
      **kw).decorate(in_ts))
  view = t_affine.OptimAffineTransformSectionwise(**kw, **CPU).decorate(
      in_ts)
  assert view.domain.labels == ('r', 'c', 'z')
  assert view.dtype == ts.float64
  got = np.array(view)
  np.testing.assert_allclose(got, ref, atol=1e-3)


def test_affine_sections_chain_initial_transforms(tmp_path):
  _, _, fixed, moving = _section_stack(tmp_path)
  pairs = list(zip(fixed, moving))
  got = t_affine._optim_affine_sections(
      iter(pairs), [[1, 0, 0.5], [0, 1, 0]], True, num_iters=3,
      device='cpu')
  init = np.array([[1, 0, 0.5], [0, 1, 0]], np.float32)
  ref = []
  for fix, mov in pairs:
    _, m = j_reg.optim_transform(fix, mov, transform_initial=init,
                                 num_iters=3)
    init = np.asarray(m, np.float32)
    ref.append(m)
  np.testing.assert_allclose(got, np.stack(ref, -1), atol=1e-3)
  unchained = t_affine._optim_affine_sections(
      iter(pairs), None, False, num_iters=3, device='cpu')
  assert np.abs(unchained - got).max() > 1e-3  # the chain moved them


def test_sectionwise_needs_batch_dim_for_init_previous(tmp_path):
  with pytest.raises(ValueError, match='batch_dim'):
    t_affine.OptimAffineTransformSectionwise(fixed_spec={},
                                             init_previous=True)


@pytest.mark.parametrize('ndim', [2, 3])
def test_optim_translation_transform(tmp_path, ndim):
  shape = (40, 48) if ndim == 2 else (12, 20, 18)
  tex = _texture(shape, seed=30 + ndim)
  shift = (4, -6) if ndim == 2 else (2, -3, 5)
  moved = np.roll(tex, shift, tuple(range(ndim)))
  labels = ['x', 'y', 'b'] if ndim == 2 else ['x', 'y', 'z']
  to_store = (lambda a: a.T[:, :, None]) if ndim == 2 else (lambda a: a.T)
  in_ts, _ = _store(tmp_path, to_store(moved), labels, 'mov')
  _, fixed_spec = _store(tmp_path, to_store(tex), labels, 'fix')
  kw = dict(fixed_spec=fixed_spec, image_dims=tuple('xyz'[:ndim]))
  ref = np.array(j_affine.OptimTranslationTransform(**kw).decorate(in_ts))
  got = np.array(t_affine.OptimTranslationTransform(**kw, **CPU).decorate(
      in_ts))
  np.testing.assert_array_equal(got, ref)
  got = got.reshape(ndim, ndim + 1)
  np.testing.assert_array_equal(got[:, :ndim], np.eye(ndim))
  np.testing.assert_array_equal(got[:, ndim], -np.asarray(shift[::-1]))


# -- decorate_volume and WarpByMap ---------------------------------------


def test_decorate_volume_applies_specs_in_order(tmp_path):
  # CleanFlowFilter reads the source's chunk layout, which a zarr store
  # has and the array driver (an InMemoryVolume's adapter) has not.
  flow = _noisy_flow(z=2)
  store, _ = _store(tmp_path, flow, ['fc', 'fz', 'fy', 'fx'], 'f')
  args = dict(min_peak_ratio=1.6, min_peak_sharpness=1.6, max_magnitude=40,
              max_deviation=3)
  rec = dict(max_gradient=5.0, max_deviation=3.0, min_patch_size=4)
  outs = []
  for vol_mod, extra in ((j_vol, {}), (t_vol, CPU)):
    vol = vol_mod.TensorStoreVolume(store, pixel_size=(2.0, 2.0, 3.0))
    dec = vol_mod.decorate_volume(vol, [
        {'decorator': 'CleanFlowFilter', **args, **extra},
        ('ReconcileFlowFilter', dict(rec, **extra))])
    assert isinstance(dec, vol_mod.TensorStoreVolume)
    assert dec.meta.pixel_size == (2.0, 2.0, 3.0)
    assert dec.meta.num_channels == 2
    outs.append(dec[(slice(None), slice(0, 2), slice(0, 12),
                     slice(0, 14))])
    # An InMemoryVolume goes through the array driver.
    mem = vol_mod.decorate_volume(vol_mod.InMemoryVolume(flow[:2]),
                                  [('ReconcileFlowFilter', dict(rec,
                                                                **extra))])
    outs.append(mem[(slice(None), slice(0, 2), slice(0, 12), slice(0, 14))])
  _same_nan(outs[2], outs[0])
  _same_nan(outs[3], outs[1])
  assert not np.array_equal(np.isnan(outs[0]), np.isnan(outs[1]))


def _run_warp(mods, map_vol, data_vol, specs=None, data_specs=None):
  proc_mod, em, bbox, sub, kw = mods
  cfg = em.warp_config({'stride': 8.0, 'interpolation': 'linear'})
  cfg = dataclasses.replace(cfg, map_volinfo=map_vol, data_volinfo=data_vol,
                            map_decorator_specs=specs,
                            data_decorator_specs=data_specs)
  proc = proc_mod.WarpByMap(cfg, **kw)
  box = bbox.BoundingBox(start=(0, 0, 0), size=(48, 48, 1))
  return proc.process(sub.Subvolume(np.zeros((1, 1, 48, 48), np.float32),
                                    box))[0].data


J_MODS = (j_warp_proc, j_em, j_bbox, j_sub, {})
T_MODS = (t_warp_proc, t_em, t_bbox, t_sub, CPU)


def test_warp_by_map_with_map_decorator_specs(tmp_path):
  src = _texture((64, 64), seed=3)
  map_a = np.zeros((2, 1, 8, 8), np.float32)
  map_a[0] = 3.0
  map_b = np.zeros((2, 1, 8, 8), np.float32)
  map_b[1] = -2.0
  map_b[0, 0, 3:5, 2:6] = 1.5
  _, b_spec = _store(tmp_path, map_b, ['fc', 'fz', 'fy', 'fx'], 'map_b')
  a_store, _ = _store(tmp_path, map_a, ['fc', 'fz', 'fy', 'fx'], 'map_a')
  outs = []
  for mods, vol_mod, extra in ((J_MODS, j_vol, {}), (T_MODS, t_vol, CPU)):
    specs = [{'decorator': 'ComposeCoordMaps', 'coord_map_spec': b_spec,
              'stride1': 8.0, 'stride2': 8.0, **extra}]
    data_vol = vol_mod.InMemoryVolume(src[None, None], fill_value=0.0)
    out_dec = _run_warp(mods, vol_mod.TensorStoreVolume(a_store), data_vol,
                        specs=specs)
    out_plain = _run_warp(mods, vol_mod.InMemoryVolume(map_a), data_vol)
    assert not np.allclose(np.nan_to_num(out_dec), np.nan_to_num(out_plain))
    outs.append(out_dec)
  np.testing.assert_array_equal(np.isnan(outs[1]), np.isnan(outs[0]))
  np.testing.assert_allclose(np.nan_to_num(outs[1]), np.nan_to_num(outs[0]),
                             atol=1e-2)


def test_warp_by_map_with_data_decorator_specs():
  for base in (j_base, t_base):
    if 'DoubleFilterForTest' not in base.registered():
      @base.register
      class DoubleFilterForTest(base.Filter):

        def __init__(self, **kwargs):
          super().__init__(lambda a: a * 2.0, **kwargs)
  src = _texture((64, 64), seed=4)
  ident = np.zeros((2, 1, 8, 8), np.float32)
  ident[0, 0, 2:6, 3:5] = 0.75
  outs = []
  for mods, vol_mod in ((J_MODS, j_vol), (T_MODS, t_vol)):
    data_vol = vol_mod.InMemoryVolume(src[None, None], fill_value=0.0)
    plain = _run_warp(mods, vol_mod.InMemoryVolume(ident), data_vol)
    double = _run_warp(mods, vol_mod.InMemoryVolume(ident), data_vol,
                       data_specs=[{'decorator': 'DoubleFilterForTest'}])
    np.testing.assert_allclose(np.nan_to_num(double),
                               2.0 * np.nan_to_num(plain), atol=1e-3)
    outs.append(double)
  np.testing.assert_allclose(np.nan_to_num(outs[1]), np.nan_to_num(outs[0]),
                             atol=2e-2)


def test_chunks_raise_without_a_card(monkeypatch):
  # No CPU fallback: without device='cpu' (or jax_device='cpu') the chunk
  # functions place their inputs on the card, and raise without one.
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  tex = _texture((64, 64), seed=40).T.copy()
  flow = np.zeros((2, 1, 6, 7), np.float32)
  calls = [
      lambda: t_flow._optim_flow(tex, tex, (32, 32), (16, 16)),
      lambda: t_flow._mesh_relax_flow(flow, **dict(MESH_ARGS,
                                                   stride=(40, 40))),
      lambda: t_maps._compose_coord_maps(flow, flow, start1=(0, 0, 0),
                                         start2=(0, 0, 0), stride1=1.0,
                                         stride2=1.0),
      lambda: t_warp._warp_affine(tex, np.eye(2, 3)),
      lambda: t_affine._optim_translation(tex, tex),
      lambda: t_affine._optim_affine_sections([(tex, tex)], num_iters=1),
  ]
  for call in calls:
    with pytest.raises(RuntimeError, match='no CUDA device'):
      call()
  assert t_warp._warp_affine(tex, np.eye(2, 3), implementation='scipy',
                             order=1).shape == tex.shape
