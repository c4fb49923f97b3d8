"""The volume foundation of sofima_tpu_torch against sofima_tpu (CPU).

Twins of the subvolume, config_utils, caching-volume, mask-config and
processor-cache cases of tests/test_foundation.py and
tests/test_caching_and_masks.py (its decorator-spec cases are twinned in
test_torch_decorators.py), `decorate_volume`'s spec forms, plus the
metrics registry, `open_volume` / `maybe_cache`, the
TensorStore volume (skipped where tensorstore is not installed) and the
exact EDT (`ops.edt`) against scipy. Each case runs the same seeded
inputs through both packages and holds the outputs equal: volumes,
masks, counters and configs exactly; EDT values exactly against
scipy.ndimage.distance_transform_edt, and within 1e-4 of the reference's
`edt` wherever the reference is exact (its native build; its jump
flooding fallback may differ on a few pixels).
"""

import dataclasses

import numpy as np
import pytest
from scipy import ndimage

from sofima_tpu.ops import edt as j_edt
from sofima_tpu.utils import config_utils as j_cfg
from sofima_tpu.utils import mask as j_mask
from sofima_tpu.utils import metrics as j_metrics
from sofima_tpu.utils import volume as j_vol
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu.utils.subvolume import Subvolume as JSub
from sofima_tpu_torch.ops import edt as t_edt
from sofima_tpu_torch.utils import config_utils as t_cfg
from sofima_tpu_torch.utils import mask as t_mask
from sofima_tpu_torch.utils import metrics as t_metrics
from sofima_tpu_torch.utils import volume as t_vol
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox
from sofima_tpu_torch.utils.subvolume import Subvolume as TSub

BOTH = ((JBox, JSub, j_vol, j_mask), (TBox, TSub, t_vol, t_mask))


# -- Subvolume -------------------------------------------------------------


def test_subvolume():
  for box, sub, _, _ in BOTH:
    sv = sub(np.zeros((2, 3, 4)), box(start=(0, 0, 0), size=(4, 3, 2)))
    assert sv.data.shape == (1, 2, 3, 4) and sv.num_channels == 1
    with pytest.raises(ValueError):
      sub(np.zeros((1, 2, 3, 4)), box(start=(0, 0, 0), size=(1, 1, 1)))
  data = np.arange(2 * 2 * 4 * 6).reshape(2, 2, 4, 6).astype(np.float32)
  outs = []
  for box, sub, _, _ in BOTH:
    sv = sub(data, box(start=(3, 1, 0), size=(6, 4, 2)))
    clipped = sv.clip(box(start=(4, 2, 0), size=(9, 2, 2)))
    parts = sv.split_channels()
    assert [p.data.shape for p in parts] == [(1, 2, 4, 6)] * 2
    outs.append(clipped)
  np.testing.assert_array_equal(outs[1].data, data[:, :, 1:3, 1:])
  np.testing.assert_array_equal(outs[1].data, outs[0].data)
  np.testing.assert_array_equal(outs[1].bbox.start, outs[0].bbox.start)
  np.testing.assert_array_equal(outs[1].bbox.size, outs[0].bbox.size)


# -- config_utils ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Inner:
  a: int = 1
  b: float = 2.0


@dataclasses.dataclass(frozen=True)
class Outer:
  name: str = 'x'
  inner: Inner = dataclasses.field(default_factory=Inner)


def test_config_utils():
  for cfg_mod in (j_cfg, t_cfg):
    cfg = Outer()
    new = cfg_mod.update_dataclass(cfg, {'inner': {'a': 5}})
    assert new.inner.a == 5 and new.inner.b == 2.0 and cfg.inner.a == 1
    with pytest.raises(KeyError):
      cfg_mod.update_dataclass(Outer(), {'bogus': 1})
    text = cfg_mod.to_json(Outer(name='y', inner=Inner(a=7)))
    assert cfg_mod.from_json(Outer, text) == Outer(name='y', inner=Inner(a=7))
  assert (t_cfg.to_json(Outer(name='y', inner=Inner(a=7)))
          == j_cfg.to_json(Outer(name='y', inner=Inner(a=7))))
  # Each package keeps its own registry.
  t_cfg.register_default_config('torch_test_flavor', Outer,
                                lambda: Outer(name='d'))
  cfg = t_cfg.default_config('torch_test_flavor', Outer,
                             overrides={'inner': {'b': 9.0}})
  assert cfg.name == 'd' and cfg.inner.b == 9.0
  assert ('torch_test_flavor', Outer) not in j_cfg.registered_config_types()


def test_config_utils_enums_and_nested_processor_configs():
  from sofima_tpu.processor import mesh as j_mesh
  from sofima_tpu.processor.defaults import em_2d as j_em
  from sofima_tpu_torch.processor import mesh as t_mesh
  from sofima_tpu_torch.processor.defaults import em_2d as t_em
  over = {'integration_config': {'k0': 0.5, 'stride': (20, 20)},
          'options': {'init_state': 1}}
  got = t_em.relax_mesh_config(over)
  ref = j_em.relax_mesh_config(over)
  assert got.options.init_state == t_mesh.MeshInitState.PREV_MEDIAN
  assert ref.options.init_state == j_mesh.MeshInitState.PREV_MEDIAN
  assert t_cfg.to_json(got) == j_cfg.to_json(ref)
  back = t_cfg.from_json(t_em.warp.WarpByMap.Config,
                         t_cfg.to_json(t_em.warp_config()))
  assert back == t_em.warp_config()


# -- metrics ---------------------------------------------------------------


def test_metrics_registry():
  for mod in (j_metrics, t_metrics):
    reg = mod.registry()
    before = reg.get_counter('torch-test', 'items')
    mod.counter('torch-test', 'items').inc(3)
    with mod.timer_counter('torch-test', 'work'):
      pass
    assert reg.get_counter('torch-test', 'items') == before + 3
    assert reg.get_counter('torch-test', 'work-calls') >= 1
    snap = reg.snapshot()
    assert snap['counters']['torch-test/items'] == before + 3
    other = mod._Registry()
    other.merge(snap)
    assert other.get_counter('torch-test', 'items') == before + 3
    other.reset()
    assert other.snapshot() == {'counters': {}, 'timings_s': {}}
  with t_metrics.trace('torch-test-span'):
    pass
  assert t_metrics.registry().get_counter('trace', 'torch-test-span-calls')
  assert j_metrics.registry().get_counter('torch-test', 'items') == (
      t_metrics.registry().get_counter('torch-test', 'items'))


# -- volumes ---------------------------------------------------------------


def test_in_memory_volume_out_of_bounds_reads_and_writes():
  rng = np.random.RandomState(0)
  data = rng.rand(2, 3, 7, 9).astype(np.float32)
  outs = []
  for box, _, vol_mod, _ in BOTH:
    vol = vol_mod.InMemoryVolume(data.copy(), pixel_size=(2, 2, 5))
    assert vol.meta.volume_size == (9, 7, 3)
    assert vol.meta.num_channels == 2
    read = vol[(slice(None), slice(-1, 2), slice(5, 10), slice(-2, 4))]
    vol.write(np.full((2, 2, 4, 4), 7.0, np.float32),
              box(start=(7, 5, 2), size=(4, 4, 2)))
    clipped = vol.clip_box_to_volume(box(start=(-3, 2, 1), size=(20, 2, 9)))
    outs.append((read, vol.data.copy(), clipped,
                 vol.read_box(box(start=(0, 0, 0), size=(9, 7, 3)))))
  (jr, jd, jc, jb), (tr, td, tc, tb) = outs
  np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
  np.testing.assert_array_equal(np.nan_to_num(tr), np.nan_to_num(jr))
  np.testing.assert_array_equal(td, jd)
  np.testing.assert_array_equal(tb, jb)
  np.testing.assert_array_equal(tc.start, jc.start)
  np.testing.assert_array_equal(tc.size, jc.size)
  ints = t_vol.InMemoryVolume(np.ones((1, 1, 2, 2), np.uint8))
  assert ints[(slice(None), slice(0, 1), slice(0, 3), slice(0, 3))][
      0, 0, 2, 2] == 0


def test_caching_volume():
  data = np.arange(64, dtype=np.float32).reshape(1, 1, 8, 8)
  row_bytes = 8 * 4
  rows = [(slice(None), slice(0, 1), slice(i, i + 1), slice(0, 8))
          for i in range(3)]
  stats = []
  for box, _, vol_mod, _ in BOTH:
    vol = vol_mod.CachingVolume(vol_mod.InMemoryVolume(data.copy()),
                                cache_bytes=1 << 20, namespace='torch-test')
    sel = (slice(None), slice(0, 1), slice(0, 4), slice(0, 4))
    np.testing.assert_array_equal(vol[sel], vol[sel])
    vol[(slice(None), slice(0, 1), slice(4, 8), slice(0, 4))]
    lru = vol_mod.CachingVolume(vol_mod.InMemoryVolume(data.copy()),
                                cache_bytes=2 * row_bytes)
    for i in (0, 1, 2, 0):
      lru[rows[i]]
    lru_stats = (lru.hits, lru.misses)
    lru[rows[2]]
    vol.write(np.ones((1, 1, 4, 4), np.float32),
              box(start=(0, 0, 0), size=(4, 4, 1)))
    np.testing.assert_array_equal(vol[sel], 1.0)
    assert not isinstance(vol_mod.maybe_cache(
        vol_mod.InMemoryVolume(data.copy()), 0), vol_mod.CachingVolume)
    assert isinstance(vol_mod.maybe_cache(
        vol_mod.InMemoryVolume(data.copy()), 10), vol_mod.CachingVolume)
    stats.append((vol.hits, vol.misses, lru_stats, lru.hits))
  assert stats[1] == stats[0] == (1, 3, (0, 4), 1)
  assert t_metrics.registry().get_counter('torch-test', 'hits') >= 1


def test_open_volume():
  data = np.zeros((1, 1, 4, 4), np.float32)
  vol = t_vol.open_volume(data)
  assert isinstance(vol, t_vol.InMemoryVolume)
  assert t_vol.open_volume(vol) is vol
  assert t_vol.InMemoryVolume(data).asarray is not None


def test_decorate_volume_needs_the_decorators():
  """Dict and tuple specs apply in order, None and [] return the volume
  itself, and an unknown name raises KeyError, as in the reference."""
  pytest.importorskip('tensorstore')
  data = 3 * np.random.RandomState(2).rand(2, 2, 5, 6).astype(np.float32)
  outs = []
  for _, _, vol_mod, _ in BOTH:
    vol = vol_mod.InMemoryVolume(data, pixel_size=(4.0, 4.0, 30.0))
    assert vol_mod.decorate_volume(vol, None) is vol
    assert vol_mod.decorate_volume(vol, []) is vol
    with pytest.raises(KeyError, match='ClipValues'):
      vol_mod.decorate_volume(vol, [{'decorator': 'ClipValues', 'lo': 0}])
    # Two filters that do not commute: the order shows in the result.
    dev = {'device': 'cpu'} if vol_mod is t_vol else {}
    grad = dict(max_gradient=1.5, max_deviation=0, min_patch_size=0, **dev)
    small = dict(max_gradient=0, max_deviation=0, min_patch_size=4, **dev)
    box = (slice(None), slice(0, 2), slice(0, 5), slice(0, 6))
    dec = vol_mod.decorate_volume(vol, [
        ('ReconcileFlowFilter', grad),
        {'decorator': 'ReconcileFlowFilter', **small}])
    assert dec.meta.pixel_size == (4.0, 4.0, 30.0)
    back = vol_mod.decorate_volume(vol, [
        {'decorator': 'ReconcileFlowFilter', **small},
        ('ReconcileFlowFilter', grad)])
    outs.append((dec[box], back[box]))
  for got, ref in zip(outs[1], outs[0]):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(ref))
  assert not np.array_equal(np.isnan(outs[1][0]), np.isnan(outs[1][1]))


def test_tensorstore_volume(tmp_path):
  pytest.importorskip('tensorstore')
  rng = np.random.RandomState(1)
  data = rng.rand(1, 2, 6, 10).astype(np.float32)
  outs = []
  for i, (box, _, vol_mod, _) in enumerate(BOTH):
    path = str(tmp_path / f'vol{i}')
    vol = vol_mod.TensorStoreVolume.create(path, data.shape, np.float32,
                                           chunk_size=(1, 1, 4, 4))
    vol.write(data, box(start=(0, 0, 0), size=(10, 6, 2)))
    back = vol_mod.TensorStoreVolume.open(path)
    assert back.meta.volume_size == (10, 6, 2)
    outs.append(back[(slice(None), slice(0, 2), slice(1, 5), slice(2, 9))])
    opened = vol_mod.open_volume(path)
    assert isinstance(opened, vol_mod.TensorStoreVolume)
  np.testing.assert_array_equal(outs[1], data[:, :, 1:5, 2:9])
  np.testing.assert_array_equal(outs[1], outs[0])


# -- masks -----------------------------------------------------------------


def _mask_vol(vol_mod):
  m = np.zeros((1, 1, 8, 8), np.float32)
  m[0, 0, :4] = 200.0
  m[0, 0, 6, 2:5] = 90.0
  return vol_mod.InMemoryVolume(m, fill_value=0.0)


@pytest.mark.parametrize('case', ['threshold', 'invert_values', 'band',
                                  'combine_and', 'combine_xor',
                                  'parse_dicts', 'config_invert'])
def test_mask_configs(case):
  outs = []
  for box_cls, _, vol_mod, mask_mod in BOTH:
    box = box_cls(start=(0, 0, 0), size=(8, 8, 1))
    vol = _mask_vol(vol_mod)
    if case == 'threshold':
      cfg = mask_mod.MaskConfig(
          volume=vol, channels=[mask_mod.MaskChannelConfig(min_value=128)])
    elif case == 'invert_values':
      cfg = mask_mod.MaskConfig(volume=vol, channels=[
          mask_mod.MaskChannelConfig(values=[200], invert=True)])
    elif case == 'band':
      cfg = mask_mod.MaskConfig(volume=vol, channels=[
          mask_mod.MaskChannelConfig(min_value=50, max_value=100)])
    elif case in ('combine_and', 'combine_xor'):
      a = np.zeros((1, 1, 8, 8), np.float32)
      a[0, 0, :, :4] = 1.0
      cfg = mask_mod.MaskConfigs(masks=[
          mask_mod.MaskConfig(volume=vol_mod.InMemoryVolume(a,
                                                            fill_value=0)),
          mask_mod.MaskConfig(volume=vol)], combine=case[8:])
    elif case == 'parse_dicts':
      cfg = mask_mod.parse({'masks': [{'volume': vol,
                                       'channels': [{'min_value': 128.0}]}],
                            'combine': 'or'})
    else:
      cfg = mask_mod.parse([{'volume': vol, 'invert': True}])
    outs.append(mask_mod.build_mask(cfg, box))
  assert outs[1].shape == (1, 8, 8) and outs[1].dtype == bool
  np.testing.assert_array_equal(outs[1], outs[0])
  if case == 'threshold':
    assert outs[1][0, :4].all() and not outs[1][0, 4:].any()
  if case == 'invert_values':
    assert not outs[1][0, :4].any() and outs[1][0, 4:].all()


def test_processor_build_mask_opener():
  """`SubvolumeProcessor._build_mask` reads a raw boolean source as-is and
  opens structured configs' volumes through `_open_volume`."""
  from sofima_tpu_torch.processor import base
  opened = []

  class Proc(base.SubvolumeProcessor):

    def _open_volume(self, spec):
      opened.append(spec)
      return t_vol.open_volume(spec)

  raw = np.zeros((1, 1, 8, 8), bool)
  raw[0, 0, 2:5, 3] = True
  box = TBox(start=(0, 0, 0), size=(8, 8, 1))
  np.testing.assert_array_equal(Proc()._build_mask(raw, box), raw[0])
  src = np.zeros((1, 1, 8, 8), np.float32)
  src[0, 0, 5:] = 255.0
  got = Proc()._build_mask(t_mask.MaskConfig(volume=src), box)
  assert opened and opened[0] is src
  assert got[0, 5:].all() and not got[0, :5].any()


def test_estimate_flow_with_thresholded_mask_volume():
  from sofima_tpu.processor import flow as j_flow
  from sofima_tpu.processor import runner as j_runner
  from sofima_tpu.processor.defaults import em_2d as j_em
  from sofima_tpu_torch.processor import flow as t_flow
  from sofima_tpu_torch.processor import runner as t_runner
  from sofima_tpu_torch.processor.defaults import em_2d as t_em
  rng = np.random.RandomState(0)
  f = np.fft.rfft2(rng.rand(240, 240).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(240)[None] ** 2
                 + np.fft.fftfreq(240)[:, None] ** 2) / (2 * 0.1 ** 2)))
  tex = np.fft.irfft2(f, s=(240, 240)).astype(np.float32) * 1000
  stack = np.stack([np.roll(tex, 2 * z, axis=1) for z in range(2)])
  raw_mask = np.zeros((1, 2, 240, 240), np.float32)
  raw_mask[0, :, :120] = 255.0
  outs = []
  for (_, _, vol_mod, mask_mod), flow, runner, em, kw in (
      (BOTH[0], j_flow, j_runner, j_em, {}),
      (BOTH[1], t_flow, t_runner, t_em, {'device': 'cpu'})):
    mask_cfg = mask_mod.MaskConfig(
        volume=vol_mod.InMemoryVolume(raw_mask, fill_value=0.0),
        channels=[mask_mod.MaskChannelConfig(min_value=128)])
    cfg = em.estimate_flow_config({'patch_size': 80, 'stride': 40,
                                   'batch_size': 16})
    cfg = dataclasses.replace(cfg, mask_configs=mask_cfg,
                              mask_only_for_patch_selection=True)
    vol = vol_mod.InMemoryVolume(stack[np.newaxis], fill_value=0.0)
    outs.append(runner.process_volume(flow.EstimateFlow(cfg, **kw), vol,
                                      subvolume_size=(240, 240, 2)).data)
  ref, data = outs
  assert np.isnan(data[0, 1, 1, 1:]).all()
  assert np.isnan(data[0, 1, 2, 1:]).all()
  assert np.isfinite(data[0, 1, -2]).any()
  assert np.isfinite(data[0, 1, -1]).any()
  np.testing.assert_array_equal(np.nan_to_num(data[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  fin = np.isfinite(ref[2:])
  np.testing.assert_array_equal(np.isfinite(data[2:]), fin)
  d = np.abs(data[2:] - ref[2:])[fin]
  assert np.mean(d <= 3e-4 + 3e-4 * np.abs(ref[2:][fin])) >= 0.99


def test_estimate_missing_flow_image_cache():
  from sofima_tpu_torch.processor import flow as t_flow
  from sofima_tpu_torch.processor.defaults import em_2d as t_em
  rng = np.random.RandomState(2)
  tex = rng.rand(200, 200).astype(np.float32)
  tex = ndimage.gaussian_filter(tex, 2.0) * 2550
  stack = np.stack([tex, np.roll(tex, 3, axis=1), np.full_like(tex, 128.0),
                    np.roll(tex, 3, axis=1)])
  cfg = t_em.estimate_missing_flow_config({
      'patch_size': 80, 'stride': 40, 'batch_size': 16, 'max_delta_z': 3})
  cfg = dataclasses.replace(
      cfg, image_volinfo=t_vol.InMemoryVolume(stack[np.newaxis],
                                              fill_value=0.0),
      image_cache_bytes=1 << 24)
  proc = t_flow.EstimateMissingFlow(cfg, device='cpu')
  flow_in = np.full((2, 1, 5, 5), np.nan, np.float32)
  reg = t_metrics.registry()
  before = reg.get_counter('EstimateMissingFlow_image', 'hits')
  out1 = proc.process(TSub(flow_in.copy(), TBox(start=(0, 0, 3),
                                                size=(5, 5, 1))))
  out2 = proc.process(TSub(flow_in.copy(), TBox(start=(0, 0, 3),
                                                size=(5, 5, 1))))
  assert reg.get_counter('EstimateMissingFlow_image', 'hits') > before
  np.testing.assert_array_equal(out1.data, out2.data)
  assert np.isfinite(out1.data[0, 0]).any()


# -- edt -------------------------------------------------------------------


def _edt_masks():
  rng = np.random.RandomState(5)
  blobs = ndimage.gaussian_filter(rng.rand(37, 53), 2.5) > 0.5
  ring = np.ones((24, 31), bool)
  ring[10:14, 12:20] = False
  margin = np.zeros((40, 40), np.uint8)
  margin[5:-5, 3:-9] = 1
  return {'blobs': blobs, 'ring': ring, 'margin': margin,
          'full': np.ones((9, 13), bool), 'empty': np.zeros((7, 5), bool)}


@pytest.mark.parametrize('black_border', [True, False])
@pytest.mark.parametrize('name', ['blobs', 'ring', 'margin', 'full', 'empty'])
def test_edt_exact(name, black_border):
  mask = _edt_masks()[name]
  got = t_edt.edt(mask, black_border=black_border)
  assert got.dtype == np.float32 and got.shape == mask.shape
  inside = mask != 0
  if black_border:
    want = ndimage.distance_transform_edt(np.pad(inside, 1))[1:-1, 1:-1]
  elif inside.all():
    want = np.full(mask.shape, np.inf)
  else:
    want = ndimage.distance_transform_edt(inside)
  np.testing.assert_array_equal(got, want.astype(np.float32))
  assert (got[~inside] == 0).all()
  ref = j_edt.edt(mask, black_border=black_border)
  close = np.isclose(got, ref, atol=1e-4) | (np.isinf(got) & np.isinf(ref))
  assert close.mean() >= 0.99, close.mean()


def test_stitch_blend_weights_use_the_exact_edt():
  from sofima_tpu_torch.processor import warp as t_warp
  proc = t_warp.StitchAndRender3dTiles(
      tile_map=[[0, 1, 2], [3, 4, 5]], tile_mesh_path='', stride=(4, 8, 8),
      margin=3, device='cpu')
  w = proc._blend_weights((4, 20, 30), 1, 0)
  mask = np.zeros((20, 30), bool)
  mask[0:-3, 3:-3] = True
  np.testing.assert_array_equal(w, t_edt.edt(mask, black_border=True))
