"""3d padfield flow and the non-circular dense flow of sofima_tpu_torch
against sofima_tpu (CPU, plain versions).

The same numpy-seeded volumes and sections go through sofima_tpu's
functions and the port's:
  * the calculator's padfield mode in 3d: masked with a ragged last
    dispatch batch, with a selection mask and masks only for patch
    selection, with targeting fields on both sides, with a smaller
    `post_patch_size`;
  * dense_flow_field(circular=False), the reference's default, in 2d
    and 3d, with and without `post_patch_size` (the pre patches are
    centred on the post patches, clamped at 0 and into the image
    without compensation), and a batch that does not divide the grid;
  * the circular start-list route in 3d (stride not dividing the patch),
    unmasked and masked;
  * the reference's two ValueErrors, and `bf16=True` (accepted, computed
    in float32);
  * stitch_elastic.compute_flow_map3d with `mask_map`, on the padfield
    mode (flow_mode='padfield', and the fallback of a stride that does
    not divide the patch) and on the circular strip path.
Tolerance: integer x/y/z peaks and NaN placement exact; sharpness and
ratio within rtol = atol = 3e-4 (FLOW_STAT_TOL) for at least 99% of the
nodes and within rtol 2e-3 for all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu import stitch_elastic as jse
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch import stitch_elastic as tse

torch.set_num_threads(2)
FLOW_STAT_TOL = 3e-4


def _texture(shape, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfftn(rng.rand(*shape).astype(np.float32),
                   axes=tuple(range(len(shape))))
  freqs = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]]
                      + [np.fft.rfftfreq(shape[-1])], indexing='ij')
  f *= np.exp(-sum(v ** 2 for v in freqs) / (2 * 0.08 ** 2))
  tex = np.fft.irfftn(f, s=shape,
                      axes=tuple(range(len(shape)))).astype(np.float32)
  return (tex - tex.min()) / np.ptp(tex) * 255.0


def _pair(shape, seed, shift):
  pre = _texture(shape, seed)
  return pre, np.roll(pre, shift, tuple(range(len(shape))))


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, ref):
  d = got.shape[0] - 2
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:d], nan=9e9),
                                np.nan_to_num(ref[:d], nan=9e9))
  np.testing.assert_array_equal(np.isnan(got[d:]), np.isnan(ref[d:]))
  fin = np.isfinite(ref[d:])
  diff = np.abs(got[d:][fin] - ref[d:][fin])
  close = diff <= FLOW_STAT_TOL + FLOW_STAT_TOL * np.abs(ref[d:][fin])
  assert close.mean() >= 0.99, close.mean()
  np.testing.assert_allclose(got[d:], ref[d:], rtol=2e-3, atol=FLOW_STAT_TOL)
  assert np.isfinite(got[:d]).any()


VOL = (28, 40, 44)


def _mask3d():
  m = np.zeros(VOL, bool)
  m[:, 12:24, :] = True
  m[5:9, :, 30:] = True
  return m


def _calculator_case(name):
  if name == 'masked':
    m = _mask3d()
    return dict(pre_mask=m, post_mask=np.roll(m, 3, 2), batch_size=7)
  if name == 'selected':
    sel = np.random.RandomState(0).rand(4, 5, 5) > 0.3
    return dict(pre_mask=_mask3d(), mask_only_for_patch_selection=True,
                selection_mask=sel, max_masked=0.5)
  if name == 'targeted':
    field = np.zeros((3, 4, 5, 5), np.float32)
    field[0], field[1], field[2] = 1.4, -2.0, 1.0
    field[:, 1, 2, 3] = np.nan
    return dict(pre_targeting_field=field, pre_targeting_step=8,
                post_targeting_field=-field,
                post_targeting_step=(8, 8, 8))
  return dict(post_patch_size=(8, 8, 8), batch_size=16)


@pytest.mark.parametrize('case', ['masked', 'selected', 'targeted',
                                  'post_patch_size'])
def test_calculator_3d_padfield(case):
  pre, post = _pair(VOL, 2, (1, 2, -1))
  kw = _calculator_case(case)
  ref = jff.JAXMaskedXCorrWithStatsCalculator().flow_field(
      pre, post, (12, 12, 12), (8, 8, 8), **kw)
  got = tff.JAXMaskedXCorrWithStatsCalculator(device='cpu').flow_field(
      pre, post, (12, 12, 12), (8, 8, 8), **kw)
  _same(got, np.asarray(ref))
  if case in ('masked', 'selected'):
    assert np.isnan(got[0]).any()  # deselected nodes


@pytest.mark.parametrize('dim, post_patch', [(2, None), (2, (24, 20)),
                                             (3, None), (3, (8, 8, 8))])
def test_dense_flow_field_linear(dim, post_patch):
  if dim == 2:
    pre, post = _pair((120, 100), 1, (3, -2))
    patch, step, batch = (32, 32), (12, 12), 7
  else:
    pre, post = _pair(VOL, 3, (1, -2, 2))
    patch, step, batch = (12, 12, 12), (8, 8, 8), 16
  kw = dict(batch_size=batch, post_patch_size=post_patch)
  ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                        patch, step, **kw))
  got = tff.dense_flow_field(_t(pre), _t(post), patch, step, **kw).numpy()
  _same(got, ref)


@pytest.mark.parametrize('masked', [False, True])
def test_dense_flow_field_3d_start_list(masked):
  pre, post = _pair(VOL, 4, (1, 2, -1))
  kw = dict(batch_size=16, circular=True)
  if masked:
    m = _mask3d()
    kw_j = dict(kw, pre_mask=jnp.asarray(m), post_mask=jnp.asarray(m))
    kw_t = dict(kw, pre_mask=_t(m), post_mask=_t(m))
  else:
    kw_j = kw_t = kw
  ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                        (12, 12, 12), (8, 8, 8), **kw_j))
  got = tff.dense_flow_field(_t(pre), _t(post), (12, 12, 12), (8, 8, 8),
                             **kw_t).numpy()
  _same(got, ref)


def test_dense_flow_field_value_errors():
  pre, post = _pair((64, 64), 5, (1, 1))
  m = np.zeros(pre.shape, bool)
  cases = [
      (dict(circular=True, post_patch_size=(16, 16)),
       'circular mode requires equal pre/post patch sizes'),
      (dict(pre_mask=m), 'dense masked mode requires circular=True'),
  ]
  for kw, msg in cases:
    with pytest.raises(ValueError, match=msg):
      jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post), (32, 32),
                           (16, 16), **{k: jnp.asarray(v) if k == 'pre_mask'
                                        else v for k, v in kw.items()})
    with pytest.raises(ValueError, match=msg):
      tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16),
                           **{k: _t(v) if k == 'pre_mask' else v
                              for k, v in kw.items()})


def test_dense_flow_field_bf16_accepted():
  pre, post = _pair((96, 96), 6, (2, -3))
  ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                        (32, 32), (16, 16), bf16=True))
  got = tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16),
                             bf16=True).numpy()
  plain = tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16)).numpy()
  np.testing.assert_array_equal(got, plain)
  _same(got, ref)


class _Tile:
  """[1, z, y, x] array-like, as compute_flow_map3d expects."""

  def __init__(self, data):
    self.data = data[None]
    self.shape = self.data.shape

  def __getitem__(self, sel):
    return self.data[sel]


@pytest.mark.parametrize('mode, stride', [('padfield', (8, 8, 8)),
                                          ('circular', (8, 8, 8)),
                                          ('circular', (8, 6, 6))])
def test_compute_flow_map3d_masks(mode, stride):
  vol = _texture((24, 48, 80), seed=3)
  t0, t1 = vol[:, :, :48].copy(), vol[:, :, 32:].copy()
  m0 = np.zeros(t0.shape, bool)
  m0[:, 10:20, 36:] = True
  m1 = np.zeros(t1.shape, bool)
  m1[8:12, :, :10] = True
  cx = np.full((3, 1, 1, 2), np.nan)
  cx[:, 0, 0, 0] = (-16, 0, 0)
  kw = dict(tile_shape=(48, 48, 24), offset_map=cx, axis=0,
            patch_size=(16, 16, 16), stride=stride, batch_size=8,
            flow_mode=mode)
  ref, ref_off = jse.compute_flow_map3d(
      {(0, 0): _Tile(t0), (1, 0): _Tile(t1)},
      mask_map={(0, 0): m0[None], (1, 0): m1[None]}, **kw)
  got, got_off = tse.compute_flow_map3d(
      {(0, 0): _Tile(_t(t0)), (1, 0): _Tile(_t(t1))},
      mask_map={(0, 0): _t(m0)[None], (1, 0): _t(m1)[None]}, **kw)
  assert got_off == ref_off
  _same(got[(0, 0)].numpy(), ref[(0, 0)])
