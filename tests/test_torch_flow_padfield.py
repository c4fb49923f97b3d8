"""The calculator's padfield mode and the rectangular circular paths of
sofima_tpu_torch against sofima_tpu (CPU, plain versions).

The same numpy-seeded sections go through
sofima_tpu.flow_field.JAXMaskedXCorrWithStatsCalculator and the port's
twin of the same name (device='cpu'):
  * padfield mode (the default): unmasked; with masks and a ragged last
    dispatch batch (the batch decides the Padfield thresholds, so the
    batches must be the reference's); targeting fields on both sides;
    `post_patch_size` smaller than the patch (with the pre-patch clamp
    and its compensation at the border); `selection_mask` and
    `progress_fn` streaming; a 3d run;
  * circular modes with rectangular patches: the strip path (stride
    divides the patch) and the start-list path (it does not), both on
    kernel K6's plain version, unmasked and masked.
Tolerance: integer x/y peaks and NaN placement exact; sharpness and
ratio within rtol = atol = 3e-4 for at least 99% of the nodes and within
rtol 2e-3 for all. Sharpness divides by the correlation minimum near the
peak, and where that minimum is near 0 the reference's own float32 FFT
moves it: on test_padfield_unmasked's input one sharpness of -256.56 is
5.3e-4 (relative) from a float64 evaluation of the same chain in the
reference and 1.2e-5 in the port.
"""

import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu_torch import flow_field as tff

torch.set_num_threads(2)


def _texture(n, seed, m=None):
  m = m or n
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, m).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(m)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  tex = np.fft.irfft2(f, s=(n, m)).astype(np.float32)
  return (tex - tex.min()) / np.ptp(tex) * 255.0


def _pair(n=200, seed=0, shift=(3, -5), m=None):
  pre = _texture(n, seed, m)
  post = np.roll(pre, shift, (0, 1))
  return pre, post


def _same(got, ref):
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  np.testing.assert_array_equal(np.isnan(got[2:]), np.isnan(ref[2:]))
  fin = np.isfinite(ref[2:])
  d = np.abs(got[2:][fin] - ref[2:][fin])
  close = d <= 3e-4 + 3e-4 * np.abs(ref[2:][fin])
  assert close.mean() >= 0.99, close.mean()
  np.testing.assert_allclose(got[2:], ref[2:], rtol=2e-3, atol=3e-4)


def _both(pre, post, **kw):
  ref = jff.JAXMaskedXCorrWithStatsCalculator().flow_field(pre, post, **kw)
  got = tff.JAXMaskedXCorrWithStatsCalculator(device='cpu').flow_field(
      pre, post, **kw)
  return got, np.asarray(ref)


def test_padfield_unmasked():
  pre, post = _pair()
  got, ref = _both(pre, post, patch_size=40, step=20, batch_size=16)
  _same(got, ref)
  assert np.isfinite(got[0]).mean() > 0.9
  np.testing.assert_array_equal(np.nanmedian(got[:2], axis=(1, 2)), [5, -3])


def test_padfield_masks_ragged_batch():
  pre, post = _pair(seed=1)
  pre_mask = np.zeros(pre.shape, bool)
  post_mask = np.zeros(pre.shape, bool)
  pre_mask[60:95, 30:170] = True
  post_mask[:, 120:135] = True
  post_mask[150:, :40] = True
  # 81 nodes, some deselected, in batches of 7: the last batch is ragged.
  got, ref = _both(pre, post, patch_size=40, step=20, pre_mask=pre_mask,
                   post_mask=post_mask, batch_size=7)
  _same(got, ref)
  assert np.isnan(got[0]).any() and np.isfinite(got[0]).any()


def test_padfield_mask_only_for_selection_and_selection_mask():
  pre, post = _pair(seed=2)
  mask = np.zeros(pre.shape, bool)
  mask[:70, :70] = True
  sel = np.ones((9, 9), bool)
  sel[4, ::2] = False
  got, ref = _both(pre, post, patch_size=40, step=20, pre_mask=mask,
                   mask_only_for_patch_selection=True, selection_mask=sel,
                   batch_size=32)
  _same(got, ref)
  assert np.isnan(got[0, 4, ::2]).all()


def test_padfield_targeting_fields():
  pre, post = _pair(seed=3, shift=(9, -12))
  rng = np.random.RandomState(4)
  pre_field = np.zeros((2, 5, 5), np.float32)
  pre_field[0], pre_field[1] = -12.0, 9.0
  pre_field += rng.randint(-2, 3, size=pre_field.shape)
  pre_field[:, 2, 2] = np.nan
  post_field = rng.randint(-3, 4, size=(2, 4, 4)).astype(np.float32)
  got, ref = _both(pre, post, patch_size=48, step=20, batch_size=16,
                   pre_targeting_field=pre_field, pre_targeting_step=40,
                   post_targeting_field=post_field, post_targeting_step=50)
  _same(got, ref)


def test_padfield_post_patch_size_and_clamp():
  pre, post = _pair(seed=5, shift=(-4, 6))
  # Pre patches of 48 around post patches of 32: the border ones clamp
  # into the image and the flow compensates the clamp.
  got, ref = _both(pre, post, patch_size=48, step=16, post_patch_size=32,
                   batch_size=64)
  _same(got, ref)
  np.testing.assert_array_equal(np.nanmedian(got[:2], axis=(1, 2)), [-6, 4])


def test_padfield_progress_fn_streams_batches():
  pre, post = _pair(seed=6)
  seen = []

  def progress(items):
    for i in items:
      seen.append(i)
      yield i

  got, ref = _both(pre, post, patch_size=40, step=20, batch_size=20,
                   progress_fn=progress)
  _same(got, ref)
  # 81 nodes in 5 batches of 20, streamed once by each package.
  assert seen == [0, 1, 2, 3, 4] * 2


@pytest.mark.parametrize('patch,step', [((48, 24), (24, 12)),
                                        ((40, 24), (16, 16))])
def test_rectangular_circular(patch, step):
  pre, post = _pair(n=200, seed=7, shift=(4, -3), m=232)
  got, ref = _both(pre, post, patch_size=patch, step=step, batch_size=40,
                   mode='circular_dft')
  _same(got, ref)
  assert np.isfinite(got[0]).mean() > 0.9


def test_rectangular_circular_masked():
  pre, post = _pair(n=200, seed=8, shift=(2, 5))
  mask = np.zeros(pre.shape, bool)
  mask[40:80, 20:180] = True
  for patch, step in (((48, 24), (24, 12)), ((40, 24), (16, 16))):
    got, ref = _both(pre, post, patch_size=patch, step=step, pre_mask=mask,
                     post_mask=mask, batch_size=30, mode='circular')
    _same(got, ref)


def test_padfield_3d_raises():
  # Once a raise; the 3d padfield mode now computes the reference's flow
  # (in depth in test_torch_flow_padfield3d.py).
  pre = np.stack([_texture(40, seed=9 + z) for z in range(8)])
  post = np.roll(pre, (1, -2), (1, 2))
  got, ref = _both(pre, post, patch_size=8, step=8)
  assert got.shape == (5, 1, 5, 5)
  _same(got, ref)
