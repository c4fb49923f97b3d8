"""Masked flow of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

Same numpy-seeded inputs through the JAX function (Pallas kernels in
interpret mode, as the JAX tests run them) and the port:
  * K5's plain version (ops.cuda_flow.masked_dense_flow_peaks) against
    pallas_flow.dense_flow_peaks_pallas(pre_valid, post_valid) on the
    520^2 case of tests/test_flow_field.py, and against the XLA strip
    path with the whole grid in one batch;
  * its dead / pure / impure branches, the wrapper's split of the grid
    into those three lists (each list through the plain version,
    reassembled, equal to the one-pass plain version), and the per-patch
    denominator tolerance beside the grid kernel's per-subgroup one;
  * 3d masked strips against flow_field._dense_flow_strips_3d;
  * the calculator's dense masked branch against
    JAXMaskedXCorrWithStatsCalculator(mode='circular_dft');
  * masked coarse_to_fine_flow against the reference (bf16 off), and the
    all-valid-mask transport against the port's unmasked targeted path.
Tolerances: integer peaks and NaN placement exact. Sharpness and ratio
divide by correlation values that sit near 0 close to masked regions,
so against the grid kernel (another mean, tolerance and purity
granularity) they are compared through the clean_flow gates they feed
and a 1% bulk bar (the JAX test's own); against the strip path, where
the arithmetic is the same up to summation order, within 2e-3
(measured 6.2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu.ops import pallas_flow
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch.ops import cuda_flow

torch.set_num_threads(2)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _texture(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  tex = np.fft.irfft2(f, s=(n, n)).astype(np.float32)
  return (tex - tex.min()) / np.ptp(tex) * 255.0


def _xy_equal(got, ref):
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))


def _gates_equal(got, ref):
  for ch in (2, 3):
    np.testing.assert_array_equal(np.nan_to_num(np.abs(got[ch])) >= 1.6,
                                  np.nan_to_num(np.abs(ref[ch])) >= 1.6)


@pytest.fixture(scope='module')
def case520():
  """tests/test_flow_field.py's masked grid case and both JAX results."""
  rng = np.random.RandomState(0)
  n = 520
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  pre = (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)
  post = np.roll(pre, (3, -5), (0, 1)).copy()
  post[:140, :140] = rng.rand(140, 140) * 255  # corrupted corner
  pre_mask = np.zeros((n, n), bool)
  pre_mask[400:, :] = True
  post_mask = np.zeros((n, n), bool)
  post_mask[:140, :140] = True
  grid = np.asarray(pallas_flow.dense_flow_peaks_pallas(
      jnp.asarray(pre), jnp.asarray(post), (160, 160), (40, 40),
      pre_valid=jnp.asarray(~pre_mask, np.float32),
      post_valid=jnp.asarray(~post_mask, np.float32), interpret=True))
  strip = np.asarray(jff._dense_flow_strips(
      jnp.asarray(pre), jnp.asarray(post), (160, 160), (40, 40), None, 2,
      0.5, 5, rows_per_step=10, dft_matmul=True, use_pallas=False,
      pre_mask=jnp.asarray(pre_mask), post_mask=jnp.asarray(post_mask)))
  got = cuda_flow.masked_dense_flow_peaks(
      _t(pre), _t(post), _t(~pre_mask), _t(~post_mask), (160, 160),
      (40, 40)).numpy()
  return dict(grid=grid, strip=strip, got=got)


class TestMaskedDenseFlowPeaks:
  """K5's plain version (the kernel's CPU path)."""

  def test_matches_pallas_grid_kernel(self, case520):
    got, ref = case520['got'], case520['grid']
    assert got.shape == ref.shape == (4, 10, 10)
    _xy_equal(got, ref)
    _gates_equal(got, ref)
    fin = np.isfinite(ref[2]) & np.isfinite(got[2])
    close = np.abs(got[2][fin] - ref[2][fin]) / (np.abs(ref[2][fin]) + 1)
    assert (close < 0.01).mean() > 0.9

  def test_matches_strip_path(self, case520):
    got, ref = case520['got'], case520['strip']
    _xy_equal(got, ref)
    np.testing.assert_allclose(got[2:], ref[2:], rtol=2e-3, atol=2e-3,
                               equal_nan=True)

  def test_dead_pure_and_impure_patches(self):
    n = 360
    pre = _texture(n, 1)
    post = np.roll(pre, (4, -3), (0, 1))
    pre_mask = np.zeros((n, n), bool)
    pre_mask[:130, :130] = True          # dead patches in the corner
    post_mask = np.zeros((n, n), bool)
    post_mask[200:230, 150:330] = True   # a crack band: impure patches
    va, vb = _t(~pre_mask), _t(~post_mask)
    cls = cuda_flow.masked_patch_classes(va, vb, 80, (40, 40)).numpy()
    assert set(np.unique(cls)) == {0, 1, 2}
    got = cuda_flow.masked_dense_flow_peaks(_t(pre), _t(post), va, vb,
                                            (80, 80), (40, 40)).numpy()
    ref = np.asarray(jff._dense_flow_strips(
        jnp.asarray(pre), jnp.asarray(post), (80, 80), (40, 40), None, 2,
        0.5, 5, rows_per_step=8, dft_matmul=True, use_pallas=False,
        pre_mask=jnp.asarray(pre_mask), post_mask=jnp.asarray(post_mask)))
    _xy_equal(got, ref)
    np.testing.assert_allclose(got[2:], ref[2:], rtol=2e-3, atol=2e-3,
                               equal_nan=True)
    assert np.isnan(got[:, cls == 2]).all()
    assert np.isfinite(got[:2, cls == 1]).all()
    assert (got[0, cls == 1] == 3).all() and (got[1, cls == 1] == -4).all()

  def test_per_patch_tolerance(self):
    # A near-flat block (the texture at 1e-5 of its amplitude) beside
    # textured ones. The grid kernel shares the denominator tolerance
    # 1e3 eps max|denom| across a subgroup of patches, so a flat patch
    # next to a textured one is zeroed to a NaN row; the per-patch rule
    # measures it like any other. mean=0 keeps the flat patches
    # well-conditioned under both kernels' mean handling.
    n = 360
    base = _texture(n, 5)
    flat = np.zeros((n, n), bool)
    flat[120:280, 120:280] = True
    pre = np.where(flat, base * 1e-5, base).astype(np.float32)
    post = np.roll(pre, (3, -2), (0, 1))
    mask = np.zeros((n, n), bool)
    mask[250:260, 130:140] = True  # makes flat patch (5, 3) impure
    mask[300:, :] = True
    ref = np.asarray(pallas_flow.dense_flow_peaks_pallas(
        jnp.asarray(pre), jnp.asarray(post), (80, 80), (40, 40), mean=0.0,
        pre_valid=jnp.asarray(~mask, np.float32),
        post_valid=jnp.asarray(~mask, np.float32), interpret=True))
    got = cuda_flow.masked_dense_flow_peaks(
        _t(pre), _t(post), _t(~mask), _t(~mask), (80, 80), (40, 40),
        mean=0.0).numpy()
    cls = cuda_flow.masked_patch_classes(_t(~mask), _t(~mask), 80,
                                         (40, 40)).numpy()
    # Patches flat in both images, and patches touching neither block.
    y0 = np.arange(8)[:, None] * 40
    x0 = np.arange(8)[None, :] * 40
    in_flat = ((y0 >= 123) & (y0 + 80 <= 280)
               & (x0 >= 120) & (x0 + 80 <= 278))
    apart = ((y0 + 80 <= 120) | (y0 >= 283) | (x0 + 80 <= 118)
             | (x0 >= 280))
    assert in_flat.sum() == 4 and set(cls[in_flat]) == {0, 1}
    # The per-patch rule finds the true shift there; the subgroup rule
    # leaves no peak.
    assert (got[0][in_flat] == 2).all() and (got[1][in_flat] == -3).all()
    assert np.isnan(ref[0][in_flat]).all()
    _xy_equal(got[:, apart], ref[:, apart])


  @pytest.mark.parametrize('mean', [None, 7.0])
  def test_three_lists_match_plain(self, mean):
    # The wrapper splits the grid into dead, pure and impure lists and
    # reassembles the rows (on the card: NaN rows, the FFT route and the
    # dense route); on the CPU each list runs through the plain version.
    # Together they equal the one-pass plain version.
    n = 160
    pre = _texture(n, 2)
    post = np.roll(pre, (2, -3), (0, 1))
    pre_valid = np.ones((n, n), bool)
    pre_valid[:48, :48] = False         # dead patches in the corner
    pre_valid[100:103, :] = False       # a crack: impure patches
    post_valid = np.ones((n, n), bool)
    post_valid[120:, 120:] = False
    va, vb = _t(pre_valid), _t(post_valid)
    cls = cuda_flow.masked_patch_classes(va, vb, 32, (16, 16)).numpy()
    assert set(np.unique(cls)) == {0, 1, 2}
    got = cuda_flow.masked_dense_flow_peaks(_t(pre), _t(post), va, vb,
                                            (32, 32), (16, 16),
                                            mean=mean).numpy()
    ref = cuda_flow.masked_flow_peaks_plain(
        _t(pre), _t(post), va.float(), vb.float(), cls.shape, 32, (16, 16),
        mean, 2, 0.5, 5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[:, cls == 2]).all()
    assert np.isfinite(got[:2, cls == 1]).all()


class TestMaskedStrips3d:

  def test_matches_reference(self):
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(0)
    vol = gaussian_filter(rng.rand(40, 120, 160).astype(np.float32), 1.5)
    vol = (vol - vol.min()) / np.ptp(vol) * 255
    post = np.roll(vol, (2, -3, 4), (0, 1, 2))
    pre_mask = np.zeros(vol.shape, bool)
    pre_mask[:, 30:50, :] = True
    post_mask = np.zeros(vol.shape, bool)
    post_mask[10:, :, 100:] = True
    patch, step = (20, 40, 40), (10, 20, 20)
    ref = np.asarray(jff._dense_flow_strips_3d(
        jnp.asarray(vol), jnp.asarray(post), patch, step, None, 2, 0.5, 5,
        pre_mask=jnp.asarray(pre_mask), post_mask=jnp.asarray(post_mask)))
    got = tff.dense_flow_field(_t(vol), _t(post), patch, step,
                               circular=True, pre_mask=_t(pre_mask),
                               post_mask=_t(post_mask)).numpy()
    assert got.shape == ref.shape == (5, 3, 5, 7)
    np.testing.assert_array_equal(np.nan_to_num(got[:3], nan=9e9),
                                  np.nan_to_num(ref[:3], nan=9e9))
    np.testing.assert_allclose(got[3:], ref[3:], rtol=1e-4, atol=1e-4,
                               equal_nan=True)
    assert np.isfinite(got[0]).any() and np.isnan(got[0]).any()


class TestCalculator:

  @pytest.mark.parametrize('selection_only', [False, True])
  def test_dense_masked_branch(self, selection_only):
    n = 360
    pre = _texture(n, 7)
    post = np.roll(pre, (-2, 5), (0, 1))
    pre_mask = np.zeros((n, n), bool)
    pre_mask[:, 100:190] = True     # whole patches >= 75% masked
    post_mask = np.zeros((n, n), bool)
    post_mask[250:290, 40:200] = True
    selection = np.ones((6, 6), bool)
    selection[0, 5] = False
    kw = dict(patch_size=160, step=40, pre_mask=pre_mask,
              post_mask=post_mask, selection_mask=selection,
              mask_only_for_patch_selection=selection_only,
              max_masked=0.5, mode='circular_dft')
    ref = jff.JAXMaskedXCorrWithStatsCalculator().flow_field(pre, post, **kw)
    got = tff.JAXMaskedXCorrWithStatsCalculator(device='cpu').flow_field(
        pre, post, **kw)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape == (4, 6, 6)
    _xy_equal(got, ref)
    np.testing.assert_allclose(got[2:], ref[2:], rtol=2e-3, atol=2e-3,
                               equal_nan=True)
    assert np.isnan(got[0, 0, 5]) and np.isnan(got[0, :, 2]).all()
    assert np.isfinite(got[0]).sum() > 12


class TestMaskedCoarseToFine:

  def test_matches_reference(self):
    n = 800
    pre = _texture(n, 3)
    post = np.roll(pre, (23, -31), (0, 1))
    yy, xx = np.mgrid[:n, :n]
    # bench.py's mask shape at this size: a diagonal crack band and a
    # blob, ~17% invalid.
    mask = (((yy + xx) % 700 < 80)
            | (((yy - 300) ** 2 + (xx - 500) ** 2) < 120 ** 2))
    ref, ref_ov = jff.coarse_to_fine_flow(
        jnp.asarray(pre), jnp.asarray(post), bf16=False,
        pre_mask=jnp.asarray(mask), post_mask=jnp.asarray(mask),
        return_overflow=True)
    got, got_ov = tff.coarse_to_fine_flow(
        _t(pre), _t(post), pre_mask=_t(mask), post_mask=_t(mask),
        return_overflow=True)
    ref = np.asarray(ref)
    got = got.numpy()
    assert bool(got_ov) == bool(ref_ov) is False
    assert got.shape == ref.shape == (4, 17, 17)
    _xy_equal(got, ref)
    _gates_equal(got, ref)
    assert 0.5 < np.isfinite(got[0]).mean() < 1.0

  def test_all_valid_mask_transport_matches_targeted(self):
    # tests/test_shift_warp.py's bars: the integer transport of an
    # all-valid mask agrees with the unmasked targeted path at >= 95% of
    # the interior nodes exactly, and never by more than 1 px.
    n = 800
    pre = _texture(n, 3)
    post = np.roll(pre, (23, -31), (0, 1))
    none = torch.zeros(n, n, dtype=torch.bool)
    masked = tff.coarse_to_fine_flow(_t(pre), _t(post), pre_mask=none,
                                     post_mask=none).numpy()
    unmasked = tff.coarse_to_fine_flow(_t(pre), _t(post)).numpy()
    sl = np.s_[2:-2, 2:-2]
    dx = np.abs(masked[0][sl] - unmasked[0][sl])
    dy = np.abs(masked[1][sl] - unmasked[1][sl])
    assert np.nanmean((dx == 0) & (dy == 0)) > 0.95
    assert np.nanmax(dx) <= 1.0 and np.nanmax(dy) <= 1.0
