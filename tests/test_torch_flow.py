"""Flow path of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

Same numpy-seeded inputs through the JAX function (Pallas kernels in
interpret mode, as the JAX tests run them) and the port:
  * K1 (dense_flow_peaks) vs pallas_flow.dense_flow_peaks_pallas and the
    strip path flow_field._dense_flow_strips (the JAX CPU coarse path);
  * K2 (dense_flow_peaks_targeted) with clipped offsets, peak_crop 32 and
    None, vs pallas_flow.dense_flow_peaks_targeted;
  * dense_flow_field's signature: the reference's defaults
    (circular=False, the linear correlation), a post_patch_size equal
    to the patch and bf16=True (accepted, computed in float32) match
    flow_field.dense_flow_field, and circular=True with batch_size
    passed by position does too;
  * coarse_to_fine_flow (flow and overflow flag; with a mask and with a
    prior too), the peak contract, clean_flow_device and the median
    filter.
Tolerances: integer x/y peaks and NaN placement exact; sharpness and
ratio rtol = atol = 3e-4 (tests/test_flow_field.py's bar). The JAX side
runs with bf16=False: the port correlates in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu import flow_utils as jfu
from sofima_tpu.ops import morphology as jmorph
from sofima_tpu.ops import pallas_flow
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch import flow_utils as tfu
from sofima_tpu_torch.ops import cuda_flow
from sofima_tpu_torch.ops import morphology as tmorph

torch.set_num_threads(2)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _texture(n, seed=3):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  return (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)


def _assert_flow_equal(got, ref):
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  np.testing.assert_allclose(got[2:], ref[2:], rtol=3e-4, atol=3e-4,
                             equal_nan=True)


class TestDenseFlowPeaks:
  """K1's plain version (the kernel's CPU path)."""

  def test_matches_pallas_grid_kernel(self):
    pre = _texture(360)
    post = np.roll(pre, (4, -6), (0, 1))
    ref = np.asarray(pallas_flow.dense_flow_peaks_pallas(
        jnp.asarray(pre), jnp.asarray(post), (160, 160), (40, 40),
        interpret=True))
    got = cuda_flow.dense_flow_peaks(_t(pre), _t(post), (160, 160),
                                     (40, 40)).numpy()
    _assert_flow_equal(got, ref)
    assert np.all(got[0] == 6) and np.all(got[1] == -4)

  @pytest.mark.parametrize('step', [40, 160])
  def test_matches_strip_path(self, step):
    pre = _texture(360, seed=4)
    post = np.roll(pre, (-3, 5), (0, 1))
    ref = np.asarray(jff._dense_flow_strips(
        jnp.asarray(pre), jnp.asarray(post), (160, 160), (step, step),
        None, 2, 0.5, 5, rows_per_step=2, dft_matmul=True,
        use_pallas=False))
    got = tff.dense_flow_field(_t(pre), _t(post), (160, 160),
                               (step, step), circular=True).numpy()
    _assert_flow_equal(got, ref)

  def test_rectangular_image(self):
    # gy != gx, a partial last row step and group in the reference.
    rng = np.random.RandomState(5)
    pre = (rng.rand(440, 680) * 255).astype(np.float32)
    post = np.roll(pre, (2, -4), (0, 1))
    ref = np.asarray(pallas_flow.dense_flow_peaks_pallas(
        jnp.asarray(pre), jnp.asarray(post), (160, 160), (40, 40),
        interpret=True))
    got = cuda_flow.dense_flow_peaks(_t(pre), _t(post), (160, 160),
                                     (40, 40)).numpy()
    assert got.shape == (4, 8, 14)
    _assert_flow_equal(got, ref)

  def test_no_peak_gives_nan_rows(self):
    flat = np.zeros((200, 200), np.float32)
    got = cuda_flow.dense_flow_peaks(_t(flat), _t(flat), (80, 80),
                                     (40, 40)).numpy()
    assert np.isnan(got).all()

  def test_batched_peaks_contract(self):
    rng = np.random.RandomState(2)
    img = rng.randn(6, 24, 24).astype(np.float32)
    img[1] = 0.0                       # no peak at all
    img[2, 5, 7] = img[2, 15, 3] = 50  # tie: the smaller index wins
    img[3] = -np.abs(img[3])
    img[3, 12, 12] = 9.0               # single peak, ratio 0
    ref = np.asarray(jff._batched_peaks(jnp.asarray(img), (12, 12), 2, 0.5,
                                        5))
    got = cuda_flow.batched_peaks(_t(img), (12, 12), 2, 0.5, 5).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert got[3, 3] == 0.0 and np.isnan(got[1]).all()


class TestDenseFlowFieldSignature:
  """dense_flow_field takes the reference's parameters, order and defaults,
  and computes what the reference computes with them."""

  def _pair(self):
    pre = _texture(128, seed=6)
    return pre, np.roll(pre, (3, -5), (0, 1))

  def test_reference_defaults_raise(self):
    # Once a raise (circular=False was not ported); now the reference's
    # default, the linear correlation, computes the reference's flow.
    pre, post = self._pair()
    ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                          (32, 32), (16, 16)))
    assert ref.shape == (4, 7, 7) and np.isfinite(ref[:2]).any()
    got = tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16))
    _assert_flow_equal(got.numpy(), ref)

  @pytest.mark.parametrize('kw', [dict(post_patch_size=(32, 32)),
                                  dict(bf16=True)])
  def test_unported_options_raise(self, kw):
    # Once raises; both options now take the reference's meaning.
    pre, post = self._pair()
    ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                          (32, 32), (16, 16), circular=True,
                                          **kw))
    got = tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16),
                               circular=True, **kw)
    _assert_flow_equal(got.numpy(), ref)

  def test_circular_with_positional_batch_size(self):
    pre, post = self._pair()
    ref = np.asarray(jff.dense_flow_field(jnp.asarray(pre), jnp.asarray(post),
                                          (32, 32), (16, 16), 16,
                                          circular=True))
    got = tff.dense_flow_field(_t(pre), _t(post), (32, 32), (16, 16), 16,
                               circular=True, dft_matmul=True).numpy()
    _assert_flow_equal(got, ref)


class TestTargetedFlowPeaks:
  """K2's plain version: per-block post offsets (clipped), peak crop."""

  @pytest.mark.parametrize('peak_crop', [32, None])
  def test_matches_pallas_targeted(self, peak_crop):
    pre = _texture(360, seed=5)
    post = np.roll(pre, (9, -13), (0, 1))
    geo = pallas_flow.targeted_geometry((360, 360), (80, 80), (40, 40),
                                        rows=4)
    assert geo == {k: v for k, v in cuda_flow.targeted_geometry(
        (360, 360), (80, 80), (40, 40), rows=4).items()}
    rng = np.random.RandomState(0)
    offs = rng.randint(-20, 21, size=(geo['nrsteps'], geo['ngroups'], 2))
    offs[0, 0] = (9, -13)
    offs[-1, -1] = (30, -30)  # beyond max_offset: clipped to +-12
    offs = offs.astype(np.int32)
    ref = np.asarray(pallas_flow.dense_flow_peaks_targeted(
        jnp.asarray(pre), jnp.asarray(post), jnp.asarray(offs), (80, 80),
        (40, 40), max_offset=12, interpret=True, peak_crop=peak_crop,
        rows=4))
    got = cuda_flow.dense_flow_peaks_targeted(
        _t(pre), _t(post), _t(offs), (80, 80), (40, 40), max_offset=12,
        peak_crop=peak_crop, rows=4).numpy()
    _assert_flow_equal(got, ref)


class TestCoarseToFine:

  @pytest.mark.parametrize('max_disp', [64, 8])
  def test_matches_reference(self, max_disp):
    pre = _texture(400, seed=6)
    post = np.roll(pre, (11, -14), (0, 1))
    kw = dict(max_displacement=max_disp, return_overflow=True,
              peak_crop=32)
    ref, ref_ov = jff.coarse_to_fine_flow(jnp.asarray(pre),
                                          jnp.asarray(post), (160, 160),
                                          (40, 40), bf16=False, residual=8,
                                          **kw)
    got, got_ov = tff.coarse_to_fine_flow(_t(pre), _t(post), (160, 160),
                                          (40, 40), **kw)
    assert bool(got_ov) == bool(ref_ov)
    _assert_flow_equal(got.numpy(), np.asarray(ref))

  def test_unported_branches_raise(self):
    # Masks and warm-start priors now run and match the reference (here
    # at 400^2; in depth in test_torch_flow_masked.py and
    # test_torch_warm_start.py), and the calculator's padfield mode with
    # its targeting fields in test_torch_flow_padfield.py (2d) and
    # test_torch_flow_padfield3d.py (3d). The calculator's 3d padfield
    # mode, once the last raise here, now matches the reference too.
    pre = _texture(400, seed=6)
    post = np.roll(pre, (11, -14), (0, 1))
    mask = np.zeros((400, 400), bool)
    mask[150:190, :] = True
    prior = np.zeros((2, 3, 3), np.float32)
    prior[0], prior[1] = 13.0, -10.0
    for kw in (dict(pre_mask=mask, post_mask=mask),
               dict(prior=prior, peak_crop=32)):
      ref = jff.coarse_to_fine_flow(
          jnp.asarray(pre), jnp.asarray(post), (160, 160), (40, 40),
          bf16=False, **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})
      got = tff.coarse_to_fine_flow(
          _t(pre), _t(post), (160, 160), (40, 40),
          **{k: _t(v) if isinstance(v, np.ndarray) else v
             for k, v in kw.items()})
      np.testing.assert_array_equal(np.nan_to_num(got[:2].numpy(), nan=9e9),
                                    np.nan_to_num(np.asarray(ref)[:2],
                                                  nan=9e9))
    calc = tff.JAXMaskedXCorrWithStatsCalculator(device='cpu')
    vol = np.stack([pre[:40, :40]] * 8)
    got = calc.flow_field(vol, vol, 8, 8)
    ref = jff.JAXMaskedXCorrWithStatsCalculator().flow_field(vol, vol, 8, 8)
    assert got.shape == ref.shape == (5, 1, 5, 5)
    np.testing.assert_array_equal(got[:3], np.asarray(ref)[:3])


class TestCleanFlow:

  def test_median_filter(self):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 9, 11).astype(np.float32)
    x[0, 1, 4, 4] = np.nan
    ref = np.asarray(jmorph.median_filter(jnp.asarray(x), dims=2))
    got = tmorph.median_filter(_t(x), dims=2).numpy()
    np.testing.assert_array_equal(got, ref)

  def test_clean_flow_device(self):
    rng = np.random.RandomState(8)
    flow = np.zeros((4, 1, 12, 12), np.float32)
    flow[:2] = rng.randn(2, 1, 12, 12) * 3
    flow[2] = rng.rand(1, 12, 12) * 4
    flow[3] = rng.rand(1, 12, 12) * 3
    flow[3, 0, 0, :4] = 0.0
    flow[0, 0, 5, 5] = 90.0           # magnitude
    flow[1, 0, 7, 2] = 30.0           # deviation from the 3x3 median
    flow[:, 0, 9, 9] = np.nan
    args = (1.6, 1.6, 80.0, 20.0)
    ref = np.asarray(jfu.clean_flow_device(jnp.asarray(flow), *args))
    got = tfu.clean_flow_device(_t(flow), *args).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(ref))
