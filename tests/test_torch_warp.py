"""Render path of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

Same numpy-seeded inputs through the JAX function (Pallas in interpret
mode, as the JAX tests run it) and the port's counterpart:
  * K4 (ops.cuda_warp.shift_warp) vs pallas_warp.pallas_shift_warp_tiled,
    all four methods, NaN and out-of-image coordinates, ~100 px
    displacements (the range-reduced Lanczos weights);
  * the exact port render vs the reference's two-pass approximation;
  * tiled_plan_device's overflow flag, the map upsampling / sampling,
    the hole fill, map composition and inversion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import map_utils as jmap
from sofima_tpu.ops import fill as jfill
from sofima_tpu.ops import interp as jinterp
from sofima_tpu.ops import pallas_warp
from sofima_tpu.ops import shift_warp as jsw
from sofima_tpu_torch import map_utils as tmap
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import fill as tfill
from sofima_tpu_torch.ops import interp as tinterp
from sofima_tpu_torch.ops import shift_warp as tsw

torch.set_num_threads(2)


def _t(a):
  return torch.from_numpy(np.ascontiguousarray(a))


def _warp_case(h=72, w=256, seed=0, nan=True):
  """Image, coords with ~100 px x / ~40 px y displacement, node map."""
  rng = np.random.RandomState(seed)
  img = (rng.rand(1, h, w) * 255).astype(np.float32)
  yy, xx = np.mgrid[:h, :w].astype(np.float32)
  cy = yy + 40.3 + 1.5 * np.sin(xx / 37.0)
  cx = xx - 99.6 + 1.5 * np.cos(yy / 23.0)
  coords = np.stack([cy, cx])[None].astype(np.float32)
  if nan:
    coords[0, :, 5, 7] = np.nan
    coords[0, 1, 30, 200:204] = np.nan
  return img, coords


def _jax_render(img, coords, method, two_pass=False, tile=(8, 128)):
  h, w = img.shape[1:]
  step = 8
  node_y = np.arange(0, h + step, step, dtype=np.float64)
  node_x = np.arange(0, w + step, step, dtype=np.float64)
  yy, xx = np.meshgrid(node_y, node_x, indexing='ij')
  cy = np.nan_to_num(coords[0, 0], nan=0.0)
  cx = np.nan_to_num(coords[0, 1], nan=0.0)
  iy = np.clip(yy.astype(int), 0, h - 1)
  ix = np.clip(xx.astype(int), 0, w - 1)
  disp_y = (cy[iy, ix] - iy)[None]
  disp_x = (cx[iy, ix] - ix)[None]
  plan = jsw.tiled_shift_plan(disp_y, disp_x, node_y, node_x, (h, w),
                              tile=tile, pad=4.0)
  out = pallas_warp.pallas_shift_warp_tiled(
      jnp.asarray(img), jnp.asarray(coords), jnp.asarray(plan['bases']),
      method, *plan['residual_bounds'], *plan['base_bounds'], *plan['tile'],
      interpret=True, two_pass=two_pass)
  return np.asarray(out)


class TestRenderKernel:
  """K4 plain version vs the exact Pallas render. Tolerance: f32 noise,
  atol 1e-3 gray levels on 0..255 images (both sum the same taps in the
  same order; only sin/cos and FMA rounding differ)."""

  @pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic',
                                      'lanczos'])
  def test_matches_pallas_tiled(self, method):
    img, coords = _warp_case()
    ref = _jax_render(img, coords, method)
    got = cuda_warp.shift_warp(_t(img), _t(coords), method).numpy()
    assert got.shape == ref.shape == (1, 72, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert got[0, 5, 7] == 0.0  # NaN coordinate renders 0
    # Part of the output samples outside the image (x - 99.6 < 0).
    assert np.all(got[0, :, :60] == got[0, :, :60])

  def test_two_pass_within_bench_gate(self):
    # The port renders two_pass exactly; the reference's separable
    # approximation is held to it by the bench gate (mean <= 0.05,
    # max <= 4.0 gray levels) on mesh-smooth maps.
    h, w = 72, 256
    rng = np.random.RandomState(1)
    f = np.fft.rfft2(rng.rand(h, w))
    f *= np.exp(-((np.fft.rfftfreq(w)[None, :] ** 2
                   + np.fft.fftfreq(h)[:, None] ** 2) / (2 * 0.08 ** 2)))
    tex = np.fft.irfft2(f, s=(h, w))
    img = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)[None]
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    coords = np.stack([yy + 40.3 + 1.5 * np.sin(xx / 300.0),
                       xx - 99.6 + 1.5 * np.cos(yy / 300.0)])
    coords = coords[None].astype(np.float32)
    ref = _jax_render(img, coords, 'lanczos', two_pass=True)
    got = cuda_warp.shift_warp(_t(img), _t(coords), 'lanczos').numpy()
    d = np.abs(got - ref)[:, 8:-8, 8:-8]
    assert d.mean() <= 0.05 and d.max() <= 4.0, (d.mean(), d.max())

  def test_weights_match_make_weight_fn(self):
    # Residual-sized d (what the tiled reference kernel sees): f32 noise.
    rng = np.random.RandomState(3)
    d = (rng.rand(64) * 12 - 6).astype(np.float32)
    for method in ('linear', 'cubic', 'lanczos'):
      jw = jsw.make_weight_fn(jnp.asarray(d), method)
      tw = tsw.make_weight_fn(_t(d), method)
      for s in (-3, 0, 5):
        base = np.floor(d).astype(np.int64) + s
        ref = np.asarray(jw(jnp.asarray(base, jnp.float32)))
        got = tw(torch.from_numpy(base)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

  def test_lanczos_range_reduction(self):
    # |d| ~ 100 (the gather's displacement relative to the output pixel):
    # the range-reduced weights stay within 1e-3 of the float64 kernel
    # (without the reduction they reach +-1e3 near integer shifts; the
    # 1e-3 is the factored formula's own cancellation at t ~ 1e-4, which
    # the reference kernel shares).
    rng = np.random.RandomState(4)
    d = (rng.rand(256) * 240 - 120).astype(np.float32)
    d[:8] = np.round(d[:8]) + np.float32(1e-4)  # near-integer shifts
    tw = tsw.make_weight_fn(_t(d), 'lanczos')
    for s in range(-3, 5):
      base = np.floor(d).astype(np.int64) + s
      t = d.astype(np.float64) - base
      exact = np.where(np.abs(t) < 4, np.sinc(t) * np.sinc(t / 4), 0.0)
      got = tw(torch.from_numpy(base)).numpy()
      np.testing.assert_allclose(got, exact, rtol=0, atol=1e-3)


class TestRenderPlan:

  @pytest.mark.parametrize('residual,expect', [(2, True), (16, False)])
  def test_overflow_flag_matches(self, residual, expect):
    rng = np.random.RandomState(4)
    g, s, n = 12, 40, 480
    yy, xx = np.mgrid[:g, :g].astype(np.float32)
    dy = (3.0 * np.sin(xx / 2.0) + rng.randn(g, g)).astype(np.float32)
    dx = (-4.0 * np.cos(yy / 3.0) + 20.0).astype(np.float32)
    dy[3, 4] = np.nan
    node = np.arange(g, dtype=np.float64) * s
    env_r = (-residual, residual, -residual, residual)
    env_b = (-64, 64, -64, 64)
    ref = jsw.tiled_plan_device(jnp.asarray(dy[None]), jnp.asarray(dx[None]),
                                node, node, (n, n), env_r, env_b)
    got = tsw.tiled_plan_device(_t(dy[None]), _t(dx[None]), node, node,
                                (n, n), env_r, env_b)
    assert bool(got['overflow']) == bool(ref['overflow']) == expect
    assert got['tile'] == ref['tile']


class TestMapAlgebra:
  """Small-grid algebra; tolerance f32 noise unless stated."""

  def test_upsample_map_linear(self):
    rng = np.random.RandomState(5)
    v = rng.randn(2, 7, 9).astype(np.float32) * 10
    ref = np.asarray(jinterp.upsample_map_linear(jnp.asarray(v), 8, (3, 5),
                                                 (61, 83)))
    got = tinterp.upsample_map_linear(_t(v), 8, (3, 5), (61, 83)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)

  def test_grid_sample_linear_extrapolates(self):
    rng = np.random.RandomState(6)
    v = rng.randn(6, 8).astype(np.float32)
    q = (rng.rand(2, 5, 7).astype(np.float32) * 12 - 3)
    for extrapolate in (True, False):
      ref = np.asarray(jinterp.grid_sample_linear(jnp.asarray(v),
                                                  jnp.asarray(q),
                                                  extrapolate=extrapolate))
      got = tinterp.grid_sample_linear(_t(v), _t(q), extrapolate).numpy()
      np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

  @pytest.mark.parametrize('mode', ['constant', 'nearest'])
  def test_sample_linear(self, mode):
    rng = np.random.RandomState(7)
    img = rng.randn(9, 11).astype(np.float32)
    img[4, 5] = np.nan
    q = rng.rand(2, 6, 6).astype(np.float32) * 13 - 1
    q[:, 0, 0] = (3.0, 4.0)  # exact grid point next to the NaN node
    q[1, 2, 2] = np.nan
    ref = np.asarray(jinterp.sample(jnp.asarray(img), jnp.asarray(q),
                                    'linear', mode))
    got = tinterp.sample(_t(img), _t(q), 'linear', mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

  def test_fill_invalid(self):
    rng = np.random.RandomState(8)
    g = 23
    yy, xx = np.mgrid[:g, :g].astype(np.float32)
    v = np.stack([0.3 * xx + 0.1 * yy, -0.2 * yy + 1.0]).astype(np.float32)
    v += rng.randn(2, g, g).astype(np.float32) * 0.1
    valid = np.ones((g, g), bool)
    valid[:3] = False
    valid[10:14, 5:9] = False
    valid[:, -2:] = False
    v[:, ~valid] = np.nan
    for extrapolate in (False, True):
      ref = np.asarray(jfill.fill_invalid(jnp.asarray(v), jnp.asarray(valid),
                                          extrapolate=extrapolate))
      got = tfill.fill_invalid(_t(v), _t(valid), extrapolate).numpy()
      np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)

  def test_fill_invalid_batch_equals_sections(self):
    # The port writes the reference's vmap over sections as a batch
    # dimension: each section of a batch fills exactly as alone, and an
    # all-invalid section stays as it is.
    rng = np.random.RandomState(11)
    v = rng.randn(3, 2, 17, 19).astype(np.float32)
    valid = rng.rand(3, 17, 19) > 0.4
    valid[2] = False
    v[:, :, ~valid[0]] = np.nan
    got = tfill.fill_invalid(_t(v), _t(valid), extrapolate=True)
    for z in range(3):
      alone = tfill.fill_invalid(_t(v[z]), _t(valid[z]), extrapolate=True)
      torch.testing.assert_close(got[z], alone, rtol=0, atol=0,
                                 equal_nan=True)

  def test_compose_maps_fast(self):
    rng = np.random.RandomState(9)
    m1 = rng.randn(2, 2, 10, 12).astype(np.float32) * 5
    m2 = rng.randn(2, 2, 10, 12).astype(np.float32) * 5
    m1[:, 0, 2, 3] = np.nan
    m2[:, 1, 6, 6] = np.nan
    z3 = np.zeros(3, np.float32)
    for mode in ('nearest', 'constant'):
      ref = np.asarray(jmap.compose_maps_fast(jnp.asarray(m1), z3, 40.0,
                                              jnp.asarray(m2), z3, 40.0,
                                              mode=mode))
      got = tmap.compose_maps_fast(_t(m1), z3, 40.0, _t(m2), z3, 40.0,
                                   mode=mode).numpy()
      np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
      np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))

  def test_invert_section(self):
    # The pipeline's inversion (fixed point 12 + Newton 2, shift_bound):
    # tolerance 1e-3 px (iterated f32 arithmetic).
    rng = np.random.RandomState(10)
    g, s = 16, 40.0
    yy, xx = np.mgrid[:g, :g].astype(np.float32)
    rel = np.stack([6.0 * np.sin(yy / 5.0) + 3.0,
                    -4.0 * np.cos(xx / 4.0)]).astype(np.float32)
    rel += rng.randn(2, g, g).astype(np.float32) * 0.3
    rel[:, 0, 0] = np.nan
    q = np.stack([xx * s, yy * s]).astype(np.float32)
    abs_map = rel + q
    kw = dict(num_iters=12, newton_iters=2, shift_bound=2)
    ref = np.asarray(jmap._invert_section(
        jnp.asarray(abs_map), jnp.zeros(2), jnp.asarray(q),
        jnp.full((2,), s), **kw))
    got = tmap._invert_section(_t(abs_map), torch.zeros(2), _t(q),
                               torch.full((2,), s), **kw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3, equal_nan=True)
    # Batched (the pipeline inverts all sections at once): each section
    # exactly as alone.
    batch = np.stack([abs_map, abs_map[:, ::-1, ::-1] * 0.98 + 10.0])
    got_b = tmap._invert_section(_t(batch), torch.zeros(2), _t(q),
                                 torch.full((2,), s), **kw)
    for z in range(2):
      alone = tmap._invert_section(_t(batch[z]), torch.zeros(2), _t(q),
                                   torch.full((2,), s), **kw)
      torch.testing.assert_close(got_b[z], alone, rtol=0, atol=0,
                                 equal_nan=True)
