"""Warm-start stack alignment of sofima_tpu_torch against sofima_tpu (CPU).

The port's plain versions against the JAX package on numpy-seeded
stacks (tests/test_stack_align.py's synthetic drift and wobble):
  * `_flow_phase(prior=...)`, the warm fine pass, at 800^2;
  * a masked prior on the node grid with `prior_origin=(0, 0)`, and the
    masked path's origin constraint;
  * the stale-prior refresh on and off (a 52/-48 px jump at 640^2);
  * `align_stack_pipelined` with `warm_start` against the reference's;
  * `align_step`, which runs cold.
Tolerances: flows (integer peaks, NaN placement, the cleaned fields)
exact; solved meshes within 0.01 * stride = 0.4 px, the pipeline's
fixed-point tolerance. The JAX side runs with bf16=False: the port
correlates in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu.ops import interp as jinterp
from sofima_tpu.pipeline import stack_align as jsa
from sofima_tpu_torch import convert
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch.pipeline import stack_align as tsa

torch.set_num_threads(2)


def _texture(n, seed=0):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  tex = np.fft.irfft2(f, s=(n, n))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


def _warp(base, dy, dx):
  n = base.shape[0]
  yy, xx = np.mgrid[:n, :n].astype(np.float32)
  coords = jnp.stack([jnp.asarray(yy + dy), jnp.asarray(xx + dx)])
  return np.asarray(jinterp.sample(jnp.asarray(base), coords,
                                   method='linear', mode='nearest'))


def _make_stack(n, n_z):
  """Cumulative drift + low-frequency wobble (tests/test_stack_align.py)."""
  base = _texture(n)
  yy, xx = np.mgrid[:n, :n].astype(np.float32)
  sections = [base]
  for z in range(1, n_z):
    sections.append(_warp(base, 3.0 * z + 4.0 * np.sin(2 * np.pi * xx / n + z),
                          -2.0 * z + 4.0 * np.cos(2 * np.pi * yy / n
                                                  + 0.5 * z)))
  return np.stack(sections).astype(np.uint8)


@pytest.fixture(scope='module')
def stack800():
  return _make_stack(800, 3)


def _sections(stack):
  return [stack[z].astype(np.float32) for z in range(stack.shape[0])]


class TestWarmFlow:

  def test_flow_phase_prior_matches_reference(self, stack800):
    jcfg = jsa.StackAlignConfig(max_displacement=64, residual=16, bf16=False)
    tcfg = convert.config_from_jax(jcfg)
    grid_n = 800 // jcfg.stride
    s0, s1, s2 = _sections(stack800)
    jf0, _ = jsa._flow_phase(jnp.asarray(s0), jnp.asarray(s1), jcfg, grid_n)
    jf1, jov = jsa._flow_phase(jnp.asarray(s1), jnp.asarray(s2), jcfg,
                               grid_n, prior=jf0[:, 0])
    tf0, _ = tsa._flow_phase(torch.from_numpy(s0), torch.from_numpy(s1),
                             tcfg, grid_n)
    tf1, tov = tsa._flow_phase(torch.from_numpy(s1), torch.from_numpy(s2),
                               tcfg, grid_n, prior=tf0[:, 0])
    np.testing.assert_array_equal(tf0.numpy(), np.asarray(jf0))
    np.testing.assert_array_equal(tf1.numpy(), np.asarray(jf1))
    assert bool(tov) == bool(jov) is False
    assert np.isfinite(tf1.numpy()).mean() > 0.5

  def test_masked_prior_on_node_grid(self):
    # The full-grid prior of stack_align (node j at pixel j * stride,
    # NaN border, origin 0 <= step) drives the masked transport.
    n, s, pad = 640, 40, 2
    s0, s1, s2 = _sections(_make_stack(n, 3))
    mask = np.zeros((n, n), bool)
    mask[:, 250:320] = True  # vertical band, ~11% invalid
    kw = dict(patch_size=(160, 160), step=(s, s), max_displacement=64,
              residual=16)
    tmask = torch.from_numpy(mask)
    f0 = tff.coarse_to_fine_flow(torch.from_numpy(s0), torch.from_numpy(s1),
                                 pre_mask=tmask, post_mask=tmask, **kw)
    prior = np.full((2, n // s, n // s), np.nan, np.float32)
    prior[:, pad:pad + f0.shape[1], pad:pad + f0.shape[2]] = f0[:2].numpy()
    ref = np.asarray(jff.coarse_to_fine_flow(
        jnp.asarray(s1), jnp.asarray(s2), bf16=False,
        pre_mask=jnp.asarray(mask), post_mask=jnp.asarray(mask),
        prior=jnp.asarray(prior), prior_step=(s, s), prior_origin=(0, 0),
        **kw))
    got = tff.coarse_to_fine_flow(
        torch.from_numpy(s1), torch.from_numpy(s2), pre_mask=tmask,
        post_mask=tmask, prior=torch.from_numpy(prior), prior_step=(s, s),
        prior_origin=(0, 0), **kw).numpy()
    np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                  np.nan_to_num(ref[:2], nan=9e9))
    assert np.isfinite(got[0]).mean() > 0.6

  def test_masked_prior_origin_constraint_raises(self):
    img = torch.zeros(800, 800)
    mask = torch.zeros(800, 800, dtype=torch.bool)
    with pytest.raises(ValueError, match='origin'):
      tff.coarse_to_fine_flow(img, img, (160, 160), (40, 40), pre_mask=mask,
                              post_mask=mask, prior=torch.zeros(2, 18, 18),
                              prior_step=(40, 40), prior_origin=(80, 80))


class TestWarmPipeline:

  def test_stale_prior_refresh(self):
    # tests/test_stack_align.py's case: pair 1 jumps 52/-48 px, beyond
    # the fine window's +-40 px capture, so pair 0's flow is a stale
    # prior. With the refresh the warm chain re-measures pair 1 cold and
    # lands on the cold chain's meshes; without it the warm flow is
    # broken (mostly invalid, or aliased by a window period).
    n = 640
    base = _texture(n)
    stack = np.stack([base, _warp(base, 2.0, -3.0),
                      _warp(base, 54.0, -51.0)]).astype(np.uint8)
    # A short solve: the refresh acts on the flows, which the solve only
    # carries through.
    kw = dict(max_displacement=96, residual=16,
              mesh=dataclasses.replace(tsa.StackAlignConfig().mesh,
                                       num_iters=100, max_iters=200))
    cfg_cold = tsa.StackAlignConfig(**kw)
    cfg_on = tsa.StackAlignConfig(warm_start=True, **kw)
    cfg_off = tsa.StackAlignConfig(warm_start=True,
                                   warm_refresh_min_valid=None, **kw)
    grid_n, pad = n // 40, 2
    st = torch.from_numpy(stack)
    f0, _ = tsa._flow_phase(st[0], st[1], cfg_cold, grid_n)
    f1_cold, _ = tsa._flow_phase(st[1], st[2], cfg_cold, grid_n)
    f1_warm, ov = tsa._flow_phase(st[1], st[2], cfg_cold, grid_n,
                                  prior=f0[:, 0])
    inner = np.s_[:, 0, pad:grid_n - pad, pad:grid_n - pad]
    cold_i, warm_i = f1_cold.numpy()[inner], f1_warm.numpy()[inner]
    assert (np.mean(np.isfinite(warm_i)) < 0.5
            or np.nanmax(np.abs(warm_i - cold_i)) > 10.0)
    assert bool(tsa._stale(f1_warm, ov, f0, cfg_on))
    assert not bool(tsa._stale(f1_cold, ov, f1_cold, cfg_on))

    _, s_cold, _ = tsa.align_stack_pipelined(st, cfg_cold)
    _, s_on, _ = tsa.align_stack_pipelined(st, cfg_on)
    _, s_off, _ = tsa.align_stack_pipelined(st, cfg_off)
    torch.testing.assert_close(s_on, s_cold, rtol=0, atol=0)
    assert float(torch.nan_to_num((s_off - s_cold).abs()).max()) > 0.4

  def test_pipelined_warm_matches_reference(self):
    n = 480
    stack = _make_stack(n, 3)
    jcfg = jsa.StackAlignConfig(max_displacement=64, residual=8, bf16=False,
                                peak_crop=32, render_two_pass=True,
                                warm_start=True)
    jcfg = dataclasses.replace(jcfg, mesh=dataclasses.replace(
        jcfg.mesh, num_iters=125))
    _, ref, ref_ov = jsa.align_stack_pipelined(jnp.asarray(stack), jcfg)
    tcfg = convert.config_from_jax(jcfg)
    assert tcfg.warm_start and tcfg.warm_refresh_min_valid == 0.5
    _, got, got_ov = tsa.align_stack_pipelined(torch.from_numpy(stack), tcfg)
    assert bool(got_ov) == bool(ref_ov) is False
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 0.4

  def test_align_step_ignores_warm_start(self):
    # As in the reference, the per-section step always measures cold.
    n = 320
    stack = torch.from_numpy(_make_stack(n, 3))
    cfg = tsa.StackAlignConfig(
        max_displacement=32, residual=8,
        mesh=dataclasses.replace(tsa.StackAlignConfig().mesh, num_iters=50,
                                 max_iters=100))
    prev = torch.zeros(2, 1, n // 40, n // 40)
    cold = tsa.align_step(stack[1], stack[2], prev, cfg)
    warm = tsa.align_step(stack[1], stack[2], prev,
                          dataclasses.replace(cfg, warm_start=True))
    for a, b in zip(cold, warm):
      torch.testing.assert_close(a, b, rtol=0, atol=0)
