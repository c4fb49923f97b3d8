"""The stack-alignment slice of sofima_tpu_torch against sofima_tpu.

End to end on the CPU (the port's plain versions) against the JAX
pipeline on the same small synthetic stack (480^2 x 3, as
tests/test_stack_align.py builds it), plus configuration and state
carried across with sofima_tpu_torch.convert, and the port's structural
contract: no JAX import, lazy kernel build.

Tolerances: solved meshes within 0.4 px (0.01 * stride, the pipeline's
fixed-point tolerance; measured ~5e-5 px), the overflow flag equal, and
rendered interiors within the reference's two-pass bench gate (mean
<= 0.05, max <= 4.0 gray levels): the port renders exactly where the JAX
headline config renders with the separable approximation.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu.ops import interp as jinterp
from sofima_tpu.pipeline import stack_align as jsa
from sofima_tpu_torch import convert
from sofima_tpu_torch.ops import cuda_mesh
from sofima_tpu_torch.pipeline import stack_align as tsa

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
N, NZ = 480, 3


def _texture(n, seed=0):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  tex = np.fft.irfft2(f, s=(n, n))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


def _make_stack(n, n_z):
  """Cumulative drift + low-frequency wobble (tests/test_stack_align.py)."""
  base = _texture(n)
  yy, xx = np.mgrid[:n, :n].astype(np.float32)
  sections = [base]
  for z in range(1, n_z):
    dy = 3.0 * z + 4.0 * np.sin(2 * np.pi * xx / n + z)
    dx = -2.0 * z + 4.0 * np.cos(2 * np.pi * yy / n + 0.5 * z)
    coords = jnp.stack([jnp.asarray(yy + dy), jnp.asarray(xx + dx)])
    sections.append(np.asarray(jinterp.sample(
        jnp.asarray(base), coords, method='linear', mode='nearest')))
  return np.stack(sections).astype(np.uint8)


def _jax_config():
  # The headline configuration at this size (bf16 off: the port
  # correlates in float32).
  cfg = jsa.StackAlignConfig(max_displacement=64, residual=8, bf16=False,
                             peak_crop=32, render_two_pass=True)
  return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                          num_iters=125))


@pytest.fixture(scope='module')
def case():
  stack = _make_stack(N, NZ)
  jcfg = _jax_config()
  rendered, solved, overflow = jsa.align_stack(stack, jcfg)
  return dict(stack=stack, jcfg=jcfg, rendered=np.asarray(rendered),
              solved=np.asarray(solved), overflow=bool(overflow))


class TestSlice:

  def test_align_stack_matches_reference(self, case):
    tcfg = convert.config_from_jax(case['jcfg'])
    rendered, solved, overflow = tsa.align_stack(
        torch.from_numpy(case['stack']), tcfg)
    assert bool(overflow) == case['overflow']
    solved = solved.numpy()
    assert solved.shape == case['solved'].shape == (NZ, 2, 1, 12, 12)
    np.testing.assert_array_equal(np.isnan(solved),
                                  np.isnan(case['solved']))
    assert np.nanmax(np.abs(solved - case['solved'])) < 0.4
    d = np.abs(rendered.numpy() - case['rendered'])[:, 80:-80, 80:-80]
    assert d.mean() <= 0.05 and d.max() <= 4.0, (d.mean(), d.max())
    # And it aligns: neighbours far closer than the raw sections.
    raw = case['stack'].astype(np.float32)[:, 160:-160, 160:-160]
    out = rendered.numpy()[:, 160:-160, 160:-160]
    for z in range(1, NZ):
      assert (np.abs(out[z] - out[z - 1]).mean()
              < np.abs(raw[z] - raw[z - 1]).mean() / 3)

  def test_align_step_from_jax_state(self, case):
    # A JAX solved mesh fed into the port's per-section step continues
    # the JAX chain: it must land on the reference's next mesh.
    tcfg = convert.config_from_jax(case['jcfg'])
    stack = torch.from_numpy(case['stack'])
    prev = convert.map_from_numpy(case['solved'][1], device='cpu')
    solved, rendered, overflow = tsa.align_step(stack[1], stack[2], prev,
                                                tcfg)
    assert solved.shape == prev.shape and rendered.shape == (N, N)
    assert not bool(overflow)
    assert np.nanmax(np.abs(convert.map_to_numpy(solved)
                            - case['solved'][2])) < 0.4

  def test_streamed_equals_pipelined(self, case):
    tcfg = convert.config_from_jax(case['jcfg'])
    stack = torch.from_numpy(case['stack'])
    _, s_pipe, _ = tsa.align_stack(stack, tcfg, pipelined=True)
    _, s_step, _ = tsa.align_stack(stack, tcfg, pipelined=False)
    torch.testing.assert_close(s_pipe, s_step, rtol=0, atol=0)

  def test_warm_start_not_ported(self, case):
    # The reference streams cold: `warm_start` acts in the pipelined
    # path only (tests/test_torch_warm_start.py), so the streamed
    # loop with it equals the streamed cold run.
    tcfg = convert.config_from_jax(case['jcfg'])
    stack = torch.from_numpy(case['stack'])
    cold = tsa.align_stack(stack, tcfg, pipelined=False)
    warm = tsa.align_stack(stack, dataclasses.replace(tcfg, warm_start=True),
                           pipelined=False)
    for a, b in zip(cold, warm):
      torch.testing.assert_close(a, b, rtol=0, atol=0)

  def test_streamed_out_dtype_matches_reference(self, case):
    # The reference's streamed loop ignores `out_dtype` and returns
    # float32 renders; the pipelined one stores clip-rounded uint8.
    stack = case['stack'][:2]
    ref, _, _ = jsa.align_stack(stack, case['jcfg'], pipelined=False,
                                out_dtype=jnp.uint8)
    got, _, _ = tsa.align_stack(torch.from_numpy(stack),
                                convert.config_from_jax(case['jcfg']),
                                pipelined=False, out_dtype=torch.uint8)
    assert np.asarray(ref).dtype == np.float32 and got.dtype == torch.float32
    d = np.abs(got.numpy() - np.asarray(ref))[:, 80:-80, 80:-80]
    assert d.mean() <= 0.05 and d.max() <= 4.0, (d.mean(), d.max())
    piped, _, _ = tsa.align_stack(torch.from_numpy(stack),
                                  convert.config_from_jax(case['jcfg']),
                                  out_dtype=torch.uint8)
    assert piped.dtype == torch.uint8
    torch.testing.assert_close(piped, torch.clamp(torch.round(got), 0, 255)
                               .to(torch.uint8), rtol=0, atol=0)

  def test_drift_removal_not_ported(self, case):
    # Drift removal is not ported into the fused solver, which raises for
    # it as the reference's Pallas solver does; so both pipelines take
    # their staged solver (the port's force: K8's plain version here),
    # and the step from the same JAX state must land on the reference's
    # mesh.
    jcfg = dataclasses.replace(case['jcfg'], mesh=dataclasses.replace(
        case['jcfg'].mesh, remove_drift=True))
    stack, prev = case['stack'], case['solved'][1]
    x0 = torch.zeros(2, 1, 5, 5)
    with pytest.raises(NotImplementedError):
      cuda_mesh.relax_mesh_fused(x0, x0, convert.config_from_jax(jcfg).mesh)
    ref, _, ref_ov = jsa.align_step(jnp.asarray(stack[1]),
                                    jnp.asarray(stack[2]),
                                    jnp.asarray(prev), jcfg)
    got, rendered, overflow = tsa.align_step(
        torch.from_numpy(stack[1]), torch.from_numpy(stack[2]),
        convert.map_from_numpy(prev, device='cpu'),
        convert.config_from_jax(jcfg))
    assert bool(overflow) == bool(ref_ov)
    ref, got = np.asarray(ref), convert.map_to_numpy(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 0.4  # 0.01 * stride
    assert np.isfinite(rendered.numpy()).all()


class TestConvert:

  @pytest.mark.parametrize('make', [
      lambda m: m.StackAlignConfig(),
      lambda m: m.archival_em2d_config(peak_crop=32, residual=6),
      lambda m: m.StackAlignConfig(warm_start=True,
                                   warm_refresh_min_valid=0.3)])
  def test_config_from_jax(self, make):
    jcfg = make(jsa)
    tcfg = convert.config_from_jax(jcfg)
    assert tcfg == make(tsa)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.mesh.to_json() == jcfg.mesh.to_json()
    assert convert.config_from_jax(jcfg.mesh) == tcfg.mesh

  def test_maps_round_trip_exactly(self):
    rng = np.random.RandomState(0)
    for shape, dtype in (((2, 3, 5, 7), np.float32),
                         ((3, 2, 4, 4), np.float64),
                         ((2, 1, 12, 12), np.float32)):
      m = rng.randn(*shape).astype(dtype)
      m[:, 0, 1, 2] = np.nan
      jm = jnp.asarray(m)
      t = convert.map_from_numpy(jm, device='cpu')
      assert tuple(t.shape) == shape
      back = convert.map_to_numpy(t)
      assert back.dtype == np.asarray(jm).dtype
      np.testing.assert_array_equal(back, np.asarray(jm))
    with pytest.raises(ValueError):
      convert.map_from_numpy(np.zeros((4, 1, 2, 2)), device='cpu')


class TestStructure:

  def test_port_imports_no_jax(self):
    mods = ['sofima_tpu_torch.pipeline.stack_align', 'sofima_tpu_torch.convert',
            'sofima_tpu_torch.ops.cuda_flow', 'sofima_tpu_torch.ops.cuda_mesh',
            'sofima_tpu_torch.ops.cuda_warp', 'sofima_tpu_torch.utils.geom',
            'sofima_tpu_torch.processor.runner',
            'sofima_tpu_torch.processor.flow',
            'sofima_tpu_torch.processor.mesh',
            'sofima_tpu_torch.processor.maps',
            'sofima_tpu_torch.processor.warp',
            'sofima_tpu_torch.processor.defaults.em_2d',
            'sofima_tpu_torch.pipeline.flow_config',
            'sofima_tpu_torch.pipeline.mesh_config',
            'sofima_tpu_torch.pipeline.warp_config',
            'sofima_tpu_torch.utils.mask', 'sofima_tpu_torch.ops.edt']
    code = ('import sys\n' + ''.join(f'import {m}\n' for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'sofima_tpu.'))]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and 'ok' in out.stdout, out.stderr
    for src in (REPO / 'sofima_tpu_torch').rglob('*.py'):
      text = src.read_text()
      assert 'import jax' not in text and 'from jax' not in text, src

  def test_wrappers_need_no_nvcc_on_cpu(self):
    code = '''
import torch
from sofima_tpu_torch.ops import _build, cuda_flow, cuda_mesh, cuda_warp
from sofima_tpu_torch import mesh
img = torch.rand(200, 200)
cuda_flow.dense_flow_peaks(img, img, (80, 80), (40, 40))
cuda_flow.masked_dense_flow_peaks(img, img, img > 0.1, None, (80, 80),
                                  (40, 40))
cfg = mesh.IntegrationConfig(dt=0.001, gamma=0.0, k0=0.1, k=0.1,
                             stride=(40.0, 40.0), num_iters=10,
                             max_iters=20, stop_v_max=0.005)
cuda_mesh.relax_mesh_fused(torch.zeros(2, 1, 6, 6), None, cfg)
cuda_warp.shift_warp(img[None], torch.rand(1, 2, 8, 8) * 100, 'lanczos')
assert _build._lib is None and not any(_build.launch_counts.values())
print('ok')
'''
    env = dict(os.environ, PATH='/usr/bin:/bin', CUDA_HOME='/nonexistent',
               NVCC='/nonexistent/nvcc')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and 'ok' in out.stdout, out.stderr
