"""sofima_tpu_torch's CUDA kernels against their plain versions (GPU only).

Marked `gpu`: each test skips where torch finds no CUDA device (decided
inside the fixture, never at import). Run on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerances: integer flow peaks and NaN placement exact, sharpness /
ratio rtol = atol = 3e-4 on these well-conditioned inputs; fused solver
steps equal and nodes within 1e-3 px; render within 1e-2 gray levels.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sofima_tpu_torch import mesh
from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.ops import cuda_flow
from sofima_tpu_torch.ops import cuda_mesh
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.pipeline import stack_align

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda', 0)


def _texture(n, seed=3):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  return (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)


def _flow_equal(got, ref):
  torch.testing.assert_close(torch.nan_to_num(got[:2], nan=9e9),
                             torch.nan_to_num(ref[:2], nan=9e9), rtol=0,
                             atol=0)
  torch.testing.assert_close(got[2:], ref[2:], rtol=3e-4, atol=3e-4,
                             equal_nan=True)


@pytest.mark.parametrize('p,s,h,w', [(160, 160, 600, 600),
                                     (160, 40, 600, 600),
                                     (80, 40, 600, 600),
                                     (160, 40, 440, 680)])
def test_dense_flow_peaks(dev, p, s, h, w):
  pre = torch.from_numpy(_texture(max(h, w))[:h, :w].copy()).to(dev)
  post = torch.roll(pre, (4, -6), (0, 1)).contiguous()
  before = _build.launch_counts['dense_flow_peaks']
  got = cuda_flow.dense_flow_peaks(pre, post, (p, p), (s, s))
  assert _build.launch_counts['dense_flow_peaks'] == before + 1
  ref = cuda_flow.dense_flow_peaks(pre.cpu(), post.cpu(), (p, p), (s, s))
  _flow_equal(got.cpu(), ref)


@pytest.mark.parametrize('crop', [32, None])
def test_targeted_flow_peaks(dev, crop):
  pre = torch.from_numpy(_texture(600, seed=4)).to(dev)
  post = torch.roll(pre, (9, -13), (0, 1)).contiguous()
  geo = cuda_flow.targeted_geometry((600, 600), (80, 80), (40, 40), rows=4)
  rng = np.random.RandomState(0)
  offs = rng.randint(-2, 3, size=(geo['nrsteps'], geo['ngroups'], 2))
  offs = torch.from_numpy((offs + [9, -13]).astype(np.int32))
  got = cuda_flow.dense_flow_peaks_targeted(
      pre, post, offs.to(dev), (80, 80), (40, 40), max_offset=12,
      peak_crop=crop, rows=4)
  ref = cuda_flow.dense_flow_peaks_targeted(
      pre.cpu(), post.cpu(), offs, (80, 80), (40, 40), max_offset=12,
      peak_crop=crop, rows=4)
  _flow_equal(got.cpu(), ref)


def test_fused_fire(dev):
  g = 64
  rng = np.random.RandomState(0)
  prev = np.full((2, 1, g, g), np.nan, np.float32)
  prev[:, :, 2:-2, 2:-2] = rng.randn(2, 1, g - 4, g - 4) * 3
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0, 40.0),
      num_iters=200, max_iters=2000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1, prefer_orig_order=True)
  x0 = torch.zeros(2, 1, g, g)
  pv = torch.from_numpy(prev)
  got, _, steps = cuda_mesh.relax_mesh_fused(x0.to(dev), pv.to(dev), cfg)
  ref, _, steps_ref = cuda_mesh.relax_mesh_fused(x0, pv, cfg)
  assert int(steps) == int(steps_ref)
  got = got.cpu()
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 1e-3
  with pytest.raises(NotImplementedError):
    cuda_mesh.relax_mesh_fused(
        x0.to(dev), pv.to(dev),
        mesh.IntegrationConfig(**{**cfg.__dict__, 'remove_drift': True}))


def test_align_step_drift_removal_raises(dev):
  cfg = stack_align.StackAlignConfig()
  cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
      cfg.mesh, remove_drift=True))
  sec = torch.from_numpy(_texture(400)).to(dev)
  before = _build.launch_counts['fused_fire']
  with pytest.raises(NotImplementedError):
    stack_align.align_step(sec, torch.roll(sec, (3, -2), (0, 1)),
                           torch.zeros(2, 1, 10, 10, device=dev), cfg)
  assert _build.launch_counts['fused_fire'] == before


@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic', 'lanczos'])
def test_warp_gather(dev, method):
  rng = np.random.RandomState(1)
  img = torch.from_numpy((rng.rand(1, 300, 500) * 255).astype(np.float32))
  yy, xx = torch.meshgrid(torch.arange(300.), torch.arange(500.),
                          indexing='ij')
  coords = torch.stack([yy + 100.3 + 2 * torch.sin(xx / 30),
                        xx - 97.6 + 2 * torch.cos(yy / 25)])[None]
  coords[0, :, 5, 7] = float('nan')
  got = cuda_warp.shift_warp(img.to(dev), coords.contiguous().to(dev), method)
  ref = cuda_warp.shift_warp(img, coords, method)
  assert float((got.cpu() - ref).abs().max()) < 1e-2
  assert float(got[0, 5, 7]) == 0.0


def test_wrong_device_or_dtype_raises(dev):
  img = torch.zeros(1, 64, 64, device=dev, dtype=torch.float64)
  with pytest.raises(TypeError):
    cuda_warp.shift_warp(img, torch.zeros(1, 2, 8, 8, device=dev,
                                          dtype=torch.float64))
  with pytest.raises(ValueError):
    cuda_warp.shift_warp(torch.zeros(1, 64, 64, device=dev),
                         torch.zeros(1, 2, 8, 8))
