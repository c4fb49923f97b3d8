"""sofima_tpu_torch's CUDA kernels against their plain versions (GPU only).

Marked `gpu`: each test skips where torch finds no CUDA device (decided
inside the fixture, never at import). Run on a machine with a card:

    python -m pytest tests/test_torch_gpu.py -m gpu

Tolerances: integer flow peaks and NaN placement exact, sharpness /
ratio rtol = atol = 3e-4 on these well-conditioned inputs (K1 / K2 on
both routes with post patches off the image: for 99.8% of them, K5 for
99%, with every clean-gate decision equal: near masked regions and empty
patches the statistics divide by correlation values close to 0); fused
solver steps equal and nodes within 1e-3 px (2d and 3d), as the staged
2d solver with K8; 2d and 3d forces within 1e-4, K8 repeating bit for bit;
renders (2d and 3d) within 1e-2 gray levels, K4 and K13 from staged
and from direct tiles; K7's surfaces within 1e-3
of each surface's largest value and repeating bit for bit, K6's peaks as
K1's (square and rectangular patches, on the FFT route and the dense-DFT
route, repeating bit for bit), the rectangular dense flow and the
padfield calculator
(integer peaks exact, 99% of the statistics within 3e-4: sharpness
divides by correlation values close to 0, as for K5, and summation
order moves it there, with every clean-gate decision equal),
`warp_subvolume` and 2d `ndimage_warp` within 1 gray level on at most
1e-3 of the pixels of the CPU's; the small 3d stitch, the
small 2d montage and the drift-removal stack step on the card within
0.01 * stride of the CPU plain path (the montage canvas within 0.01 gray
levels in the mean and 0.05 at most where both masks are set). The
decorator layer's chunk functions against the same functions under
chip_smoke's `plain_kernels` (flows as K1's bar, meshes within 1e-2 px,
renders within 1e-3 of the gray range), ECC and phase correlation on the
card against the CPU (matrices within 1e-3, shifts exact), ECC's loop
under CUDA's sync debug mode (no call waits for the card) and a
checkpointed relaxation stopped, resumed and equal to one run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import mesh
from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.ops import cuda_flow
from sofima_tpu_torch.ops import cuda_mesh
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.pipeline import montage
from sofima_tpu_torch.pipeline import stack_align
from sofima_tpu_torch.pipeline import stitch3d

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


# K1/K2's bar where conditioning moves a few statistics (chip_smoke.py's
# STAT_FRACTION): integer peaks and NaN rows exact, this share of the
# statistics within rtol = atol = 3e-4, every clean-gate decision
# (|sharpness| >= 1.6, ratio 0 or >= 1.6) equal.
STAT_FRACTION = 0.998


def _flow_close(got, ref):
  torch.testing.assert_close(torch.nan_to_num(got[:2], nan=9e9),
                             torch.nan_to_num(ref[:2], nan=9e9), rtol=0,
                             atol=0)
  fin = torch.isfinite(ref[2:]) & torch.isfinite(got[2:])
  d = (got[2:] - ref[2:]).abs()[fin]
  frac = float((d <= 3e-4 + 3e-4 * ref[2:].abs()[fin]).float().mean())
  assert frac >= STAT_FRACTION, frac

  def gates(f):
    ratio = f[3].abs()
    return (f[2].abs() >= 1.6) & ((ratio == 0) | (ratio >= 1.6))

  assert torch.equal(gates(got), gates(ref))


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


# K1/K2's two routes, each against the plain version: the FFT route
# (p <= 168: here 160, 80 and 40, K2 with its post patches pushed up to
# 38 px off the image's top and 44 px off its right edge, wholly off it
# at p = 40) and the dense-DFT route (p = 192). Every call counts one
# launch under its entry; the dense route also under 'flow_peaks_dft'. A
# second call repeats the first bit for bit. The bar is `_flow_close`:
# sharpness divides by the surface's minimum around the peak, which can
# sit near 0 (one value of 288 was 8.7e-4 off on an H100 at p = 160, s =
# 40), so the step is at most 20 px and every case compares at least 800
# statistics, enough for the 0.998 share to admit one such value.
@pytest.mark.parametrize('kind,p,crop', [
    ('dense', 160, None), ('dense', 80, None), ('dense', 40, None),
    ('dense', 192, None), ('targeted', 80, 32), ('targeted', 80, None),
    ('targeted', 160, 32), ('targeted', 40, 16), ('targeted', 192, 32)])
def test_flow_peaks_routes(dev, kind, p, crop):
  n, s = 600, min(p // 4, 20)
  shift = (4, -6) if kind == 'dense' else (-35, 41)
  pre = torch.from_numpy(_texture(n, seed=11))
  post = torch.roll(pre, shift, (0, 1)).contiguous()
  if kind == 'dense':
    entry = 'dense_flow_peaks'
    call = lambda a, b, o: cuda_flow.dense_flow_peaks(a, b, (p, p), (s, s))
    offs = None
  else:
    entry = 'targeted_flow_peaks'
    geo = cuda_flow.targeted_geometry((n, n), (p, p), (s, s))
    rng = np.random.RandomState(1)
    jitter = rng.randint(-3, 4, size=(geo['nrsteps'], geo['ngroups'], 2))
    offs = torch.from_numpy((jitter + list(shift)).astype(np.int32))
    call = lambda a, b, o: cuda_flow.dense_flow_peaks_targeted(
        a, b, o, (p, p), (s, s), max_offset=48, peak_crop=crop)
  cuda = lambda: call(pre.to(dev), post.to(dev),
                      None if offs is None else offs.to(dev))
  before = dict(_build.launch_counts)
  got = cuda()
  launched = {k: _build.launch_counts[k] - before[k]
              for k in (entry, 'flow_peaks_dft')}
  assert launched == {entry: 1, 'flow_peaks_dft': int(p > 168)}
  again = cuda()
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  ref = call(pre, post, offs)
  _flow_close(got.cpu(), ref)
  assert torch.isfinite(ref[:2]).any()


def _bench_like_mask(n):
  """bench.py's crack band + blob mask, scaled to n, and a dead corner."""
  yy, xx = np.mgrid[:n, :n]
  mask = (((yy + xx) % 797 < 45)
          | (((yy - n // 2) ** 2 + (xx - n // 3) ** 2) < (n // 8) ** 2))
  mask[:240, -240:] = True
  return torch.from_numpy(mask)


def _masked_equal(got, ref):
  torch.testing.assert_close(torch.nan_to_num(got[:2], nan=9e9),
                             torch.nan_to_num(ref[:2], nan=9e9), rtol=0,
                             atol=0)
  fin = torch.isfinite(ref[2:]) & torch.isfinite(got[2:])
  d = (got[2:] - ref[2:]).abs()[fin]
  assert float((d <= 3e-4 + 3e-4 * ref[2:].abs()[fin]).float().mean()) >= 0.99
  for ch in (2, 3):
    assert torch.equal(torch.nan_to_num(got[ch].abs()) >= 1.6,
                       torch.nan_to_num(ref[ch].abs()) >= 1.6)


@pytest.mark.parametrize('p,s', [(160, 40), (160, 160), (80, 40)])
def test_masked_flow_peaks(dev, p, s):
  n = 720
  pre = torch.from_numpy(_texture(n, seed=5))
  post = torch.roll(pre, (5, -3), (0, 1)).contiguous()
  valid = ~_bench_like_mask(n)
  cls = cuda_flow.masked_patch_classes(valid, valid, p, (s, s))
  assert set(cls.unique().tolist()) == {0, 1, 2}
  args = (pre.to(dev), post.to(dev), valid.to(dev), valid.to(dev), (p, p),
          (s, s))
  before = dict(_build.launch_counts)
  got = cuda_flow.masked_dense_flow_peaks(*args)
  assert _build.launch_counts['masked_flow_peaks'] == (
      before['masked_flow_peaks'] + 1)
  assert _build.launch_counts['masked_flow_pure'] == (
      before['masked_flow_pure'] + 1)
  again = cuda_flow.masked_dense_flow_peaks(*args)
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  ref = cuda_flow.masked_dense_flow_peaks(pre, post, valid, valid, (p, p),
                                          (s, s))
  _masked_equal(got.cpu(), ref)
  assert torch.isnan(got[0].cpu()[cls == 2]).all()


# Grids of one class each (K5's three lists, each alone) at both K5 patch
# sizes: all pure (the shared-memory FFT route), all impure (the dense
# route; a thin invalid lattice puts invalid pixels in every patch) and
# all dead (no launch, NaN rows). An odd p takes the pure route's scalar
# loads; pure pairs above p = 160 take the dense route's closed form.
@pytest.mark.parametrize('kind,p', [(k, p) for p in (80, 160)
                                    for k in ('pure', 'impure', 'dead')]
                         + [('pure', 81), ('pure', 192)])
def test_masked_flow_routes(dev, kind, p):
  n = 600
  pre = torch.from_numpy(_texture(n, seed=6))
  post = torch.roll(pre, (-4, 7), (0, 1)).contiguous()
  valid = torch.ones((n, n), dtype=torch.bool)
  if kind == 'impure':
    valid[::37] = False
    valid[:, ::41] = False
  elif kind == 'dead':
    valid[:] = False
  cls = cuda_flow.masked_patch_classes(valid, valid, p, (40, 40))
  assert set(cls.unique().tolist()) == {{'pure': 1, 'impure': 0,
                                         'dead': 2}[kind]}
  args = (pre.to(dev), post.to(dev), valid.to(dev), valid.to(dev), (p, p),
          (40, 40))
  before = dict(_build.launch_counts)
  got = cuda_flow.masked_dense_flow_peaks(*args)
  launched = {k: _build.launch_counts[k] - before[k]
              for k in ('masked_flow_peaks', 'masked_flow_pure')}
  fft = kind == 'pure' and p <= 160
  assert launched == {'masked_flow_peaks': int(kind != 'dead' and not fft),
                      'masked_flow_pure': int(fft)}
  again = cuda_flow.masked_dense_flow_peaks(*args)
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  ref = cuda_flow.masked_flow_peaks_plain(
      pre, post, valid.float(), valid.float(), tuple(cls.shape), p, (40, 40),
      None, 2, 0.5, 5)
  if kind == 'dead':
    assert torch.isnan(got).all() and torch.isnan(ref).all()
  else:
    _masked_equal(got.cpu(), ref)
    assert torch.isfinite(got[:2]).any()


def test_masked_coarse_to_fine(dev):
  n = 800
  pre = torch.from_numpy(_texture(n, seed=6))
  post = torch.roll(pre, (23, -31), (0, 1)).contiguous()
  mask = _bench_like_mask(n)
  _build.reset_launch_counts()
  got, ov = flow_field.coarse_to_fine_flow(
      pre.to(dev), post.to(dev), pre_mask=mask.to(dev),
      post_mask=mask.to(dev), return_overflow=True)
  # Each pass launches both routes: pure and impure pairs on both grids.
  assert _build.launch_counts['masked_flow_peaks'] == 2
  assert _build.launch_counts['masked_flow_pure'] == 2
  assert _build.launch_counts['warp_gather'] == 2
  ref, ov_ref = flow_field.coarse_to_fine_flow(
      pre, post, pre_mask=mask, post_mask=mask, return_overflow=True)
  assert bool(ov) == bool(ov_ref) is False
  _masked_equal(got.cpu(), ref)


def test_warm_start_refresh(dev):
  # A 52/-48 px jump at pair 1 makes pair 0's flow a stale prior: the
  # refresh re-measures pair 1 cold (K1 for pairs 0 and 1; K2 for pair
  # 0, warm pair 1 and its refresh) and lands on the cold chain.
  n = 640
  base = torch.from_numpy(_texture(n, seed=0))
  yy, xx = torch.meshgrid(torch.arange(n, dtype=torch.float32),
                          torch.arange(n, dtype=torch.float32), indexing='ij')

  def shifted(dy, dx):
    coords = torch.stack([yy + dy, xx + dx])[None]
    return cuda_warp.shift_warp(base[None], coords, 'linear')[0]

  stack = torch.stack([base, shifted(2.0, -3.0), shifted(54.0, -51.0)])
  stack = torch.clamp(stack + 0.5, 0, 255).to(torch.uint8).to(dev)
  cfg = stack_align.StackAlignConfig(max_displacement=96, residual=16)
  _, cold, _ = stack_align.align_stack_pipelined(stack, cfg)
  _build.reset_launch_counts()
  _, warm, _ = stack_align.align_stack_pipelined(
      stack, dataclasses.replace(cfg, warm_start=True))
  assert _build.launch_counts['dense_flow_peaks'] == 2
  assert _build.launch_counts['targeted_flow_peaks'] == 3
  assert float((warm - cold).abs().max()) < 0.4


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


# Meshes K3 and K11's plans give 2-16 nodes a thread (two blocks an SM
# on an H100), with a NaN row on a tile edge and no `prev`.
@pytest.mark.parametrize('shape, npt', [
    ((301, 283), 2), ((97, 1500), 4), ((700, 650), 8), ((768, 1024), 16),
    ((6, 99, 151), 2), ((8, 128, 256), 4)])
def test_fused_fire_plans(dev, shape, npt):
  dim = len(shape) if len(shape) == 3 else 2
  rng = np.random.RandomState(npt)
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
      num_iters=100, max_iters=300, stop_v_max=0.0, dt_max=100.0,
      prefer_orig_order=dim == 2)
  x = rng.randn(dim, *shape).astype(np.float32) * 3
  plan = cuda_mesh.fire_plan_of(torch.from_numpy(x).to(dev), cfg)
  assert plan.npt == npt
  if dim == 2:
    x[:, plan.tile[1]] = np.nan
    fused = lambda t: cuda_mesh.relax_mesh_fused(t[:, None], None, cfg)
    plain = cuda_mesh.relax_mesh_fused_plain
  else:
    x[:, shape[0] // 2, plan.tile[1]] = np.nan
    fused = lambda t: cuda_mesh.relax_mesh_fused_3d(t, None, cfg)
    plain = cuda_mesh.relax_mesh_fused_3d_plain
  xt = torch.from_numpy(x).to(dev)
  got, _, steps = fused(xt)
  again = fused(xt)[0]
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  got = got[:, 0] if dim == 2 else got
  ref, _, steps_ref = plain(xt, None, cfg)
  assert int(steps) == int(steps_ref)
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert bool(torch.isnan(got).any())
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 1e-3


def test_align_step_drift_removal(dev):
  # Drift removal takes the staged solver: K8 at every force evaluation,
  # no K3; the mesh lands on the CPU plain path's.
  cfg = stack_align.StackAlignConfig()
  cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
      cfg.mesh, remove_drift=True))
  sec = torch.from_numpy(_texture(400))
  nxt = torch.roll(sec, (3, -2), (0, 1)).contiguous()
  _build.reset_launch_counts()
  got, rendered, _ = stack_align.align_step(
      sec.to(dev), nxt.to(dev), torch.zeros(2, 1, 10, 10, device=dev), cfg)
  assert _build.launch_counts['force2d'] > 0
  assert _build.launch_counts['fused_fire'] == 0
  ref, _, _ = stack_align.align_step(sec, nxt, torch.zeros(2, 1, 10, 10),
                                     cfg)
  got = got.cpu()
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 0.4
  assert bool(torch.isfinite(rendered).all())


def _force_input(shape=(2, 3, 37, 70), seed=7):
  rng = np.random.RandomState(seed)
  x = torch.from_numpy((rng.randn(*shape) * 5).astype(np.float32))
  x[:, 0, 4, 9] = float('nan')
  x[:, -1, 30:33, 0] = float('nan')
  x[:, -1, -1, -2:] = float('nan')
  # A zero-length link: node (10, 11) sits on node (10, 12).
  x[:, 1 % shape[1], 10, 12] = torch.tensor([2.0, -3.0])
  x[:, 1 % shape[1], 10, 11] = torch.tensor([42.0, -3.0])
  return x


# K8's two load paths: scalar loads where nx is not a multiple of 4 (70,
# 13), 16-byte loads where it is (516: a second x tile of 4 nodes, several
# bands of rows); batches of 1-5 meshes.
@pytest.mark.parametrize('prefer', [False, True])
@pytest.mark.parametrize('shape', [(2, 3, 37, 70), (2, 1, 300, 516),
                                   (2, 5, 19, 13)])
def test_force_2d(dev, shape, prefer):
  x = _force_input(shape)
  before = _build.launch_counts['force2d']
  got = mesh.inplane_force(x.to(dev), 0.1, (40.0, 30.0), prefer)
  assert _build.launch_counts['force2d'] == before + 1
  again = mesh.inplane_force(x.to(dev), 0.1, (40.0, 30.0), prefer)
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  ref = mesh.inplane_force(x, 0.1, (40.0, 30.0), prefer)
  assert bool(torch.isfinite(got).all())
  assert float((got.cpu() - ref).abs().max()) < 1e-4


@pytest.mark.parametrize('shape', [(2, 2, 24, 30), (2, 3, 19, 517)])
def test_relax_mesh_2d(dev, shape):
  # The staged solver with K8 on the card against the CPU plain path.
  rng = np.random.RandomState(8)
  x = torch.from_numpy((rng.randn(*shape) * 2).astype(np.float32))
  x[:, 1, 3:5, 6] = float('nan')
  prev = torch.nan_to_num(x) * 0.5
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
      num_iters=200, max_iters=2000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=1.0, cap_scale=1.5, prefer_orig_order=True)
  before = _build.launch_counts['force2d']
  got, _, steps = mesh.relax_mesh(x.to(dev), prev.to(dev), cfg)
  assert _build.launch_counts['force2d'] - before == steps + steps // 200
  ref, _, steps_ref = mesh.relax_mesh(x, prev, cfg)
  assert steps == steps_ref
  got = got.cpu()
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 1e-3


def test_montage_small(dev):
  # tests/test_torch_montage.py's geometry on the card against the CPU.
  rng = np.random.RandomState(3)
  f = np.fft.rfft2(rng.rand(260, 260).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(260)[None, :] ** 2
                 + np.fft.fftfreq(260)[:, None] ** 2) / (2 * 0.1 ** 2)))
  img = np.fft.irfft2(f, s=(260, 260))
  img = ((img - img.min()) / np.ptp(img) * 255).astype(np.uint8)
  tiles = {(tx, ty): img[ty * 100:ty * 100 + 160, tx * 100:tx * 100 + 160]
           for ty in range(2) for tx in range(2)}
  cfg = montage.MontageConfig(
      stride=20, patch_size=40, coarse_overlaps=(65, 75), min_overlap=10,
      margin=4, flow_batch=16, mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(20.0, 20.0),
          num_iters=400, max_iters=20000, stop_v_max=0.005, dt_max=100.0))
  _build.reset_launch_counts()
  got = montage.montage_align_2d(tiles, (2, 2), cfg)
  for k in ('dense_flow_peaks', 'force2d', 'warp_gather'):
    assert _build.launch_counts[k] > 0, k
  assert _build.launch_counts['warp_gather'] == 4
  ref = montage.montage_align_2d(tiles, (2, 2), cfg, device='cpu')
  np.testing.assert_array_equal(got['cx'], ref['cx'])
  np.testing.assert_array_equal(got['cy'], ref['cy'])
  solved = got['solved'].cpu()
  assert float(torch.nan_to_num((solved - ref['solved']).abs()).max()) < 0.2
  both = got['mask'].cpu() & ref['mask']
  d = (got['canvas'].cpu() - ref['canvas']).abs()[both]
  assert float(both.float().mean()) > 0.5
  assert float(d.mean()) < 0.01 and float(d.max()) < 0.05


# A smooth field stages every tile's source window in shared memory; a
# field of random positions gathers every tile from global memory.
@pytest.mark.parametrize('field', ['smooth', 'random'])
@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic', 'lanczos'])
def test_warp_gather(dev, method, field):
  rng = np.random.RandomState(1)
  img = torch.from_numpy((rng.rand(1, 300, 500) * 255).astype(np.float32))
  yy, xx = torch.meshgrid(torch.arange(300.), torch.arange(500.),
                          indexing='ij')
  if field == 'smooth':
    coords = torch.stack([yy + 100.3 + 2 * torch.sin(xx / 30),
                          xx - 97.6 + 2 * torch.cos(yy / 25)])[None]
  else:
    coords = torch.from_numpy(
        (rng.rand(1, 2, 300, 500) * [[[320.0]], [[520.0]]] - 10.0).astype(
            np.float32))
  coords[0, :, 5, 7] = float('nan')
  stats = torch.zeros(2, dtype=torch.int32, device=dev)
  before = _build.launch_counts['warp_gather']
  got = cuda_warp.shift_warp(img.to(dev), coords.contiguous().to(dev), method,
                             tile_stats=stats)
  assert _build.launch_counts['warp_gather'] == before + 1
  ref = cuda_warp.shift_warp(img, coords, method)
  assert float((got.cpu() - ref).abs().max()) < 1e-2
  assert float(got[0, 5, 7]) == 0.0
  staged, tiles = stats.tolist()
  if field == 'overrun':
    assert tiles >= staged
  else:
    assert tiles > 0 and staged == (tiles if field == 'smooth' else 0)


def test_wrong_device_or_dtype_raises(dev):
  img = torch.zeros(1, 64, 64, device=dev, dtype=torch.float64)
  with pytest.raises(TypeError):
    cuda_warp.shift_warp(img, torch.zeros(1, 2, 8, 8, device=dev,
                                          dtype=torch.float64))
  with pytest.raises(ValueError):
    cuda_warp.shift_warp(torch.zeros(1, 64, 64, device=dev),
                         torch.zeros(1, 2, 8, 8))


@pytest.mark.parametrize('prefer', [False, True])
def test_force_3d(dev, prefer):
  rng = np.random.RandomState(4)
  x = torch.from_numpy((rng.randn(3, 2, 5, 20, 24) * 5).astype(np.float32))
  x[:, 0, 1, 3:5, 7] = float('nan')
  before = _build.launch_counts['force3d']
  got = mesh.elastic_mesh_3d(x.to(dev), 0.1, (40.0, 30.0, 20.0), prefer)
  assert _build.launch_counts['force3d'] == before + 1
  ref = mesh.elastic_mesh_3d(x, 0.1, (40.0, 30.0, 20.0), prefer)
  assert float((got.cpu() - ref).abs().max()) < 1e-4


# K9 on path (a)'s tile meshes, an odd mesh (no side a multiple of a
# tile), a batch of meshes with an anisotropic stride, and an odd mesh
# large enough for 16-row tiles; NaN holes on tile edges (rows 7 / 8,
# columns 127 / 128) and inside.
@pytest.mark.parametrize('shape, stride', [
    ((3, 4, 4, 36, 36), (16.0, 16.0, 16.0)),
    ((3, 2, 5, 37, 71), (40.0, 40.0, 40.0)),
    ((3, 3, 6, 20, 136), (40.0, 30.0, 20.0)),
    ((3, 1, 3, 300, 1100), (40.0, 40.0, 40.0))])
@pytest.mark.parametrize('prefer', [False, True])
def test_force_3d_shapes(dev, shape, stride, prefer):
  rng = np.random.RandomState(sum(shape))
  x = torch.from_numpy((rng.randn(*shape) * 5).astype(np.float32))
  ny, nx = shape[-2:]
  x[:, 0, 1, min(7, ny - 1), 3] = float('nan')
  x[:, -1, -1, min(8, ny - 1), min(127, nx - 1)] = float('nan')
  x[:, 0, 0, 0, min(128, nx - 1)] = float('nan')
  x = x.to(dev)
  before = _build.launch_counts['force3d']
  got = mesh.elastic_mesh_3d(x, 0.1, stride, prefer)
  assert _build.launch_counts['force3d'] == before + 1
  ref = mesh.elastic_mesh_3d_plain(x, 0.1, stride, prefer)
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert bool(torch.isfinite(got).all())
  assert float((got - ref).abs().max()) < 1e-4
  again = mesh.elastic_mesh_3d(x, 0.1, stride, prefer)
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))


# A subset of the springs, some links given in their negative form.
@pytest.mark.parametrize('links', [
    ((1, 0, 0), (0, 1, 0), (1, 1, 1), (0, 1, -1)),
    ((-1, 0, 0), (0, -1, 1), (1, 1, 1), (0, 0, -1), (1, -1, 1))])
def test_force_3d_links(dev, links):
  rng = np.random.RandomState(len(links))
  x = torch.from_numpy((rng.randn(3, 2, 5, 20, 150) * 5).astype(np.float32))
  x[:, 1, 2, 7, 127] = float('nan')
  x = x.to(dev)
  for prefer in (False, True):
    got = mesh.elastic_mesh_3d(x, 0.1, (40.0, 30.0, 20.0), prefer,
                               links=links)
    ref = mesh.elastic_mesh_3d_plain(x, 0.1, (40.0, 30.0, 20.0), prefer,
                                     links)
    assert float((got - ref).abs().max()) < 1e-4


# K3 / K11's grid-stride route, forced on small meshes (as if no tiling
# fit the card), against the plain solvers.
@pytest.mark.parametrize('shape', [(37, 71), (5, 37, 71)])
def test_fused_fire_grid_route(dev, shape, monkeypatch):
  monkeypatch.setattr(cuda_mesh, '_fire_route_on', lambda *a: None)
  dim = len(shape) if len(shape) == 3 else 2
  rng = np.random.RandomState(dim)
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0,) * dim,
      num_iters=100, max_iters=1000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1,
      prefer_orig_order=dim == 2)
  x = torch.zeros(dim, *shape)
  prev = torch.from_numpy(rng.randn(dim, *shape).astype(np.float32) * 3)
  prev[:, ..., 7, :] = float('nan')
  x, prev = x.to(dev), prev.to(dev)
  before = _build.launch_counts['fused_fire_grid']
  if dim == 2:
    got, _, steps = cuda_mesh.relax_mesh_fused(x[:, None], prev[:, None],
                                               cfg)
    got = got[:, 0]
    ref, _, steps_ref = cuda_mesh.relax_mesh_fused_plain(x, prev, cfg)
  else:
    got, _, steps = cuda_mesh.relax_mesh_fused_3d(x, prev, cfg)
    ref, _, steps_ref = cuda_mesh.relax_mesh_fused_3d_plain(x, prev, cfg)
  assert _build.launch_counts['fused_fire_grid'] == before + 1
  assert int(steps) == int(steps_ref)
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 1e-3


@pytest.mark.parametrize('prefer', [False, True])
def test_fused_fire_3d(dev, prefer):
  rng = np.random.RandomState(2)
  prev = np.full((3, 6, 20, 24), np.nan, np.float32)
  prev[:, 1:-1, 2:-2, 2:-2] = rng.randn(3, 4, 16, 20) * 3
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0, 30.0, 20.0),
      num_iters=100, max_iters=1000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1,
      prefer_orig_order=prefer)
  x0 = torch.zeros(prev.shape)
  pv = torch.from_numpy(prev)
  before = _build.launch_counts['fused_fire_3d']
  got, _, steps = cuda_mesh.relax_mesh_fused_3d(x0.to(dev), pv.to(dev), cfg)
  assert _build.launch_counts['fused_fire_3d'] == before + 1
  again = cuda_mesh.relax_mesh_fused_3d(x0.to(dev), pv.to(dev), cfg)[0]
  assert torch.equal(got.view(torch.int32), again.view(torch.int32))
  ref, _, steps_ref = cuda_mesh.relax_mesh_fused_3d(x0, pv, cfg)
  assert int(steps) == int(steps_ref)
  got = got.cpu()
  assert torch.equal(torch.isnan(got), torch.isnan(ref))
  assert float(torch.nan_to_num((got - ref).abs()).max()) < 1e-3


# Odd sizes, asymmetric bounds (some voxels' x taps leave their shift
# range) and a NaN voxel. A smooth field stages every block tile's brick
# in shared memory; random positions with wide bounds gather every tile
# from global memory; an overrun field (displacements up to 3.1 px
# against bounds of +-1 / +-2) leaves some voxels without a live tap on
# an axis, which render 0.
@pytest.mark.parametrize('field', ['smooth', 'random', 'overrun'])
@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic', 'lanczos'])
def test_warp_gather_3d(dev, method, field):
  rng = np.random.RandomState(1)
  if field == 'overrun':
    vol = torch.from_numpy((rng.rand(20, 40, 60) * 255).astype(np.float32))
    origin = (-2, -2, -2)
    zz, yy, xx = torch.meshgrid(torch.arange(24.) - 2, torch.arange(44.) - 2,
                                torch.arange(64.) - 2, indexing='ij')
  else:
    vol = torch.from_numpy((rng.rand(21, 37, 61) * 255).astype(np.float32))
    origin = (-1, -2, -3)
    zz, yy, xx = torch.meshgrid(torch.arange(23.) - 1, torch.arange(41.) - 2,
                                torch.arange(67.) - 3, indexing='ij')
  if field == 'overrun':
    coords = torch.stack([zz + 0.7 * torch.sin(yy / 7), yy + 2.3 * torch.cos(
        xx / 9) - 0.4, xx + 3.1 * torch.sin(zz / 5 + yy / 11) + 0.2])
    bounds = (-1, 1, -2, 2, -2, 2)
  elif field == 'smooth':
    coords = torch.stack([zz + 0.4 * torch.sin(yy / 13),
                          yy + 1.1 * torch.cos(xx / 17) - 0.3,
                          xx + 1.3 * torch.sin(zz / 9 + yy / 19) + 0.2])
    bounds = (-1, 2, -2, 1, -1, 2)
  else:
    coords = torch.from_numpy((rng.rand(3, 23, 41, 67) * np.array(
        [25.0, 41.0, 65.0])[:, None, None, None] - 2.0).astype(np.float32))
    bounds = (-30, 28, -50, 45, -70, 66)
  coords[:, 3, 4, 5] = float('nan')
  coords = coords.contiguous()
  stats = torch.zeros(2, dtype=torch.int32, device=dev)
  before = _build.launch_counts['warp_gather_3d']
  got = cuda_warp.shift_warp_3d(vol.to(dev), coords.to(dev), method,
                                *bounds, *origin, tile_stats=stats)
  assert _build.launch_counts['warp_gather_3d'] == before + 1
  # The plain version on the card: raw Lanczos weights near integer
  # displacements are ill-conditioned (the reference's hoisted form), so
  # the comparison needs the card's own sin.
  ref = cuda_warp.shift_warp_3d_plain(vol.to(dev), coords.to(dev), method,
                                      bounds, origin)
  assert float((got - ref).abs().max()) < 1e-2
  assert float(got[3, 4, 5]) == 0.0
  staged, tiles = stats.tolist()
  if field == 'overrun':
    assert tiles >= staged
  else:
    assert tiles > 0 and staged == (tiles if field == 'smooth' else 0)


def test_stitch3d_small(dev):
  rng = np.random.RandomState(3)
  f = np.fft.rfftn(rng.rand(24, 48, 80).astype(np.float32))
  fr = np.meshgrid(np.fft.fftfreq(24), np.fft.fftfreq(48),
                   np.fft.rfftfreq(80), indexing='ij')
  f *= np.exp(-sum(a ** 2 for a in fr) / (2 * 0.12 ** 2))
  vol = np.fft.irfftn(f, s=(24, 48, 80), axes=(0, 1, 2)).astype(np.float32)
  vol = (vol - vol.min()) / np.ptp(vol) * 255
  tiles = {(0, 0): vol[:, :, :48].copy(), (1, 0): vol[:, :, 32:].copy()}
  cx = np.full((3, 1, 1, 2), np.nan)
  cx[:, 0, 0, 0] = (-16, 0, 0)
  cy = np.full((3, 1, 1, 2), np.nan)
  coarse = np.zeros((3, 1, 1, 2), np.float32)
  coarse[0, 0, 0, 1] = -16
  cfg = stitch3d.Stitch3dConfig(
      stride=(8, 8, 8), patch_size=(16, 16, 16), flow_batch=8, margin=2,
      mesh_cfg=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(8, 8, 8),
          num_iters=200, max_iters=5000, stop_v_max=0.01, dt_max=100.0))
  _build.reset_launch_counts()
  got = stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg)
  assert got['canvas'].device.type == 'cuda'
  assert _build.launch_counts['force3d'] > 0
  assert _build.launch_counts['warp_gather_3d'] == 2
  ref = stitch3d.stitch_and_render_3d(tiles, cx, cy, coarse, cfg,
                                      device='cpu')
  assert float((got['solved'].cpu() - ref['solved']).abs().max()) < 0.08


def _patch_batch(shape, seed):
  """[n, p1, p2] patch pairs cut from a texture: post is pre shifted."""
  n, p1, p2 = shape
  tex = _texture(max(4 * p1, 4 * p2, 256), seed=seed)
  rng = np.random.RandomState(seed)
  ys = rng.randint(16, tex.shape[0] - p1 - 16, size=n)
  xs = rng.randint(16, tex.shape[1] - p2 - 16, size=n)
  a = np.stack([tex[y:y + p1, x:x + p2] for y, x in zip(ys, xs)])
  b = np.stack([tex[y - 3:y - 3 + p1, x + 5:x + 5 + p2]
                for y, x in zip(ys, xs)])
  return torch.from_numpy(a), torch.from_numpy(b)


# K7: shared memory up to 160^2 (a prime, rectangular 31 x 37 included),
# global scratch at 256^2. K6: the FFT route up to 160^2 (160 x 80 and 80
# x 160, the strip path's shape both ways, and 31 x 37), the dense-DFT
# route at 256^2, each counted under its own counter; a second K6 call
# repeats the first bit for bit.
@pytest.mark.parametrize('shape,k6_route', [
    ((37, 32, 32), 'fft'), ((29, 24, 40), 'fft'), ((11, 160, 160), 'fft'),
    ((9, 160, 80), 'fft'), ((9, 80, 160), 'fft'), ((5, 31, 37), 'fft'),
    ((3, 256, 256), 'dft')])
def test_patch_corr_kernels(dev, shape, k6_route):
  a, b = _patch_batch(shape, seed=7)
  before = dict(_build.launch_counts)
  got = cuda_flow.corr_patches(a.to(dev), b.to(dev))
  rep = cuda_flow.corr_patches(a.to(dev), b.to(dev))
  ref = cuda_flow.corr_patches(a, b)
  scale = ref.abs().amax(dim=(1, 2), keepdim=True)
  assert float(((got.cpu() - ref).abs() / scale).max()) < 1e-3
  assert torch.equal(got, rep)
  assert _build.launch_counts['corr_patches'] == before['corr_patches'] + 2
  before = dict(_build.launch_counts)
  peaks = cuda_flow.flow_peaks(a.to(dev), b.to(dev))
  counted = {k: _build.launch_counts[k] - before[k]
             for k in ('patch_flow_peaks', 'patch_flow_peaks_dft')}
  assert counted == {'patch_flow_peaks': int(k6_route == 'fft'),
                     'patch_flow_peaks_dft': int(k6_route == 'dft')}
  again = cuda_flow.flow_peaks(a.to(dev), b.to(dev))
  assert torch.equal(peaks.view(torch.int32), again.view(torch.int32))
  ref_p = cuda_flow.flow_peaks(a, b)
  _masked_equal(peaks.cpu().T, ref_p.T)
  # b[t] = a[t + (-3, 5)]: the flow (x, y) is (5, -3) on most pairs.
  assert ref_p[:, 0].median() == 5 and ref_p[:, 1].median() == -3


def test_rectangular_dense_flow(dev):
  pre = torch.from_numpy(_texture(600, seed=8)[:520].copy())
  post = torch.roll(pre, (4, -6), (0, 1)).contiguous()
  for patch, step in (((160, 80), (40, 40)), ((96, 64), (40, 40))):
    got = flow_field.dense_flow_field(pre.to(dev), post.to(dev), patch, step,
                                      batch_size=256, circular=True)
    ref = flow_field.dense_flow_field(pre, post, patch, step, batch_size=256,
                                      circular=True)
    _masked_equal(got.cpu(), ref)


def test_padfield_calculator(dev):
  pre = _texture(400, seed=9)
  post = np.roll(pre, (6, -4), (0, 1))
  mask = np.zeros(pre.shape, bool)
  mask[150:190, 40:360] = True
  for kw in (dict(), dict(pre_mask=mask, post_mask=mask, batch_size=13)):
    got = flow_field.JAXMaskedXCorrWithStatsCalculator().flow_field(
        pre, post, 96, 32, **kw)
    ref = flow_field.JAXMaskedXCorrWithStatsCalculator(
        device='cpu').flow_field(pre, post, 96, 32, **kw)
    _masked_equal(torch.from_numpy(got), torch.from_numpy(ref))


def test_warp_subvolume_matches_cpu(dev):
  from sofima_tpu_torch import warp
  from sofima_tpu_torch.utils.bounding_box import BoundingBox
  n, s = 320, 20
  img = np.clip(_texture(n, seed=10), 0, 255).astype(np.uint8)[None, None]
  yy, xx = np.mgrid[:17, :17].astype(np.float32)
  cmap = np.stack([3 * np.sin(yy / 3.0), 2 * np.cos(xx / 4.0) - 1])[:, None]
  box = BoundingBox(start=(0, 0, 0), size=(n, n, 1))
  mbox = BoundingBox(start=(0, 0, 0), size=(17, 17, 1))
  before = _build.launch_counts['warp_subvolume']
  got = warp.warp_subvolume(img, box, cmap, mbox, s, box)
  assert _build.launch_counts['warp_subvolume'] == before + 1
  ref = warp.warp_subvolume(img, box, cmap, mbox, s, box, device='cpu')
  d = np.abs(got.astype(int) - ref.astype(int))
  assert d.max() <= 1 and (d > 0).mean() <= 1e-3
  before = _build.launch_counts['ndimage_warp']
  got = warp.ndimage_warp(img[0, 0], cmap[:, 0], (s, s), (128, 128), (16, 16))
  assert _build.launch_counts['ndimage_warp'] > before
  ref = warp.ndimage_warp(img[0, 0], cmap[:, 0], (s, s), (128, 128), (16, 16),
                          device='cpu')
  d = np.abs(got.astype(int) - ref.astype(int))
  assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# Per-axis peak windows (min_distance=(1, 3), peak_radius=(4, 2)): K1 on
# both routes, K2, K5 on both routes and K6 on both routes against their
# plain versions (the kernels take the windows; nothing routes a sequence
# to the plain version: each call counts its launch), and a sequence of
# equal entries repeating the scalar call bit for bit on the card.
@pytest.mark.parametrize('kernel', ['K1', 'K1-dft', 'K2', 'K5', 'K5-pure',
                                    'K6', 'K6-dft'])
def test_per_axis_windows(dev, kernel):
  win = dict(min_distance=(1, 3), peak_radius=(4, 2))
  same = dict(min_distance=(2, 2), peak_radius=(5, 5))
  pre = torch.from_numpy(_texture(600, seed=12))
  post = torch.roll(pre, (5, -7), (0, 1)).contiguous()
  valid = ~_bench_like_mask(600)
  if kernel in ('K1', 'K1-dft'):
    p = 160 if kernel == 'K1' else 192
    entry = 'dense_flow_peaks'
    call = lambda a, b, **kw: cuda_flow.dense_flow_peaks(a, b, (p, p),
                                                         (20, 20), **kw)
  elif kernel == 'K2':
    entry = 'targeted_flow_peaks'
    geo = cuda_flow.targeted_geometry((600, 600), (80, 80), (20, 20))
    offs = torch.full((geo['nrsteps'], geo['ngroups'], 2), 0,
                      dtype=torch.int32) + torch.tensor([5, -7],
                                                        dtype=torch.int32)
    call = lambda a, b, **kw: cuda_flow.dense_flow_peaks_targeted(
        a, b, offs.to(a.device), (80, 80), (20, 20), max_offset=16,
        peak_crop=32, **kw)
  elif kernel in ('K5', 'K5-pure'):
    entry = 'masked_flow_peaks' if kernel == 'K5' else 'masked_flow_pure'
    v = valid if kernel == 'K5' else torch.ones_like(valid)
    call = lambda a, b, **kw: cuda_flow.masked_dense_flow_peaks(
        a, b, v.to(a.device), v.to(a.device), (80, 80), (40, 40), **kw)
  else:
    shape = (64, 160, 80) if kernel == 'K6' else (4, 256, 256)
    entry = 'patch_flow_peaks' if kernel == 'K6' else 'patch_flow_peaks_dft'
    pre, post = _patch_batch(shape, seed=13)
    call = lambda a, b, **kw: cuda_flow.flow_peaks(a, b, **kw).T
  before = _build.launch_counts[entry]
  got = call(pre.to(dev), post.to(dev), **win)
  assert _build.launch_counts[entry] == before + 1
  ref = call(pre, post, **win)
  (_flow_close if kernel[:2] in ('K1', 'K2') else _masked_equal)(got.cpu(),
                                                                 ref)
  assert torch.isfinite(ref[:2]).any()
  scalar = call(pre.to(dev), post.to(dev))
  equal = call(pre.to(dev), post.to(dev), **same)
  assert torch.equal(scalar.view(torch.int32), equal.view(torch.int32))


# The processor runner with four threads: every work item launches K1
# once per section pair, and the counts of a threaded run equal a
# sequential run's (ops._build.count is exact under threads); the flows
# are equal bit for bit.
def test_runner_threads_count_launches(dev):
  from sofima_tpu_torch.processor import flow as flow_proc
  from sofima_tpu_torch.processor import runner
  from sofima_tpu_torch.processor.defaults import em_2d
  from sofima_tpu_torch.utils.volume import InMemoryVolume
  tex = _texture(1200, seed=14)
  stack = np.stack([np.roll(tex, (z, -2 * z), (0, 1)) for z in range(3)])
  cfg = em_2d.estimate_flow_config({'patch_size': 80, 'stride': 40})
  outs, counts = [], []
  for parallelism in (1, 4):
    vol = InMemoryVolume(stack[None].astype(np.float32), fill_value=0.0)
    _build.reset_launch_counts()
    outs.append(runner.process_volume(flow_proc.EstimateFlow(cfg, device=dev),
                                      vol, subvolume_size=(320, 320, 3),
                                      parallelism=parallelism).data)
    counts.append(_build.launch_counts['dense_flow_peaks'])
  boxes = counts[0] // 2
  assert boxes >= 16 and counts == [2 * boxes, 2 * boxes]
  np.testing.assert_array_equal(np.nan_to_num(outs[0], nan=9e9),
                                np.nan_to_num(outs[1], nan=9e9))


# -- The decorator layer (path (i)): each chunk function on the card
# against the same function under chip_smoke.plain_kernels() (every kernel
# swapped for its plain version on the card's tensors): flows as K1's bar,
# meshes within 1e-2 px, renders within 1e-3 of the gray range.


def _plain_kernels():
  import chip_smoke  # the repository root, where the tests are run from
  return chip_smoke.plain_kernels()


def _warped_pair(n, amp=4.0, seed=15):
  """[x, y] texture and its copy moved by a smooth `amp` px field."""
  from sofima_tpu_torch.ops import interp
  tex = torch.from_numpy(_texture(n, seed)).float()
  r = torch.arange(n, dtype=torch.float32)
  y, x = r[:, None], r[None, :]
  coords = torch.stack([
      y + amp * torch.cos(2 * np.pi * x / n) * torch.sin(np.pi * y / n),
      x + amp * torch.sin(2 * np.pi * y / n) * torch.cos(np.pi * x / n)])
  moved = interp.sample(tex, coords, 'linear', mode='nearest')
  return tex.numpy().T.copy(), moved.numpy().T.copy()


def _chunk(name, dev):
  """Runs path (i)'s chunk `name` on `dev` -> (numpy result, launch
  counter that it must advance)."""
  from sofima_tpu_torch.decorators import flow as dflow
  from sofima_tpu_torch.decorators import warp as dwarp
  if name in ('flow_circular', 'flow_masked'):
    # 1280^2: 32^2 nodes, enough for the statistics' share bar to allow
    # the few that summation order moves (at 640^2, 16^2 nodes, one
    # statistic of ~340 outside 3e-4 already fails it).
    fix, mov = _warped_pair(1280)
    kw = dict(patch_zyx=(160, 160), step_zyx=(40, 40), batch_size=256,
              mode='circular_dft', device=dev)
    if name == 'flow_masked':
      m = np.zeros(fix.shape, bool)
      m[100:260, 300:380] = True
      m[700:900, 500:1100] = True
      kw.update(input_mask=m, fixed_mask=m[::-1].copy())
    return dflow._optim_flow(mov, fix, **kw), (
        'dense_flow_peaks' if name == 'flow_circular' else 'masked_flow_pure')
  if name in ('relax_2d', 'relax_3d'):
    rng = np.random.RandomState(16)
    shape = (2, 1, 24, 28) if name == 'relax_2d' else (3, 5, 12, 14)
    prev = (3 * rng.randn(*shape)).astype(np.float32)
    prev[:, 0, 3, 4] = np.nan
    dim = shape[0]
    cfg = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40.0,) * dim,
               num_iters=200, max_iters=4000, stop_v_max=0.005, dt_max=100.0)
    return dflow._mesh_relax_flow(prev, device=dev, **cfg), (
        'force2d' if dim == 2 else 'force3d')
  fix, mov = _warped_pair(640)
  if name == 'warp_2d':
    th = np.deg2rad(0.7)
    m = np.array([[np.cos(th), -np.sin(th), 3.4], [np.sin(th), np.cos(th),
                                                   -2.2]])
    return dwarp._warp_affine(fix, m, device=dev), 'ndimage_warp'
  vol = np.stack([_texture(96, seed=17 + z)[:80] for z in range(24)], -1)
  m = np.array([[1.0, 0.01, 0, 1.5], [-0.01, 1.0, 0, -0.75], [0, 0, 1, 0.5]])
  return dwarp._warp_affine(vol.transpose(1, 0, 2).copy(), m,
                            device=dev), 'warp_gather_3d'


@pytest.mark.parametrize('name', ['flow_circular', 'flow_masked', 'relax_2d',
                                  'relax_3d', 'warp_2d', 'warp_3d'])
def test_decorator_chunks_against_plain(dev, name):
  before = _build.launch_counts.copy()
  got, counter = _chunk(name, dev)
  assert _build.launch_counts[counter] > before[counter]
  with _plain_kernels():
    after = _build.launch_counts.copy()
    ref, _ = _chunk(name, dev)
    assert _build.launch_counts == after
  if name.startswith('flow'):
    assert np.isfinite(got[0]).mean() > 0.5
    _flow_close(torch.from_numpy(got[:, 0]).reshape(4, -1),
                torch.from_numpy(ref[:, 0]).reshape(4, -1))
  elif name.startswith('relax'):
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)
    assert np.isfinite(got).all()
  else:
    np.testing.assert_allclose(got, ref, atol=1e-3 * 255, rtol=0)


@pytest.mark.parametrize('motion', ['translation', 'euclidean', 'affine'])
def test_ecc_card_against_cpu(dev, motion):
  from scipy import ndimage
  from sofima_tpu_torch.ops import registration
  fix = _texture(320, seed=18).T
  th = np.deg2rad(1.0)
  m = np.array([[np.cos(th), -np.sin(th), 2.5], [np.sin(th), np.cos(th),
                                                 -1.5], [0, 0, 1]])
  inv = np.linalg.inv(m)
  mov = ndimage.affine_transform(fix, inv[:2, :2], inv[:2, 2], order=1,
                                 mode='nearest').astype(np.float32)
  cc, got = registration.optim_transform(fix, mov, motion=motion,
                                         device=dev)
  cc_cpu, ref = registration.optim_transform(fix, mov, motion=motion,
                                             device='cpu')
  np.testing.assert_allclose(got, ref, atol=1e-3)
  assert abs(cc - cc_cpu) < 1e-4


@pytest.mark.parametrize('motion', ['translation', 'euclidean', 'affine'])
def test_ecc_loop_never_waits_for_the_card(dev, motion):
  # CUDA's sync debug mode raises on any call that makes the host wait
  # for the device: `_ecc_core` (its set-up and its Gauss-Newton loop)
  # must make none.
  from sofima_tpu_torch.ops import registration
  img = torch.from_numpy(_texture(256, seed=21)).to(dev)
  mov = torch.roll(img, (2, -3), (0, 1))
  init = torch.eye(2, 3, device=dev)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode('error')
  try:
    out = registration._ecc_core(img, mov, init, 5, motion)
  finally:
    torch.cuda.set_sync_debug_mode(0)
  assert out.shape == (2, 3) and out.is_cuda


@pytest.mark.parametrize('shape, roll', [((300, 260), (17, -9)),
                                         ((24, 64, 48), (3, -5, 11))])
def test_phase_correlation_card_against_cpu(dev, shape, roll):
  from sofima_tpu_torch.ops import registration
  img = np.random.RandomState(19).rand(*shape).astype(np.float32)
  mov = np.roll(img, roll, tuple(range(len(shape))))
  for norm in ('phase', None):
    got = registration.phase_cross_correlation(img, mov, normalization=norm,
                                               device=dev)
    ref = registration.phase_cross_correlation(img, mov, normalization=norm,
                                               device='cpu')
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[0], -np.asarray(roll, np.float32))
    assert abs(got[1] - ref[1]) <= 1e-5 * max(1.0, abs(ref[1]))


def test_checkpoint_resume_on_card(dev, tmp_path):
  from sofima_tpu_torch.utils import checkpoint
  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40), num_iters=50,
      max_iters=10000, stop_v_max=0.001, dt_max=100.0, start_cap=0.5,
      final_cap=10.0, cap_upscale_every=20)
  prev = (3 * np.random.RandomState(20).randn(2, 1, 30, 34)).astype(
      np.float32)
  x0 = np.zeros_like(prev)
  before = _build.launch_counts['force2d']
  whole, steps = checkpoint.CheckpointingRelaxer(
      str(tmp_path / 'a.npz'), cfg, save_every=2, device=dev).run(x0, prev)
  assert whole.is_cuda and _build.launch_counts['force2d'] > before
  path = str(tmp_path / 'b.npz')
  stop = (steps // 2) // 100 * 100
  assert stop >= 100
  checkpoint.CheckpointingRelaxer(
      path, dataclasses.replace(cfg, max_iters=stop), save_every=2,
      device=dev).run(x0, prev)
  assert int(checkpoint.load_solver_state(path)['step']) == stop
  resumed, steps_r = checkpoint.CheckpointingRelaxer(
      path, cfg, save_every=2, device=dev).run(x0, prev)
  assert steps_r == steps
  torch.testing.assert_close(resumed, whole, rtol=0, atol=1e-5)
