"""GPU smoke run of sofima_tpu_torch: kernels, then the stack-alignment path.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from sofima_tpu_torch/csrc, checks each kernel
against its plain PyTorch version at the main path's shapes, builds a
synthetic 10k^2 serial-section stack (seeded texture, cumulative drift
plus wobble, as bench.py's pipeline stage does), aligns it with
`align_stack_pipelined` at bench.py's headline configuration, and checks
the result against the known ground truth. Any failed check raises. The
last line is the JSON status; the line before it lists each kernel with
its launch count on the main path, its error against the plain version
and both times. Without CUDA it exits non-zero before any work.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N = 10_000          # section edge (bench.py's size)
N_Z = 4             # sections; bench.py runs 16, cut here only for time
STRIDE = 40
SEED = 0
FLOW_STAT_TOL = 3e-4    # rtol = atol for sharpness / ratio (tests' bar)
# Share of statistics that must meet it: just below the shares read on
# an H100 at these inputs (0.9987 for K1, 0.9993 for K2).
STAT_FRACTION = 0.998
MESH_TOL = 1e-3         # px, fused solver vs plain solver
RENDER_TOL = 1e-2       # gray levels, render kernel vs plain render
MAX_ERR = 3.5           # bench.py's pipeline ground-truth gate
SMALL_MESH_TOL = 0.4    # px = 0.01 * stride, small-input parity


def check(ok: bool, what: str) -> None:
  if not ok:
    raise AssertionError(what)


def smi() -> str:
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()


def sync():
  torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 3) -> float:
  """Mean milliseconds per call on the device (after one warm-up)."""
  fn()
  sync()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  sync()
  return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
  sync()
  t0 = time.perf_counter()
  fn()
  sync()
  return (time.perf_counter() - t0) * 1e3


def texture(n: int, dev) -> torch.Tensor:
  """bench.py's band-limited EM-like texture in [0, 255] (float32)."""
  rng = np.random.RandomState(SEED)
  noise = torch.from_numpy(rng.rand(n, n).astype(np.float32)).to(dev)
  f = torch.fft.rfft2(noise.double())
  fy = torch.fft.fftfreq(n, device=dev, dtype=torch.float64)[:, None]
  fx = torch.fft.rfftfreq(n, device=dev, dtype=torch.float64)[None, :]
  f *= torch.exp(-((fx ** 2 + fy ** 2) / (2 * 0.08 ** 2)))
  tex = torch.fft.irfft2(f, s=(n, n)).float()
  return (tex - tex.min()) / (tex.max() - tex.min()) * 255.0


def make_stack(base: torch.Tensor, n_z: int) -> torch.Tensor:
  """uint8 [n_z, n, n] stack: section z is `base` warped (with K4 in
  'linear' mode) by a cumulative drift of (2.5z, -2z) px plus a 7 px
  wobble, as bench.py's pipeline stage builds it."""
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.ops import interp
  n = base.shape[-1]
  g = n // STRIDE
  dev = base.device
  base_u8 = torch.clamp(base + 0.5, 0, 255).to(torch.uint8)
  gm = torch.arange(g, dtype=torch.float32, device=dev) * STRIDE
  ys = torch.arange(n, dtype=torch.float32, device=dev)
  sections = [base_u8]
  for z in range(1, n_z):
    dyz = 2.5 * z + 7.0 * torch.sin(2 * np.pi * gm[None, :] / 2500.0
                                    + 0.7 * z).expand(g, g)
    dxz = -2.0 * z + 7.0 * torch.cos(2 * np.pi * gm[:, None] / 2500.0
                                     + 0.4 * z).expand(g, g)
    dd = interp.upsample_map_linear(torch.stack([dyz, dxz]), STRIDE, (0, 0),
                                    (n, n))
    cz = torch.stack([dd[0] + ys[:, None], dd[1] + ys[None, :]])[None]
    del dd
    sec = cuda_warp.shift_warp(base_u8.float()[None], cz.contiguous(),
                               'linear')[0]
    sections.append(torch.clamp(sec + 0.5, 0, 255).to(torch.uint8))
    del cz, sec
  return torch.stack(sections)


def headline_config():
  """bench.py's headline pipeline configuration (bench.py:516-520)."""
  from sofima_tpu_torch.pipeline import stack_align
  cfg = stack_align.StackAlignConfig(max_displacement=128, residual=6,
                                     render_two_pass=True, peak_crop=32)
  return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh,
                                                           num_iters=125))


def compare_flow(got, ref, name):
  xy_bad = int((torch.nan_to_num(got[:2], nan=9e9)
                != torch.nan_to_num(ref[:2], nan=9e9)).any(0).sum())
  print(f'  {name}: patches whose x/y peak or NaN differs: {xy_bad}')
  check(xy_bad == 0, f'{name}: integer peaks differ from the plain version')
  # Sharpness divides by the correlation minimum around the peak, which
  # can sit near zero, so f32 summation order moves it freely there. The
  # bar: a STAT_FRACTION share of the statistics within rtol = atol =
  # 3e-4, and the quality gates they feed (|sharpness| >= 1.6, ratio >=
  # 1.6 or 0) decide alike.
  fin = torch.isfinite(ref[2:]) & torch.isfinite(got[2:])
  d = (got[2:] - ref[2:]).abs()[fin]
  bound = FLOW_STAT_TOL + FLOW_STAT_TOL * ref[2:].abs()[fin]
  frac = float((d <= bound).float().mean())
  rel = float((d / ref[2:].abs()[fin].clamp(min=1e-6)).max())

  def gates(f):
    ratio = f[3].abs()
    return (f[2].abs() >= 1.6) & ((ratio == 0) | (ratio >= 1.6))

  flips = int((gates(got) != gates(ref)).sum())
  print(f'  {name}: x/y and NaN exact over {ref[0].numel()} patches; '
        f'statistics within rtol=atol={FLOW_STAT_TOL}: {frac:.6f} '
        f'(max rel {rel:.3g}); quality-gate flips {flips}')
  check(frac >= STAT_FRACTION, f'{name}: sharpness/ratio disagree')
  check(flips == 0, f'{name}: quality-gate decisions differ')
  # max_abs_err is the flow itself (x/y peaks, NaN rows excluded); the
  # statistics' agreement is reported beside it.
  return dict(
      err=float(torch.nan_to_num((got[:2] - ref[:2]).abs(), nan=0.0).max()),
      stat_frac=frac, stat_max_rel=rel, stat_max_abs=float(d.max()))


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 2
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.ops import cuda_flow
  from sofima_tpu_torch.ops import cuda_mesh
  from sofima_tpu_torch.ops import cuda_warp
  from sofima_tpu_torch.ops import interp
  from sofima_tpu_torch.pipeline import stack_align

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = smi()
  print(card)
  print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
        f'cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}')
  _build.library()
  print(f'kernel build + load: {_build.build_seconds:.2f} s')
  print(_build.build_log.strip())
  report = {}

  tex = texture(N, dev)
  pre = tex.contiguous()
  post = torch.roll(tex, (7, -12), (0, 1)).contiguous()

  # K1: the coarse pass, p = step = 160 on the 10k^2 pair.
  print('K1 dense_flow_peaks, 10k^2, p = s = 160')
  k1 = lambda: cuda_flow.dense_flow_peaks(pre, post, (160, 160), (160, 160))
  gy = (N - (160 - 160)) // 160
  k1p = lambda: cuda_flow.flow_peaks_plain(
      pre, post, None, (gy, gy), 160, (160, 160), 160, None, 2, 0.5, 5)
  report['K1'] = dict(compare_flow(k1(), k1p(), 'K1'), ms=cuda_ms(k1),
                      plain_ms=wall_ms(k1p))
  print(f'  kernel {report["K1"]["ms"]:.3f} ms, plain '
        f'{report["K1"]["plain_ms"]:.3f} ms')

  # K2: the fine pass, p = 80, s = 40, 4-row blocks. As on the main path,
  # each block's window is targeted near the true shift (7, -12), here
  # with a random error of up to 3 px.
  print('K2 targeted_flow_peaks, 10k^2, p = 80, s = 40, peak_crop = 32')
  geo = cuda_flow.targeted_geometry((N, N), (80, 80), (40, 40), rows=4)
  rng = np.random.RandomState(SEED + 1)
  jitter = rng.randint(-3, 4, size=(geo['nrsteps'], geo['ngroups'], 2))
  offs = torch.from_numpy((jitter + np.array([7, -12])).astype(np.int32))
  offs = offs.to(dev)
  k2 = lambda: cuda_flow.dense_flow_peaks_targeted(
      pre, post, offs, (80, 80), (40, 40), max_offset=128, peak_crop=32,
      rows=4)
  ex = torch.repeat_interleave(torch.repeat_interleave(
      offs, 4, 0), geo['group'], 1)[:geo['gy'], :geo['gx']].contiguous()
  k2p = lambda: cuda_flow.flow_peaks_plain(
      pre, post, ex, (geo['gy'], geo['gx']), 80, (40, 40), 32, None, 2,
      0.5, 5)
  report['K2'] = dict(compare_flow(k2(), k2p(), 'K2'), ms=cuda_ms(k2),
                      plain_ms=wall_ms(k2p))
  print(f'  kernel {report["K2"]["ms"]:.3f} ms, plain '
        f'{report["K2"]["plain_ms"]:.3f} ms')

  # K3: the fused FIRE solve on a 250^2 mesh (headline solver config).
  print('K3 fused_fire, 250^2 nodes')
  g = N // STRIDE
  cfg = headline_config()
  yy, xx = np.mgrid[:g, :g].astype(np.float32)
  prev = np.stack([3.0 * np.sin(xx / 17.0) + rng.randn(g, g) * 0.7,
                   2.0 * np.cos(yy / 23.0) + rng.randn(g, g) * 0.7])
  prev = prev.astype(np.float32)[:, None]
  prev[:, :, :2] = prev[:, :, -2:] = np.nan
  prev[:, :, :, :2] = prev[:, :, :, -2:] = np.nan
  prev[:, :, 100:104, 60:70] = np.nan
  prev_t = torch.from_numpy(prev).to(dev)
  x0 = torch.nan_to_num(prev_t, nan=0.0)
  k3 = lambda: cuda_mesh.relax_mesh_fused(x0, prev_t, cfg.mesh)
  got, _, steps = k3()
  ref, _, steps_p = cuda_mesh.relax_mesh_fused_plain(x0[:, 0], prev_t[:, 0],
                                                     cfg.mesh)
  check(int(steps) == int(steps_p), f'K3 steps {int(steps)} vs {steps_p}')
  check(bool(torch.equal(torch.isnan(got[:, 0]), torch.isnan(ref))),
        'K3 NaN pattern differs')
  err = float(torch.nan_to_num((got[:, 0] - ref).abs(), nan=0.0).max())
  print(f'  steps {int(steps)} (plain {steps_p}), max |dx| {err:.3g} px')
  check(err < MESH_TOL, f'K3 differs from the plain solver by {err} px')
  report['K3'] = dict(err=err, ms=cuda_ms(k3), plain_ms=wall_ms(
      lambda: cuda_mesh.relax_mesh_fused_plain(x0[:, 0], prev_t[:, 0],
                                               cfg.mesh)))
  print(f'  kernel {report["K3"]["ms"]:.3f} ms, plain '
        f'{report["K3"]["plain_ms"]:.3f} ms')

  # K4: a 10k^2 Lanczos render through a ~100 px displacement.
  print('K4 warp_gather, 10k^2 Lanczos')
  node = torch.arange(g + 1, dtype=torch.float32, device=dev) * STRIDE
  disp = torch.stack([
      100.3 + 5.0 * torch.sin(node[None, :] / 900.0).expand(g + 1, g + 1),
      -97.6 + 5.0 * torch.cos(node[:, None] / 700.0).expand(g + 1, g + 1)])
  dense = interp.upsample_map_linear(disp, STRIDE, (0, 0), (N, N))
  ys = torch.arange(N, dtype=torch.float32, device=dev)
  coords = torch.stack([dense[0] + ys[:, None], dense[1] + ys[None, :]])
  coords = coords[None].contiguous()
  del dense
  img = tex[None].contiguous()
  k4 = lambda: cuda_warp.shift_warp(img, coords, 'lanczos')
  err = float((k4() - cuda_warp.shift_warp_plain(img, coords, 'lanczos'))
              .abs().max())
  print(f'  max |diff| {err:.3g} gray levels')
  check(err < RENDER_TOL, f'K4 differs from the plain render by {err}')
  report['K4'] = dict(err=err, ms=cuda_ms(k4), plain_ms=wall_ms(
      lambda: cuda_warp.shift_warp_plain(img, coords, 'lanczos')))
  print(f'  kernel {report["K4"]["ms"]:.3f} ms, plain '
        f'{report["K4"]["plain_ms"]:.3f} ms')
  del coords, img

  print(f'stack: {N_Z} sections of {N}^2 (bench.py runs 16; cut for time)')
  stack = make_stack(post, N_Z)
  del pre, post, tex

  # Main path: align_stack_pipelined, headline config, uint8 output.
  stack_align.align_stack_pipelined(stack, cfg, out_dtype=torch.uint8)
  sync()
  _build.reset_launch_counts()
  timings = {}
  t0 = time.perf_counter()
  rendered, solved, overflow = stack_align.align_stack_pipelined(
      stack, cfg, out_dtype=torch.uint8, timings=timings)
  sync()
  wall = time.perf_counter() - t0
  launches = dict(_build.launch_counts)
  mpix = (N_Z - 1) * N * N / wall / 1e6
  inter = (slice(320, -320), slice(320, -320))
  base_i = stack[0][inter].float()
  errs = [float((rendered[z][inter].float() - base_i).abs().mean())
          for z in range(1, N_Z)]
  raw = float((stack[N_Z - 1][inter].float() - base_i).abs().mean())
  print('main path: align_stack_pipelined (max_displacement=128, '
        'residual=6, render_two_pass, peak_crop=32, num_iters=125, uint8)')
  print('  phase seconds: ' + ', '.join(f'{k} {v:.3f}'
                                        for k, v in timings.items()))
  print(f'  wall {wall:.3f} s, {mpix:.1f} Mpix/s over {N_Z - 1} sections')
  print(f'  worst interior error {max(errs):.3f} (gate {MAX_ERR}; '
        f'unaligned {raw:.2f}), overflow {bool(overflow)}')
  print(f'  launches {launches}')
  check(tuple(rendered.shape) == (N_Z, N, N), 'rendered shape')
  check(tuple(solved.shape) == (N_Z, 2, 1, g, g), 'solved shape')
  check(bool(torch.isfinite(solved).all()), 'solved mesh is not finite')
  check(max(errs) <= MAX_ERR, f'interior error {max(errs)} > {MAX_ERR}')
  check(not bool(overflow), 'envelope overflow on the main path')
  for k, v in launches.items():
    check(v > 0, f'kernel {k} was not launched on the main path')

  # Small input: the card's run against the plain versions on the CPU.
  n_s = 480
  small = stack[:3, :n_s, :n_s].contiguous()
  cfg_s = dataclasses.replace(cfg, max_displacement=64, residual=8)
  r_gpu, s_gpu, o_gpu = stack_align.align_stack_pipelined(small, cfg_s)
  r_cpu, s_cpu, o_cpu = stack_align.align_stack_pipelined(small.cpu(), cfg_s)
  d = float((s_gpu.cpu() - s_cpu).abs().max())
  print(f'small input ({n_s}^2 x 3): mesh max |diff| vs CPU plain path '
        f'{d:.3g} px, overflow {bool(o_gpu)} / {bool(o_cpu)}')
  check(d < SMALL_MESH_TOL, 'small-input meshes differ')
  check(bool(o_gpu) == bool(o_cpu), 'small-input overflow flags differ')
  check(bool(torch.isfinite(r_gpu).all()), 'small-input render not finite')

  kernels = []
  meta = [
      ('K1', 'dense_flow_peaks', 'sofima_tpu_torch/csrc/flow_peaks.cu',
       'sofima_tpu/ops/pallas_flow.py:732'),
      ('K2', 'targeted_flow_peaks', 'sofima_tpu_torch/csrc/flow_peaks.cu',
       'sofima_tpu/ops/pallas_flow.py:797'),
      ('K3', 'fused_fire', 'sofima_tpu_torch/csrc/fire.cu',
       'sofima_tpu/ops/pallas_mesh.py:852'),
      ('K4', 'warp_gather', 'sofima_tpu_torch/csrc/warp.cu',
       'sofima_tpu/ops/pallas_warp.py:206'),
  ]
  for key, name, src, rep in meta:
    r = report[key]
    # For K1/K2, max_abs_err is the integer x/y peaks; the sharpness and
    # ratio agreement follows as stat_frac / stat_max_rel / stat_max_abs.
    stats = {k: v for k, v in r.items() if k.startswith('stat_')}
    kernels.append(dict(name=name, route='cuda', source=src, replaces=rep,
                        launches=launches[name], max_abs_err=r['err'],
                        **stats, ms=r['ms'], plain_ms=r['plain_ms']))
  print(smi())
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
