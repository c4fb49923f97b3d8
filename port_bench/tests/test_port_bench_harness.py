"""The harness's own arithmetic: seeded sections, the rate over completed
work, the tail over every section, the roofline bound for either flow
route."""

import statistics
import time

import torch

import bench_helpers  # noqa: F401  (puts the repository root on sys.path)
from port_bench.harness import cell as cell_lib
from port_bench.harness import spec
from port_bench.harness import trace as trace_lib

MIX = {'blocks': 2, 'sections_per_block': 3, 'texture_sigma': 0.08,
       'drift_px': [2.5, -2.0], 'wobble_px': 7.0, 'wobble_period_px': 2500.0,
       'wobble_rate': [0.7, 0.4]}


def _sections(mix, n, seed):
  return spec.module('inputs', 'drifting_sections').make(
      mix, {'section_px': n}, seed, 'cpu')


def test_sections_repeat_from_the_seed_and_differ_across_seeds():
  big = 2 ** 31 + 12345
  a = _sections(MIX, 128, big)
  b = _sections(MIX, 128, big)
  c = _sections(MIX, 128, big + 1)
  assert a.dtype == torch.uint8 and a.shape == (2, 3, 128, 128)
  assert torch.equal(a, b)
  assert not torch.equal(a, c)
  assert not torch.equal(a[0], a[1])  # blocks draw their own phases
  assert int(a.max()) > 200 and int(a.min()) < 55


def test_stage_jumps_move_only_the_sections_after_them():
  big = 2 ** 31 + 7
  mix = dict(MIX, sections_per_block=5, wobble_px=0.0)
  plain = _sections(mix, 128, big)
  jumps = _sections(dict(mix, jump_every=3, jump_px=[12.0, -9.0]), 128, big)
  assert torch.equal(plain[:, :3], jumps[:, :3])
  assert not torch.equal(plain[:, 3:], jumps[:, 3:])
  # Without wobble, section 3 is section 3 moved by the jump.
  assert torch.equal(jumps[0, 3, 20:100, 20:100],
                     plain[0, 3, 32:112, 11:91])


class _FakeStack:
  """An entry whose calls take known times on the CPU."""

  def __init__(self, seconds):
    self.seconds = list(seconds)
    self.i = 0

  def _wait(self):
    time.sleep(self.seconds[self.i % len(self.seconds)])
    self.i += 1

  def align_stack_pipelined(self, block, cfg, out_dtype, timings=None):
    self._wait()
    z = block.shape[0]
    return (block.clone(), torch.zeros(z, 2, 1, 2, 2),
            torch.zeros((), dtype=torch.bool))

  def align_step(self, prev, cur, mesh, cfg):
    self._wait()
    return mesh, cur.to(torch.float32), torch.zeros((), dtype=torch.bool)


def _config():
  return spec.load_cell('em2d.stack16').config


def test_rate_counts_completed_calls_up_to_the_last_completion():
  blocks = torch.zeros(2, 4, 8, 8, dtype=torch.uint8)
  mix = {'out_dtype': 'uint8', 'sections_per_block': 4,
         'check': {'calls_drawn_from': 1, 'sections': 1}}
  drv = spec.module('drivers', 'block').Driver(
      _config(), mix, blocks, 5, 'cpu', entry=_FakeStack([0.03]))
  win = drv.window(0.1)
  calls = len(win.call_seconds)
  assert win.sections == calls * 3
  assert win.wall >= 0.1  # the straddling call is waited for
  assert win.wall >= sum(win.call_seconds)
  ctx = cell_lib.Context({}, {}, 8, window=win)
  rate = spec.end_to_end_reader('mpix_per_s').read(ctx)
  assert abs(rate - calls * 3 * 64 / 1e6 / win.wall) < 1e-12


def test_p95_is_taken_over_every_section():
  blocks = torch.zeros(1, 4, 8, 8, dtype=torch.uint8)
  mix = {'sections_per_block': 4, 'check': {'sections': 1}}
  cfg = dict(_config(), stride=4)
  drv = spec.module('drivers', 'stream').Driver(
      cfg, mix, blocks, 5, 'cpu', entry=_FakeStack([0.001] * 9 + [0.05]))
  win = drv.window(0.3)
  assert win.sections == len(win.latencies) >= 10
  reader = spec.end_to_end_reader('section_p95_ms')
  expected = statistics.quantiles(win.latencies, n=100,
                                  method='inclusive')[94]
  got = reader.read(cell_lib.Context({}, {}, 8, window=win))
  assert got == 1e3 * expected
  assert 1e3 * max(win.latencies) >= got >= 1.0


def _context(kernel_name, seconds, sections=3, n=10000):
  ops = [trace_lib.DeviceOp(kernel_name, 0, int(seconds * 1e9))
         for _ in range(2 * sections)]
  tr = trace_lib.Trace(window_s=1.0, busy_s=0.5, ops=ops, kernels=ops,
                       breakdown={})
  cfg = {'patch': 160, 'stride': 40}
  return cell_lib.Context(cfg, {}, n, sections=sections, trace=tr)


def test_flow_roofline_is_the_same_for_either_route():
  reader = spec.metric_reader('flow.k1k2_roofline')
  fft = reader.read(_context('void (anonymous namespace)::flow_fft_kernel'
                             '<256, 4>(float const*)', 0.004))
  dft = reader.read(_context('void flow_peaks_kernel(float const*)', 0.004))
  assert fft == dft and 0 < fft < 100
  # A trace that lost a launch reads nothing rather than a wrong share.
  ctx = _context('flow_fft_kernel', 0.004)
  ctx.trace.kernels = ctx.trace.kernels[:-1]
  assert reader.read(ctx) is None


def test_phase_walls_read_over_the_sections_they_cover():
  ctx = cell_lib.Context({}, {}, 8, sections=99,
                         timings={'flow': 0.3, 'render': 0.15},
                         timing_sections=30)
  assert spec.metric_reader('flow.ms_per_section').read(ctx) == 10.0
  assert spec.metric_reader('render.ms_per_section').read(ctx) == 5.0
  assert spec.metric_reader('solve.ms_per_section').read(ctx) is None
  assert spec.metric_reader('flow.ms_per_section').read(
      cell_lib.Context({}, {}, 8)) is None


def test_short_kernel_names():
  assert trace_lib.short_name(
      'void (anonymous namespace)::flow_fft_kernel<160, 256>(float const*)'
  ) == 'flow_fft_kernel'
  assert trace_lib.short_name(
      'void warp_gather_kernel<(Method)3>(float const*)') == (
          'warp_gather_kernel')
  assert trace_lib.short_name('fused_fire_kernel') == 'fused_fire_kernel'
