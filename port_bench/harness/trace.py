"""What a traced window reads from torch.profiler: the device's
operations (kernels, copies, fills) with their times, the device's busy
time (the union of their intervals), and the longest idle gaps, each
labelled by the innermost host operation running at its middle.

The profiler's raw Kineto events are read directly, without building
its FunctionEvent tree, so that a window of some 10^5 launches is read
in seconds.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

import torch

WINDOW = 'port_bench.window'
SHORT_GAP_NS = 20_000  # idle gaps below this are summed unlabelled


@dataclasses.dataclass
class DeviceOp:
  name: str
  start_ns: int
  end_ns: int

  @property
  def seconds(self) -> float:
    return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Trace:
  window_s: float
  busy_s: float
  ops: list          # DeviceOp within the window, by start
  kernels: list      # the ops that are kernels (not copies or fills)
  breakdown: dict


def short_name(name: str) -> str:
  """A kernel's identifier without return type, namespace, template
  arguments or parameters."""
  base = name.replace('(anonymous namespace)', '')
  depth, out = 0, []
  for ch in base:
    if ch in '<(':
      if depth == 0 and ch == '(':
        break  # the parameter list
      depth += 1
    elif ch in '>)':
      depth -= 1
    elif depth == 0:
      out.append(ch)
  base = re.sub(r'^(void|auto)\s+', '', ''.join(out).strip())
  return base.split('::')[-1].strip() or name[:64]


def _span(ev):
  """(start_ns, end_ns) of a raw Kineto event, across torch versions."""
  if hasattr(ev, 'start_ns'):
    return int(ev.start_ns()), int(ev.end_ns())
  start = int(ev.start_us() * 1000)
  return start, start + int(ev.duration_us() * 1000)


def _is_copy(name: str) -> bool:
  return name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset'))


def read(prof) -> Trace:
  """The window's device operations and their breakdown from a stopped
  torch.profiler.profile."""
  events = prof.profiler.kineto_results.events()
  window = None
  cpu, dev = [], []
  cuda = torch.autograd.DeviceType.CUDA
  for ev in events:
    name = ev.name()
    if name == WINDOW and ev.device_type() != cuda:
      window = _span(ev)
      continue
    if name.startswith('port_bench.') and ev.device_type() == cuda:
      continue  # the annotation's device-side copy
    s, e = _span(ev)
    if ev.device_type() == cuda:
      dev.append(DeviceOp(name, s, e))
    else:
      cpu.append((s, e, name))
  if window is None:
    raise RuntimeError('the traced window has no span')
  w0, w1 = window
  ops = sorted((o for o in dev if o.end_ns > w0 and o.start_ns < w1),
               key=lambda o: o.start_ns)
  busy, gaps = 0, []
  cur_s = cur_e = None
  for o in ops:
    s, e = max(o.start_ns, w0), min(o.end_ns, w1)
    if cur_e is None:
      if s > w0:
        gaps.append((w0, s))
      cur_s, cur_e = s, e
    elif s > cur_e:
      busy += cur_e - cur_s
      gaps.append((cur_e, s))
      cur_s, cur_e = s, e
    else:
      cur_e = max(cur_e, e)
  if cur_e is not None:
    busy += cur_e - cur_s
    if cur_e < w1:
      gaps.append((cur_e, w1))
  kernels = [o for o in ops if not _is_copy(o.name)]
  return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, ops=ops,
               kernels=kernels, breakdown=_breakdown(ops, gaps, cpu))


def _innermost(events, t, reach=4000):
  """Name of the latest-starting (start, end, name) event covering t."""
  i = bisect.bisect_right(events, (t, float('inf'), '')) - 1
  for j in range(i, max(-1, i - reach), -1):
    if events[j][1] >= t:
      return events[j][2]
  return None


def _breakdown(ops, gaps, cpu) -> dict:
  """The ten device operations that took most time, and the idle gaps
  summed by what the host was doing (the harness's layer span and the
  innermost host operation at each gap's middle)."""
  by_op: dict[str, float] = {}
  for o in ops:
    key = short_name(o.name)
    by_op[key] = by_op.get(key, 0.0) + o.seconds
  spans = sorted(c for c in cpu if c[2].startswith('port_bench.'))
  ops_cpu = sorted(c for c in cpu if not c[2].startswith('port_bench.'))
  by_host: dict[str, float] = {}
  for g0, g1 in gaps:
    if g1 - g0 < SHORT_GAP_NS:
      label = 'short gaps (< 20 us)'
    else:
      mid = (g0 + g1) // 2
      span = _innermost(spans, mid) or 'port_bench.window'
      label = (span.split('.', 1)[1] + ': '
               + (_innermost(ops_cpu, mid) or 'python'))
    by_host[label] = by_host.get(label, 0.0) + (g1 - g0) * 1e-9
  top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                             key=lambda kv: -kv[1])[:10]]
  return {'device_ops': top(by_op), 'idle_gaps': top(by_host)}
