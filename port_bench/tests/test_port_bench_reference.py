"""The frozen plain reference against the port's CPU path at a small
size (480^2 x 3 sections, the configuration as committed): a copy that
drifted when it was frozen would read here. And the comparison fails its
bfloat16 control and every planted fault."""

import pytest
import torch

from bench_helpers import run_small, small_cell
from port_bench.tools import faults


@pytest.mark.parametrize('workload', ['em2d.stack16', 'em2d.stream'])
def test_reference_holds_the_program(workload):
  res = run_small(workload)
  values = {k: v['value'] for k, v in res['checks'].items()}
  assert res['correct'], values
  assert values == {'mesh_p99_px': 0.0, 'render_off_share': 0.0,
                    'overflow_mismatch': 0}


def test_archival_solver_matches_the_program():
  """em_2d's ramped solve, alone: the port's plain FIRE and the
  reference's on one small mesh, step for step."""
  import dataclasses
  from port_bench.drivers import _stack
  from port_bench.reference import solve as solve_ref
  from sofima_tpu_torch.ops import cuda_mesh
  cfg = small_cell('em2d.stack16').config
  m = dict(cfg['mesh'], max_iters=3000)
  prog = _stack.stack_config(dict(cfg, mesh=m)).mesh
  gen = torch.Generator().manual_seed(5)
  target = torch.randn((2, 12, 12), generator=gen) * 3.0
  target[:, 4:6, 3:5] = float('nan')
  x0 = torch.where(torch.isnan(target), torch.zeros_like(target), target)
  got, _, steps = cuda_mesh.relax_mesh_fused(x0[:, None], target[:, None],
                                             dataclasses.replace(prog))
  ref, ref_steps = solve_ref.Fire(m).relax(x0, target)
  assert int(steps) == ref_steps
  assert torch.equal(got[:, 0], ref)


def test_control_fails():
  res = run_small('em2d.stack16', control=True)
  assert not res['correct'], res['checks']


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
@pytest.mark.parametrize('workload', ['em2d.stack16', 'em2d.stream'])
def test_planted_faults_fail(workload, fault):
  with faults.planted(fault):
    res = run_small(workload)
  assert not res['correct'], (fault, res['checks'])


@pytest.mark.gpu
def test_graph_replay_equals_eager_steps(cuda_device):
  """On the card, the reference's captured FIRE step replays the eager
  step's arithmetic."""
  from port_bench.reference import solve as solve_ref
  cfg = small_cell('em2d.stack16').config
  m = dict(cfg['mesh'], max_iters=500)
  gen = torch.Generator(device=cuda_device).manual_seed(3)
  target = torch.randn((2, 40, 40), generator=gen, device=cuda_device) * 3
  x0 = target.clone()
  graphed, s1 = solve_ref.Fire(m, graphs=True).relax(x0, target)
  eager, s2 = solve_ref.Fire(m, graphs=False).relax(x0, target)
  assert s1 == s2
  assert torch.equal(graphed, eager)
