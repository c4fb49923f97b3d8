"""The solver checkpoint of sofima_tpu_torch against sofima_tpu (CPU).

Twins of tests/test_aux.py::TestCheckpoint (the snapshot and mesh npz
round trips, a missing snapshot, CheckpointingRelaxer's resume) on the
port with device='cpu', plus:
  * a snapshot or mesh file written by either package loads in the
    other, with the same keys and values;
  * the relaxer on the same inputs in both packages: positions within
    1e-4 px and the same step count;
  * a run stopped at a snapshot (a lower max_iters) and resumed equals
    one run to convergence bit for bit (the plain force is
    deterministic), and the resumed run starts from the snapshot's step.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import mesh as j_mesh
from sofima_tpu.utils import checkpoint as j_ckpt
from sofima_tpu_torch import mesh as t_mesh
from sofima_tpu_torch.utils import checkpoint as t_ckpt

torch.set_num_threads(2)

BOTH = (j_ckpt, t_ckpt)

CFG = dict(dt=0.001, gamma=0.0, k0=0.05, k=0.1, stride=(40, 40),
           num_iters=100, max_iters=10000, stop_v_max=0.001, dt_max=100.0)


def test_solver_state_roundtrip(tmp_path):
  x = np.random.RandomState(0).rand(2, 1, 4, 4).astype(np.float32)
  path = str(tmp_path / 'state.npz')
  t_ckpt.save_solver_state(path, torch.from_numpy(x),
                           v=torch.zeros(2, 1, 4, 4),
                           fire_state={'dt': 0.5}, step=100,
                           metadata={'run': 'a'})
  state = t_ckpt.load_solver_state(path)
  np.testing.assert_array_equal(state['x'], x)
  assert state['step'] == 100
  assert float(state['fire_dt']) == 0.5
  assert not os.path.exists(path + '.tmp')


def test_load_missing(tmp_path):
  assert t_ckpt.load_solver_state(str(tmp_path / 'nope.npz')) == {}


def test_mesh_npz_roundtrip(tmp_path):
  path = str(tmp_path / 'mesh.npz')
  x = np.random.RandomState(1).rand(2, 3, 4, 4).astype(np.float32)
  k2i = {(0, 0): 0, (1, 0): 1, (0, 1): 2}
  t_ckpt.save_mesh_npz(path, x, k2i)
  x2, k2 = t_ckpt.load_mesh_npz(path)
  np.testing.assert_array_equal(x2, x)
  assert k2 == k2i


@pytest.mark.parametrize('writer', [0, 1])
def test_files_cross_load(tmp_path, writer):
  rng = np.random.RandomState(2 + writer)
  x = rng.rand(2, 1, 5, 6).astype(np.float32)
  v = rng.rand(2, 1, 5, 6).astype(np.float32)
  k2i = {(0, 0): 0, (1, 0): 1}
  state_path = str(tmp_path / 'state.npz')
  mesh_path = str(tmp_path / 'mesh.npz')
  BOTH[writer].save_solver_state(
      state_path, x, v, fire_state={'dt': 0.25, 'alpha': 0.1, 'cap': 3.0},
      step=700, metadata={'stage': 2})
  BOTH[writer].save_mesh_npz(mesh_path, x, k2i)
  states = [mod.load_solver_state(state_path) for mod in BOTH]
  assert sorted(states[0]) == sorted(states[1]) == [
      'fire_alpha', 'fire_cap', 'fire_dt', 'metadata', 'step', 'v', 'x']
  for k in states[0]:
    np.testing.assert_array_equal(states[1][k], states[0][k])
  np.testing.assert_array_equal(states[1]['x'], x)
  for mod in BOTH:
    xm, km = mod.load_mesh_npz(mesh_path)
    np.testing.assert_array_equal(xm, x)
    assert km == k2i


def test_checkpointing_relaxer_resumes(tmp_path):
  path = str(tmp_path / 'relax.npz')
  cfg = t_mesh.IntegrationConfig(**CFG)
  x0 = np.random.RandomState(0).randn(2, 1, 8, 8).astype(np.float32)
  prev = np.zeros_like(x0)
  relaxer = t_ckpt.CheckpointingRelaxer(path, cfg, save_every=1,
                                        device='cpu')
  x, steps = relaxer.run(x0, prev)
  np.testing.assert_allclose(x.numpy(), 0.0, atol=0.2)
  # Resume: the solved state is already converged -> quick exit.
  x2, steps2 = relaxer.run(x0, prev)
  assert steps2 >= steps
  np.testing.assert_allclose(x2.numpy(), 0.0, atol=0.2)


def test_relaxer_matches_reference(tmp_path):
  rng = np.random.RandomState(4)
  x0 = rng.randn(2, 1, 8, 8).astype(np.float32)
  prev = rng.randn(2, 1, 8, 8).astype(np.float32)
  prev[:, 0, 3, 4] = np.nan
  j_x, j_steps = j_ckpt.CheckpointingRelaxer(
      str(tmp_path / 'j.npz'), j_mesh.IntegrationConfig(**CFG),
      save_every=3).run(jnp.asarray(x0), jnp.asarray(prev))
  t_x, t_steps = t_ckpt.CheckpointingRelaxer(
      str(tmp_path / 't.npz'), t_mesh.IntegrationConfig(**CFG),
      save_every=3, device='cpu').run(x0, prev)
  assert t_steps == j_steps
  np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=1e-4)
  # Each package's final snapshot loads in the other.
  j_state = t_ckpt.load_solver_state(str(tmp_path / 'j.npz'))
  t_state = j_ckpt.load_solver_state(str(tmp_path / 't.npz'))
  assert int(j_state['step']) == int(t_state['step']) == t_steps
  np.testing.assert_allclose(t_state['x'], j_state['x'], atol=1e-4)


def test_stopped_and_resumed_equals_one_run(tmp_path):
  cfg = dict(CFG, start_cap=0.5, final_cap=10.0, cap_upscale_every=20,
             num_iters=50)
  rng = np.random.RandomState(5)
  x0 = np.zeros((2, 1, 9, 7), np.float32)
  prev = 3 * rng.randn(2, 1, 9, 7).astype(np.float32)
  whole, steps = t_ckpt.CheckpointingRelaxer(
      str(tmp_path / 'whole.npz'), t_mesh.IntegrationConfig(**cfg),
      save_every=2, device='cpu').run(x0, prev)
  assert steps > 200
  path = str(tmp_path / 'cut.npz')
  _, cut_steps = t_ckpt.CheckpointingRelaxer(
      path, t_mesh.IntegrationConfig(**dict(cfg, max_iters=200)),
      save_every=2, device='cpu').run(x0, prev)
  assert cut_steps == 200
  assert int(t_ckpt.load_solver_state(path)['step']) == 200
  resumed, resumed_steps = t_ckpt.CheckpointingRelaxer(
      path, t_mesh.IntegrationConfig(**cfg), save_every=2,
      device='cpu').run(x0, prev)
  assert resumed_steps == steps
  assert torch.equal(resumed, whole)
