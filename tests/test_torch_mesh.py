"""Mesh solver of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

K3 (ops.cuda_mesh.relax_mesh_fused, the fused FIRE solver) on the setup
of tests/test_pallas_mesh.py::TestFusedFireSolver, with and without
`prev`, against pallas_mesh.relax_mesh_fused_pallas in interpret mode;
the plain staged solver and the in-plane force against sofima_tpu.mesh.
Tolerance (as tests/test_pallas_mesh.py holds the Pallas kernel): step
counts equal, NaN pattern equal, max |dx| < 1e-3 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import mesh as jmesh
from sofima_tpu.ops import pallas_mesh
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch.ops import cuda_mesh

torch.set_num_threads(2)


def _setup(g=24, seed=0, **overrides):
  rng = np.random.RandomState(seed)
  prev = np.full((2, 1, g, g), np.nan, np.float32)
  prev[:, :, 2:-2, 2:-2] = rng.randn(2, 1, g - 4, g - 4).astype(
      np.float32) * 3
  kw = dict(dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0, 40.0),
            num_iters=200, max_iters=2000, stop_v_max=0.005, dt_max=100.0,
            start_cap=0.01, final_cap=10.0, cap_scale=1.1,
            prefer_orig_order=True)
  kw.update(overrides)
  return (np.zeros_like(prev), prev, jmesh.IntegrationConfig(**kw),
          tmesh.IntegrationConfig(**kw))


def _close(got, ref, tol=1e-3):
  got, ref = np.asarray(got), np.asarray(ref)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  assert np.nanmax(np.abs(got - ref)) < tol


class TestFusedFire:

  def test_matches_pallas_kernel(self):
    x0, prev, jc, tc = _setup()
    ref, ref_e, ref_steps = pallas_mesh.relax_mesh_fused_pallas(
        jnp.asarray(x0), jnp.asarray(prev), jc, interpret=True)
    got, got_e, got_steps = cuda_mesh.relax_mesh_fused(
        torch.from_numpy(x0), torch.from_numpy(prev), tc)
    assert int(got_steps) == int(ref_steps)
    _close(got, ref)
    n = int(ref_steps) // tc.num_iters
    np.testing.assert_allclose(got_e.numpy()[:n], np.asarray(ref_e)[:n],
                               rtol=1e-3)

  def test_no_prev(self):
    x0, _, jc, tc = _setup()
    ref, _, ref_steps = pallas_mesh.relax_mesh_fused_pallas(
        jnp.asarray(x0 + 1.5), None, jc, interpret=True)
    got, _, got_steps = cuda_mesh.relax_mesh_fused(
        torch.from_numpy(x0 + 1.5), None, tc)
    assert int(got_steps) == int(ref_steps)
    _close(got, ref)

  def test_headline_protocol(self):
    # The pipeline's protocol: no cap ramp, num_iters 125, nodes NaN.
    x0, prev, jc, tc = _setup(g=20, seed=1, num_iters=125, max_iters=4000,
                              start_cap=10.0)
    x0 = np.nan_to_num(prev)
    ref, _, ref_steps = pallas_mesh.relax_mesh_fused_pallas(
        jnp.asarray(x0), jnp.asarray(prev), jc, interpret=True)
    got, _, got_steps = cuda_mesh.relax_mesh_fused(
        torch.from_numpy(x0), torch.from_numpy(prev), tc)
    assert int(got_steps) == int(ref_steps)
    _close(got, ref)

  def test_drift_removal_is_not_fused(self):
    x0, prev, _, tc = _setup(remove_drift=True)
    with pytest.raises(NotImplementedError):
      cuda_mesh.relax_mesh_fused(torch.from_numpy(x0),
                                 torch.from_numpy(prev), tc)


class TestPlainSolver:

  def test_inplane_force(self):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 1, 16, 16).astype(np.float32) * 3
    x[:, 0, 5, 7] = np.nan
    for po in (False, True):
      ref = np.asarray(jmesh.inplane_force(jnp.asarray(x), 0.1, (40, 40),
                                           po))
      got = tmesh.inplane_force(torch.from_numpy(x), 0.1, (40, 40),
                                po).numpy()
      np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                                 atol=1e-5)

  def test_relax_mesh_fused(self):
    x0, prev, jc, tc = _setup(g=16)
    ref, _, ref_steps = jmesh.relax_mesh_fused(jnp.asarray(x0),
                                               jnp.asarray(prev), jc)
    got, _, got_steps = tmesh.relax_mesh_fused(torch.from_numpy(x0),
                                               torch.from_numpy(prev), tc)
    assert int(got_steps) == int(ref_steps)
    _close(got, ref)

  def test_config_json_round_trip(self):
    _, _, jc, tc = _setup()
    assert tc.to_json() == jc.to_json()
    assert tmesh.IntegrationConfig.from_json(jc.to_json()) == tc
