"""3d mesh solvers of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

The 26-neighbour force (the plain version of kernel K9) against
`mesh.elastic_mesh_3d` (the XLA stencil) and
`pallas_mesh.elastic_mesh_3d_pallas` in interpret mode, with NaN nodes
and `prefer_orig_order` both ways: max |df| < 1e-4 (the bound
tests/test_pallas_mesh.py holds the Pallas force to). `velocity_verlet`
and `relax_mesh` with that force against JAX: < 1e-3 px, equal steps.
The plain fused 3d solver (kernel K11's twin) against
`relax_mesh_fused_pallas_3d(interpret=True)` at
tests/test_pallas_mesh.py's sizes: steps equal, NaN pattern equal,
< 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import mesh as jmesh
from sofima_tpu.ops import pallas_mesh
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch.ops import cuda_mesh

torch.set_num_threads(2)

STRIDE = (40.0, 30.0, 20.0)


def _positions(shape, seed, holes=True):
  rng = np.random.RandomState(seed)
  x = (rng.randn(*shape) * 5).astype(np.float32)
  if holes:
    x[:, ..., 1, 3:5, 7] = np.nan
    x[:, ..., 0, 0, 0] = np.nan
  return x


def _close(got, ref, tol):
  got, ref = np.asarray(got), np.asarray(ref)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  assert np.nanmax(np.abs(got - ref)) < tol


def _cfg(pair=False, **kw):
  base = dict(dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=STRIDE,
              num_iters=50, max_iters=300, stop_v_max=0.005, dt_max=100.0)
  base.update(kw)
  jc, tc = jmesh.IntegrationConfig(**base), tmesh.IntegrationConfig(**base)
  return (jc, tc) if pair else tc


class TestForce3d:

  @pytest.mark.parametrize('prefer', [False, True])
  def test_matches_xla_and_pallas(self, prefer):
    x = _positions((3, 5, 20, 24), 4)
    ref = np.asarray(jmesh.elastic_mesh_3d(jnp.asarray(x), 0.1, STRIDE,
                                           prefer_orig_order=prefer))
    pal = np.asarray(pallas_mesh.elastic_mesh_3d_pallas(
        jnp.asarray(x), 0.1, STRIDE, prefer_orig_order=prefer, tile=16,
        interpret=True, link_loop=True))
    got = tmesh.elastic_mesh_3d(torch.from_numpy(x), 0.1, STRIDE,
                                prefer).numpy()
    _close(got, ref, 1e-4)
    _close(got, pal, 1e-4)

  def test_batch_axes_and_scalar_stride(self):
    x = _positions((3, 2, 4, 10, 12), 5)
    ref = np.asarray(jmesh.elastic_mesh_3d(jnp.asarray(x), 0.1, 16.0))
    got = cuda_mesh.force_3d(torch.from_numpy(x), 0.1, 16.0).numpy()
    _close(got, ref, 1e-4)

  def test_other_links_raise(self):
    x = torch.zeros(3, 2, 3, 3)
    with pytest.raises(NotImplementedError):
      tmesh.elastic_mesh_3d(x, 0.1, STRIDE, links=((1, 0, 0),))


class TestStagedSolver3d:

  def test_velocity_verlet(self):
    x = _positions((3, 4, 8, 10), 6, holes=False) * 0.2
    prev = np.zeros_like(x)
    jc, tc = _cfg(pair=True, num_iters=60)
    ref = jmesh.velocity_verlet(jnp.asarray(x), jnp.zeros_like(x),
                                jnp.asarray(prev), jc, force_cap=1e6,
                                mesh_force=jmesh.elastic_mesh_3d)
    got = tmesh.velocity_verlet(torch.from_numpy(x), torch.zeros(x.shape),
                                torch.from_numpy(prev), tc, 1e6,
                                mesh_force=tmesh.elastic_mesh_3d)
    for r, g in zip(ref[:3], got[:3]):
      _close(g.numpy(), r, 1e-3)
    assert abs(float(ref[3]) - float(got[3])) <= 1e-6 * float(ref[3])
    assert int(ref[5]) == int(got[5])

  @pytest.mark.parametrize('prefer', [False, True])
  def test_relax_mesh(self, prefer):
    rng = np.random.RandomState(2)
    prev = np.full((3, 6, 10, 10), np.nan, np.float32)
    prev[:, 1:-1, 2:-2, 2:-2] = rng.randn(3, 4, 6, 6).astype(np.float32) * 3
    x0 = np.zeros_like(prev)
    jc, tc = _cfg(pair=True, num_iters=100, max_iters=1000,
                  start_cap=0.01, final_cap=10.0, cap_scale=1.1,
                  prefer_orig_order=prefer)
    ref, ref_e, ref_t = jmesh.relax_mesh(jnp.asarray(x0), jnp.asarray(prev),
                                         jc, mesh_force=jmesh.elastic_mesh_3d)
    got, got_e, got_t = tmesh.relax_mesh(
        torch.from_numpy(x0), torch.from_numpy(prev), tc,
        mesh_force=tmesh.elastic_mesh_3d)
    assert got_t == ref_t
    _close(got.numpy(), ref, 1e-3)
    np.testing.assert_allclose(got_e, ref_e, rtol=1e-3, atol=1e-9)

  def test_relax_mesh_places_host_input(self):
    x0 = np.zeros((3, 2, 3, 3), np.float32)
    tc = _cfg(num_iters=5, max_iters=5)
    if not torch.cuda.is_available():
      with pytest.raises(RuntimeError, match='device="cpu"'):
        tmesh.relax_mesh(x0, x0 + 1.0, tc, mesh_force=tmesh.elastic_mesh_3d)
    got, _, t = tmesh.relax_mesh(x0, x0 + 1.0, tc,
                                 mesh_force=tmesh.elastic_mesh_3d,
                                 device='cpu')
    assert got.device.type == 'cpu' and t == 5


class TestFused3d:

  def _setup(self, **kw):
    rng = np.random.RandomState(2)
    g = 10
    prev = np.full((3, 6, g, g), np.nan, np.float32)
    prev[:, 1:-1, 2:-2, 2:-2] = rng.randn(3, 4, g - 4, g - 4).astype(
        np.float32) * 3
    base = dict(stride=(40.0, 40.0, 40.0), num_iters=100, max_iters=1000,
                start_cap=0.01, final_cap=10.0, cap_scale=1.1)
    base.update(kw)
    jc, tc = _cfg(pair=True, **base)
    return np.zeros_like(prev), prev, jc, tc

  @pytest.mark.parametrize('prefer', [False, True])
  def test_matches_pallas_kernel(self, prefer):
    x0, prev, jc, tc = self._setup(prefer_orig_order=prefer)
    ref, ref_e, ref_steps = pallas_mesh.relax_mesh_fused_pallas_3d(
        jnp.asarray(x0), jnp.asarray(prev), jc, interpret=True)
    got, got_e, got_steps = cuda_mesh.relax_mesh_fused_3d(
        torch.from_numpy(x0), torch.from_numpy(prev), tc)
    assert int(got_steps) == int(ref_steps)
    _close(got.numpy(), ref, 1e-3)
    n = int(ref_steps) // tc.num_iters
    np.testing.assert_allclose(got_e.numpy()[:n], np.asarray(ref_e)[:n],
                               rtol=1e-3)

  def test_nan_nodes_no_prev_anisotropic(self):
    rng = np.random.RandomState(7)
    x0 = rng.randn(3, 4, 12, 16).astype(np.float32) * 3
    x0[:, 2, 5, 7] = np.nan
    jc, tc = _cfg(pair=True, num_iters=50, max_iters=300)
    ref, _, ref_steps = pallas_mesh.relax_mesh_fused_pallas_3d(
        jnp.asarray(x0), None, jc, interpret=True)
    got, _, got_steps = cuda_mesh.relax_mesh_fused_3d(
        torch.from_numpy(x0), None, tc)
    assert int(got_steps) == int(ref_steps)
    _close(got.numpy(), ref, 1e-3)

  def test_unsupported_configs_raise(self):
    x0, prev, _, tc = self._setup(remove_drift=True)
    with pytest.raises(NotImplementedError):
      cuda_mesh.relax_mesh_fused_3d(torch.from_numpy(x0),
                                    torch.from_numpy(prev), tc)
    x0, prev, _, tc = self._setup(fire=False)
    with pytest.raises(NotImplementedError):
      cuda_mesh.relax_mesh_fused_3d(torch.from_numpy(x0),
                                    torch.from_numpy(prev), tc)
