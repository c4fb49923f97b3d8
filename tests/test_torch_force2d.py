"""Kernel K8's plain version and the staged 2d solver against sofima_tpu.

K8 (ops.cuda_mesh.force_2d, the 8-neighbour in-plane force; its plain
version is mesh.inplane_force_plain) on batched [2, z, y, x] meshes with
NaN holes, both force forms, against JAX's mesh.inplane_force and the
Pallas kernel pallas_mesh.inplane_force_pallas in interpret mode; the
zero-length-link convention; and the staged solvers that call it
(velocity_verlet, relax_mesh, relax_mesh_fused with drift removal)
against JAX's.

Tolerances: forces within 1e-5 (float32 evaluation order; forces are
O(1)); solver states within 1e-3 px (tests/test_pallas_mesh.py's bar for
a solver), step counts equal.
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
STRIDE = (40.0, 30.0)
FORCE_TOL = 1e-5
MESH_TOL = 1e-3


def _mesh(shape=(2, 2, 20, 27), seed=0, holes=True):
  rng = np.random.RandomState(seed)
  x = (rng.randn(*shape) * 3).astype(np.float32)
  if holes:
    x[:, 0, 5, 7] = np.nan
    x[:, -1, 0, 3:6] = np.nan
    x[:, -1, 12:14, -1] = np.nan
  return x


def _cfg(module, **kw):
  base = dict(dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=STRIDE,
              num_iters=100, max_iters=400, stop_v_max=0.005, dt_max=100.0)
  base.update(kw)
  return module.IntegrationConfig(**base)


@pytest.mark.parametrize('prefer', [False, True])
def test_force_matches_xla_and_pallas(prefer):
  x = _mesh()
  ref = np.asarray(jmesh.inplane_force(jnp.asarray(x), 0.1, STRIDE, prefer))
  pal = np.asarray(pallas_mesh.inplane_force_pallas(
      jnp.asarray(x), 0.1, STRIDE, prefer, interpret=True))
  got = cuda_mesh.force_2d(torch.from_numpy(x), 0.1, STRIDE, prefer).numpy()
  assert np.isfinite(got).all() and np.isfinite(ref).all()
  np.testing.assert_allclose(got, ref, atol=FORCE_TOL, rtol=0)
  np.testing.assert_allclose(got, pal, atol=FORCE_TOL, rtol=0)
  # mesh.inplane_force takes the plain version for CPU tensors.
  torch.testing.assert_close(
      tmesh.inplane_force(torch.from_numpy(x), 0.1, STRIDE, prefer),
      torch.from_numpy(got), rtol=0, atol=0)


def test_extra_batch_axes():
  # [2, a, b, y, x]: every leading axis is a batch of meshes.
  x = _mesh((2, 2, 3, 9, 11), seed=1, holes=False)
  got = tmesh.inplane_force(torch.from_numpy(x), 0.1, STRIDE)
  flat = tmesh.inplane_force(torch.from_numpy(x.reshape(2, 6, 9, 11)), 0.1,
                             STRIDE)
  torch.testing.assert_close(got.reshape(2, 6, 9, 11), flat, rtol=0, atol=0)


@pytest.mark.parametrize('prefer', [False, True])
def test_coincident_link_adds_nothing(prefer):
  # Node (4, 6) sits exactly on node (4, 7): their link has zero length.
  # mesh.inplane_force (XLA) maps that link's NaN force to 0; the Pallas
  # body gates on isfinite(|d|^2) and adds NaN. K8 follows the former.
  x = np.zeros((2, 1, 10, 12), np.float32)
  x[:, 0, 2, 2] = (3.0, -2.0)
  x[0, 0, 4, 6] = STRIDE[0]
  ref = np.asarray(jmesh.inplane_force(jnp.asarray(x), 0.1, STRIDE, prefer))
  pal = np.asarray(pallas_mesh.inplane_force_pallas(
      jnp.asarray(x), 0.1, STRIDE, prefer, interpret=True))
  got = cuda_mesh.force_2d(torch.from_numpy(x), 0.1, STRIDE, prefer).numpy()
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, ref, atol=FORCE_TOL, rtol=0)
  assert np.isnan(pal[:, 0, 4, 6:8]).all()
  fin = np.isfinite(pal)
  np.testing.assert_allclose(got[fin], pal[fin], atol=FORCE_TOL, rtol=0)


@pytest.mark.parametrize('prefer', [False, True])
def test_velocity_verlet(prefer):
  x = _mesh((2, 1, 16, 18), seed=2)
  prev = np.zeros_like(x)
  jc = _cfg(jmesh, prefer_orig_order=prefer)
  tc = _cfg(tmesh, prefer_orig_order=prefer)
  ref = jmesh.velocity_verlet(jnp.asarray(x), jnp.zeros_like(x),
                              jnp.asarray(prev), jc, force_cap=1e6)
  got = tmesh.velocity_verlet(torch.from_numpy(x), torch.zeros(x.shape),
                              torch.from_numpy(prev), tc, force_cap=1e6)
  for r, g in zip(ref[:3], got[:3]):
    r, g = np.asarray(r), g.numpy()
    np.testing.assert_array_equal(np.isnan(g), np.isnan(r))
    assert np.nanmax(np.abs(g - r)) < MESH_TOL
  for r, g in zip(ref[3:], got[3:]):  # dt, alpha, n_pos, cap
    np.testing.assert_allclose(float(g), float(r), rtol=1e-5)


def test_relax_mesh():
  x = _mesh((2, 1, 14, 14), seed=3)
  prev = np.nan_to_num(_mesh((2, 1, 14, 14), seed=4) * 0.5)
  jc = _cfg(jmesh, start_cap=0.01, final_cap=1.0, cap_scale=1.5)
  tc = _cfg(tmesh, start_cap=0.01, final_cap=1.0, cap_scale=1.5)
  ref, ref_e, ref_t = jmesh.relax_mesh(jnp.asarray(x), jnp.asarray(prev), jc)
  got, got_e, got_t = tmesh.relax_mesh(torch.from_numpy(x),
                                       torch.from_numpy(prev), tc)
  assert got_t == ref_t
  np.testing.assert_allclose(got_e, ref_e, rtol=1e-3)
  ref, got = np.asarray(ref), got.numpy()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  assert np.nanmax(np.abs(got - ref)) < MESH_TOL


@pytest.mark.parametrize('prefer', [False, True])
def test_relax_mesh_fused_drift_removal(prefer):
  # The staged solver that the stack solve runs for remove_drift.
  rng = np.random.RandomState(5)
  prev = np.full((2, 1, 16, 16), np.nan, np.float32)
  prev[:, :, 2:-2, 2:-2] = rng.randn(2, 1, 12, 12) * 3 + 1.5
  x0 = np.nan_to_num(prev)
  kw = dict(k0=0.1, num_iters=125, max_iters=2000, start_cap=10.0,
            final_cap=10.0, prefer_orig_order=prefer, remove_drift=True)
  ref, _, ref_t = jmesh.relax_mesh_fused(jnp.asarray(x0), jnp.asarray(prev),
                                         _cfg(jmesh, **kw))
  got, _, got_t = tmesh.relax_mesh_fused(torch.from_numpy(x0),
                                         torch.from_numpy(prev),
                                         _cfg(tmesh, **kw))
  assert int(got_t) == int(ref_t)
  ref, got = np.asarray(ref), got.numpy()
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  assert np.nanmax(np.abs(got - ref)) < MESH_TOL
  # Drift removal keeps the mesh centred.
  assert np.abs(np.nanmean(got, axis=(1, 2, 3))).max() < 1e-3


def test_wrapper_contract():
  with pytest.raises(ValueError):
    cuda_mesh.force_2d(torch.zeros(3, 1, 4, 4), 0.1, STRIDE)
  with pytest.raises(ValueError):
    tmesh.inplane_force(torch.zeros(2, 1, 4, 4), 0.1, (40.0, 40.0, 40.0))
