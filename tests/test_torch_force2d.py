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


# K8 on the card (csrc/force2d.cu) is a row-streaming stencil: each
# thread owns `nodes` consecutive nodes of a row in an x tile of `threads`
# threads, walks down a band of rows, takes its x halos from the
# neighbouring lanes of its warp or, at a warp's edge, from memory, and
# evaluates each link once: a row's E links serve both of their nodes,
# and its SE, S and SW links to the next row are kept for that row, which
# takes them negated. Each node sums its 8 links in force2d_node's (ey,
# ex) order. A numpy model of that walk, with tiles, warps and bands small
# enough that every edge shows (a ragged last tile, nx not a multiple of
# the 4-node vector, ragged bands, a batch axis, NaN holes), and at the
# kernel's own tile (128 threads of 4 nodes, warps of 32, bands of at
# least 4 rows), must give JAX's mesh.inplane_force and the plain version
# within FORCE_TOL.


def _link_model(d0, d1, ex, ey, l0, k_eff, prefer):
  """force2d.cu `link`: one link's force, nan_to_num'd."""
  with np.errstate(all='ignore'):
    inv_l = np.float32(1.0) / np.sqrt(d0 * d0 + d1 * d1)
    if prefer:
      fac0 = ex * np.sign(d0) if ex else np.float32(1.0)
      fac1 = ey * np.sign(d1) if ey else np.float32(1.0)
      g = (k_eff * (1 - l0 * fac0 * inv_l) * d0,
           k_eff * (1 - l0 * fac1 * inv_l) * d1)
    else:
      coef = k_eff * (1 - l0 * inv_l)
      g = (coef * d0, coef * d1)
  return np.stack([np.where(np.isfinite(v), v, 0).astype(np.float32)
                   for v in g])


def _k8_model(x, k, stride, prefer, nodes, threads, warp, band):
  """K8's walk over [2, nb, ny, nx] positions -> forces."""
  _, nb, ny, nx = x.shape
  sx, sy = (np.float32(s) for s in stride)
  k = np.float32(k)
  kd = np.float32(k / np.sqrt(2.0))
  l0e, l0s = np.sqrt(sx * sx), np.sqrt(sy * sy)
  l0d = np.sqrt(sx * sx + sy * sy)
  lane = np.arange(threads) % warp
  out = np.full_like(x, np.nan)

  def view(b, y, x0):
    # Each thread's columns x0 - 1 .. x0 + nodes of row y, NaN off the
    # mesh; the halos from the neighbouring lanes or, at a warp's edge,
    # from memory.
    cols = x0[:, None] + np.arange(-1, nodes + 1)
    v = np.full((2,) + cols.shape, np.nan, np.float32)
    own = cols[:, 1:-1] < nx
    v[:, :, 1:-1][:, own] = x[:, b, y, cols[:, 1:-1][own]]
    v[:, :, 0] = np.roll(v[:, :, nodes], 1, axis=1)
    v[:, :, -1] = np.roll(v[:, :, 1], -1, axis=1)
    for t in np.flatnonzero(lane == 0):
      c = cols[t, 0]
      v[:, t, 0] = x[:, b, y, c] if 0 <= c < nx else np.nan
    for t in np.flatnonzero(lane == warp - 1):
      c = cols[t, -1]
      v[:, t, -1] = x[:, b, y, c] if c < nx else np.nan
    return v

  def step(d, lx, ly):
    return d[0] + lx, d[1] + ly

  def down(u, v):
    se = _link_model(*step(v[..., 1:] - u[..., :-1], sx, sy), 1, 1, l0d, kd,
                     prefer)
    s = _link_model(*step(v[..., 1:-1] - u[..., 1:-1], 0, sy), 0, 1, l0s, k,
                    prefer)
    sw = _link_model(*step(v[..., :-1] - u[..., 1:], -sx, sy), -1, 1, l0d,
                     kd, prefer)
    return se, s, sw

  def add(acc, mask, v, sign):
    return np.where(mask, acc + sign * v, acc)

  for b in range(nb):
    for t0 in range(0, nx, nodes * threads):
      x0 = t0 + np.arange(threads) * nodes
      col = x0[:, None] + np.arange(nodes)
      has_w, has_e = col > 0, col + 1 < nx
      for y0 in range(0, ny, band):
        c, up = view(b, y0, x0), None  # a band starts afresh
        if y0 > 0:
          up = down(view(b, y0 - 1, x0), c)
        for y in range(y0, min(y0 + band, ny)):
          acc = np.zeros((2, threads, nodes), np.float32)
          if y > 0:
            acc = add(acc, has_w, up[0][..., :nodes], -1)
            acc = add(acc, True, up[1], -1)
            acc = add(acc, has_e, up[2][..., 1:], -1)
          e = _link_model(*step(c[..., 1:] - c[..., :-1], sx, 0), 1, 0, l0e,
                          k, prefer)
          acc = add(acc, has_w, e[..., :nodes], -1)
          acc = add(acc, has_e, e[..., 1:], 1)
          if y + 1 < ny:
            n = view(b, y + 1, x0)
            up = down(c, n)
            acc = add(acc, has_w, up[2][..., :nodes], 1)
            acc = add(acc, True, up[1], 1)
            acc = add(acc, has_e, up[0][..., 1:], 1)
            c = n
          keep = col < nx
          out[:, b, y, col[keep]] = acc[:, keep]
  return out


@pytest.mark.parametrize('prefer', [False, True])
@pytest.mark.parametrize('shape,nodes,threads,warp,band', [
    ((2, 3, 13, 23), 4, 4, 2, 3),     # ragged tile and bands, nx % 4 = 3
    ((2, 2, 9, 32), 4, 2, 2, 4),      # four whole tiles, warp edges
    ((2, 1, 37, 70), 4, 128, 32, 4),  # the kernel's tile, one ragged
])
def test_k8_tiling_model(shape, nodes, threads, warp, band, prefer):
  x = _mesh(shape, seed=6)
  got = _k8_model(x, 0.1, STRIDE, prefer, nodes, threads, warp, band)
  assert np.isfinite(got).all()
  ref = np.asarray(jmesh.inplane_force(jnp.asarray(x), 0.1, STRIDE, prefer))
  plain = tmesh.inplane_force_plain(torch.from_numpy(x), 0.1, STRIDE,
                                    prefer).numpy()
  np.testing.assert_allclose(got, ref, atol=FORCE_TOL, rtol=0)
  np.testing.assert_allclose(got, plain, atol=FORCE_TOL, rtol=0)


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
