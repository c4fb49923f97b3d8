"""Mesh solver of sofima_tpu_torch against sofima_tpu (CPU, plain versions).

K3 (ops.cuda_mesh.relax_mesh_fused, the fused FIRE solver) on the setup
of tests/test_pallas_mesh.py::TestFusedFireSolver, with and without
`prev`, against pallas_mesh.relax_mesh_fused_pallas in interpret mode;
the plain staged solver and the in-plane force against sofima_tpu.mesh.
Tolerance (as tests/test_pallas_mesh.py holds the Pallas kernel): step
counts equal, NaN pattern equal, max |dx| < 1e-3 px.
"""

import dataclasses

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


# K3 / K11's launch plan (ops.cuda_mesh.fire_plan) and a model of the
# kernel's tiling (csrc/fire.cu), on the card's shapes and awkward ones.
# The card's co-residency is modelled as the H100's 132 SMs, at most two
# blocks each (the kernel's launch bounds) and 228 KB of shared memory.
PLAN_SHAPES = [
    (2, (1, 250, 250)),   # K3: the stack path's and path (f)'s mesh
    (2, (1, 301, 283)),   # two nodes a thread
    (2, (1, 97, 1500)),   # four, elongated
    (2, (1, 1000, 999)),  # sixteen
    (2, (1, 3, 5)),
    (2, (1, 37, 71)),
    (2, (1, 1, 40)),      # one node wide
    (2, (1, 40, 1)),
    (3, (8, 128, 256)),   # K11: bench.py's mesh3d_fused mesh
    (3, (1, 3, 5)),
    (3, (5, 37, 71)),
    (3, (1, 1, 9)),       # one node wide
    (3, (6, 20, 24)),
]


def _h100_blocks(smem):
  return 132 * min(2, (228 * 1024) // (smem + 1024))


def _tile_model(dim, shape, plan):
  """The kernel's index arithmetic, tile by tile: yields (own mesh index,
  own box index, {face word: mesh index} that the tile publishes, halo
  mesh index, halo box index, halo face word, box shape) as `own`,
  `publish` and `halo` of fused_fire_kernel compute them. A face word is
  the block's slot base plus the slot: block * 3 * dim * nf + slot."""
  nz, gy, gx = shape
  tz, ty, tx = plan.tile
  sy, sx = ty.bit_length() - 1, tx.bit_length() - 1
  h = 1 if dim == 3 else 0
  bz, by, bx = tz + 2 * h, ty + 2, tx + 2
  ntz, nty, ntx = plan.tiles
  fx, fy, fz = tz * ty, tz * tx, ty * tx
  nf = 2 * (fx + fy) + (2 * fz if dim == 3 else 0)
  l = np.arange(tz * ty * tx)
  lx, ly, lz = l & (tx - 1), (l >> sx) & (ty - 1), l >> (sx + sy)
  hb = np.arange(bz * by * bx)
  hx, hy, hz = hb % bx, hb // bx % by, hb // (bx * by)
  inner = ((hx >= 1) & (hx <= tx) & (hy >= 1) & (hy <= ty) & (hz >= h)
           & (hz < tz + h))
  for b in range(plan.nblocks):
    oz, oy, ox = b // (nty * ntx) * tz, b // ntx % nty * ty, b % ntx * tx
    z, y, x = oz + lz, oy + ly, ox + lx
    ok = (z < nz) & (y < gy) & (x < gx)
    node = (z * gy + y) * gx + x
    bi = ((lz + h) * by + ly + 1) * bx + lx + 1
    faces = [((lx == 0) & (x > 0), lz * ty + ly),
             ((lx == tx - 1) & (x < gx - 1), fx + lz * ty + ly),
             ((ly == 0) & (y > 0), 2 * fx + lz * tx + lx),
             ((ly == ty - 1) & (y < gy - 1), 2 * fx + fy + lz * tx + lx)]
    if dim == 3:
      faces += [((lz == 0) & (z > 0), 2 * (fx + fy) + ly * tx + lx),
                ((lz == tz - 1) & (z < nz - 1),
                 2 * (fx + fy) + fz + ly * tx + lx)]
    published = {}
    for on, slot in faces:
      on = on & ok
      published.update(zip(b * 3 * dim * nf + slot[on], node[on]))
    qz, qy, qx = oz + hz - h, oy + hy - 1, ox + hx - 1
    on = (~inner & (qz >= 0) & (qz < nz) & (qy >= 0) & (qy < gy)
          & (qx >= 0) & (qx < gx))
    qz, qy, qx, hbo = qz[on], qy[on], qx[on], hb[on]
    owner = ((qz // tz) * nty + (qy >> sy)) * ntx + (qx >> sx)
    mz, my, mx = qz - qz // tz * tz, qy & (ty - 1), qx & (tx - 1)
    slot = np.select(
        [qx < ox, qx >= ox + tx, qy < oy, qy >= oy + ty, qz < oz],
        [fx + mz * ty + my, mz * ty + my, 2 * fx + fy + mz * tx + mx,
         2 * fx + mz * tx + mx, 2 * (fx + fy) + fz + my * tx + mx],
        2 * (fx + fy) + my * tx + mx)
    yield (node[ok], bi[ok], published, (qz * gy + qy) * gx + qx, hbo,
           owner * 3 * dim * nf + slot, (bz, by, bx))


def _offsets(dim):
  return [(ez, ey, ex) for ez in ((-1, 0, 1) if dim == 3 else (0,))
          for ey in (-1, 0, 1) for ex in (-1, 0, 1) if (ez, ey, ex) != (0,) * 3]


@pytest.mark.parametrize('dim, shape', PLAN_SHAPES)
def test_fire_plan_tiling_model(dim, shape):
  """Every node is owned once; every neighbour a node's force reads is in
  its block's box, as the owner's own entry or as a halo entry the owner
  publishes; shared memory fits; all blocks are resident at once."""
  plan = cuda_mesh.fire_plan(dim, shape, _h100_blocks)
  tz, ty, tx = plan.tile
  assert tz * ty * tx == cuda_mesh.FIRE_THREADS * plan.npt
  assert ty & (ty - 1) == 0 and tx & (tx - 1) == 0 and (dim == 3 or tz == 1)
  assert plan.smem_bytes == cuda_mesh.fire_smem_bytes(dim, plan.tile)
  assert plan.smem_bytes <= 227 * 1024
  assert plan.nblocks <= _h100_blocks(plan.smem_bytes)
  nz, gy, gx = shape
  n = nz * gy * gx
  owned = np.zeros(n, np.int64)
  published = {}
  halo_read, halo_total = [], 0
  for own, bi, faces, hidx, hbox, hword, (bz, by, bx) in _tile_model(
      dim, shape, plan):
    owned[own] += 1
    assert not set(faces) & set(published)  # each face slot, one writer
    published.update(faces)
    halo_read.append((hword, hidx))
    halo_total += hidx.size
    box = np.full(bz * by * bx, -1)
    box[bi] = own
    box[hbox] = hidx
    z, y, x = own // (gy * gx), own // gx % gy, own % gx
    for ez, ey, ex in _offsets(dim):
      qz, qy, qx = z + ez, y + ey, x + ex
      on = ((qz >= 0) & (qz < nz) & (qy >= 0) & (qy < gy) & (qx >= 0)
            & (qx < gx))
      read = box[(bi + (ez * by + ey) * bx + ex)[on]]
      np.testing.assert_array_equal(read, ((qz * gy + qy) * gx + qx)[on])
  np.testing.assert_array_equal(owned, 1)
  # Every halo entry reads a face slot that its owner writes, with the
  # same node, inside the buffer the wrapper allocates.
  per_set = cuda_mesh.fire_pub_words(dim, plan) // 2
  nf = per_set // plan.nblocks // (3 * dim)
  for hword, hidx in halo_read:
    assert [published.get(w) for w in hword] == list(hidx)
    assert (hword + (3 * dim - 1) * nf < per_set).all()
  assert halo_total == cuda_mesh.fire_halo_nodes(dim, shape, plan.tile)


def test_fire_plan_sizes():
  # The card's shapes take one node per thread (K3) and four (K11);
  # larger 2d meshes take more; a mesh beyond what the card holds at once
  # raises (the reference's VMEM bound: 786 432 nodes in 2d, 524 288 in
  # 3d).
  k3 = cuda_mesh.fire_plan(2, (1, 250, 250), _h100_blocks)
  assert (k3.npt, k3.tile, k3.nblocks) == (1, (1, 16, 16), 256)
  k11 = cuda_mesh.fire_plan(3, (8, 128, 256), _h100_blocks)
  assert (k11.npt, k11.nblocks) == (4, 256)
  npts = [cuda_mesh.fire_plan(2, s, _h100_blocks).npt for s in
          ((1, 301, 283), (1, 97, 1500), (1, 700, 650), (1, 1000, 999))]
  assert npts == [2, 4, 8, 16]
  for dim, shape in ((2, (1, 2048, 2048)), (2, (1, 100, 4800)),
                     (3, (8, 128, 272))):
    with pytest.raises(ValueError, match='does not fit'):
      cuda_mesh.fire_plan(dim, shape, _h100_blocks)
  # The fused solvers take what the reference's do (its `fits_vmem`), on
  # every device: 250^2 yes, 4096^2 no.
  assert cuda_mesh.fused_fits(torch.zeros(2, 1, 250, 250), _setup()[3])
  assert not cuda_mesh.fused_fits(torch.zeros(2, 1, 4096, 4096),
                                  _setup()[3])


def _tiled_step(dim, x, v, a, prev, cfg, plan, force, dt, alpha, cap):
  """One FIRE step as the kernel's blocks take it: each tile advances its
  own nodes and its halo (the halo's x, v, a read from what tile-face
  nodes publish; every other node publishes nothing), computes the force
  of its own nodes on that window and their Verlet velocity and mixing,
  and a power partial; the partials are summed in float64."""
  shape = x.shape[1:]
  nz, gy, gx = (1,) * (4 - x.ndim) + tuple(shape)
  flat = lambda t: t.reshape(dim, -1)
  pub = torch.full((3, dim, nz * gy * gx), 1e30)
  x_n, v_n, a_n = (torch.full_like(flat(x), float('nan')) for _ in range(3))
  tiles = list(_tile_model(dim, (nz, gy, gx), plan))
  for own, _, faces, _, _, _, _ in tiles:
    face_nodes = np.asarray(list(faces.values()), np.int64)
    for k, t in enumerate((x, v, a)):
      pub[k][:, face_nodes] = flat(t)[:, face_nodes]
  half_dt2 = 0.5 * dt * dt
  d_in = 1.0 / (1.0 + 0.5 * dt * cfg.gamma)
  d_out = 1.0 - 0.5 * dt * cfg.gamma
  power = 0.0
  tz, ty, tx = plan.tile
  for b, (own, _, _, hidx, _, _, _) in enumerate(tiles):
    if own.size == 0:
      continue
    # The window: the tile's box clipped to the mesh.
    ntz, nty, ntx = plan.tiles
    oz, oy, ox = b // (nty * ntx) * tz, b // ntx % nty * ty, b % ntx * tx
    hz = 1 if dim == 3 else 0
    z0, z1 = max(oz - hz, 0), min(oz + tz + hz, nz)
    y0, y1 = max(oy - 1, 0), min(oy + ty + 1, gy)
    x0, x1 = max(ox - 1, 0), min(ox + tx + 1, gx)
    zz, yy, xx = np.meshgrid(np.arange(z0, z1), np.arange(y0, y1),
                             np.arange(x0, x1), indexing='ij')
    win = ((zz * gy + yy) * gx + xx).ravel()
    is_own = np.isin(win, own)
    is_halo = np.isin(win, hidx)
    assert (is_own | is_halo).all()
    wx, wv, wa = (torch.empty(dim, win.size) for _ in range(3))
    for k, (w, t) in enumerate(((wx, x), (wv, v), (wa, a))):
      w[:, is_own] = flat(t)[:, win[is_own]]
      w[:, is_halo] = pub[k][:, win[is_halo]]
    wshape = (dim,) + ((z1 - z0,) if dim == 3 else ()) + (y1 - y0, x1 - x0)
    wx, wv, wa = (t.reshape(wshape) for t in (wx, wv, wa))
    wp = None if prev is None else flat(prev)[:, win].reshape(wshape)
    xw = wx + dt * wv + half_dt2 * wa  # own nodes and the halo
    f = force(xw, wp, cap)
    vn = d_in * (wv * d_out + 0.5 * dt * (wa + f))
    a_norm = torch.linalg.vector_norm(f, dim=0, keepdim=True) + 1e-6
    v_norm = torch.linalg.vector_norm(vn, dim=0, keepdim=True)
    vm = vn + alpha * (f / a_norm * v_norm - vn)
    sel = torch.from_numpy(is_own)
    power += float(torch.sum((f * vn).reshape(dim, -1)[:, sel],
                             dtype=torch.float64))
    for dst, t in ((x_n, xw), (v_n, vm), (a_n, f)):
      dst[:, win[is_own]] = t.reshape(dim, -1)[:, sel]
  return (x_n.reshape(x.shape), v_n.reshape(x.shape), a_n.reshape(x.shape),
          power)


def _model_state(dim, shape, seed):
  rng = np.random.RandomState(seed)
  x = rng.randn(dim, *shape).astype(np.float32) * 3
  holes = rng.rand(*shape) < 0.05
  holes.reshape(-1)[7] = True  # a hole on a tile edge
  x[:, holes] = np.nan
  v = rng.randn(dim, *shape).astype(np.float32) * 0.2
  a = rng.randn(dim, *shape).astype(np.float32) * 0.5
  v[:, holes] = a[:, holes] = 0.0
  prev = x + rng.randn(dim, *shape).astype(np.float32)
  prev[:, rng.rand(*shape) < 0.05] = np.nan
  return (torch.from_numpy(t) for t in (x, v, a, prev))


@pytest.mark.parametrize('dim, shape', [(2, (37, 71)), (3, (5, 13, 21))])
def test_fire_tiled_step_model(dim, shape):
  """One step through the tiled model equals one plain solver step bit for
  bit (positions, velocities, accelerations; the power to float64
  rounding), on a seeded mesh with NaN holes, one node per thread."""
  cfg = tmesh.IntegrationConfig(
      dt=0.01, gamma=0.1, k0=0.1, k=0.1, stride=(40.0,) * dim,
      num_iters=10, max_iters=100, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.5, final_cap=10.0, cap_scale=1.1, prefer_orig_order=True)
  x, v, a, prev = _model_state(dim, shape, seed=dim)
  if dim == 2:
    nodes = (1,) + shape
    pad = (1, 1, 1, 1)
    force_fn = lambda xx, k, s, po: cuda_mesh.roll_force_2d(xx, k, s, po)
    # The plain 2d solver's NaN guard ring, on every window.
    def force(xw, pw, cap):
      fw = plain_force(torch.nn.functional.pad(xw, pad, value=float('nan')),
                       None if pw is None else torch.nn.functional.pad(
                           pw, pad, value=float('nan')), cap)
      return fw[:, 1:-1, 1:-1]
  else:
    nodes = shape
    force_fn = tmesh.elastic_mesh_3d_plain
    force = lambda xw, pw, cap: plain_force(xw, pw, cap)
  plain_force, vv_step, fire_step = tmesh._make_step_fns(cfg, force_fn)
  plan = cuda_mesh.fire_plan(dim, nodes, _h100_blocks)
  assert plan.npt == 1 and plan.nblocks > 4
  dt, alpha, cap = (torch.tensor(c, dtype=torch.float32)
                    for c in (0.02, 0.1, 0.5))
  got_x, got_v, got_a, got_p = _tiled_step(dim, x, v, a, prev, cfg, plan,
                                           force, dt, alpha, cap)
  # The plain solver's step (on the 2d solver's padded state).
  state = (x, v, a, dt, alpha, torch.tensor(0, dtype=torch.int32), cap)
  if dim == 2:  # the ring: NaN positions, zero velocity and force
    state = tuple(torch.nn.functional.pad(
        t, pad, value=float('nan') if i == 0 else 0.0) if i < 3 else t
                  for i, t in enumerate(state))
    p_prev = torch.nn.functional.pad(prev, pad, value=float('nan'))
  else:
    p_prev = prev
  ref = fire_step(state, p_prev)
  xv = vv_step(state[:3], dt, cap, p_prev)
  power = float(torch.sum(xv[2] * xv[1]))
  ref_x, ref_v, ref_a = ref[:3]
  if dim == 2:
    ref_x, ref_v, ref_a = (t[:, 1:-1, 1:-1] for t in (ref_x, ref_v, ref_a))
  same = lambda p, q: torch.equal(p.view(torch.int32), q.view(torch.int32))
  assert same(got_x, ref_x) and same(got_a, ref_a)
  assert same(got_v * (power >= 0), ref_v)
  assert np.isnan(got_x.numpy()).any()
  np.testing.assert_allclose(got_p, power, rtol=1e-5)


def test_solve_phase_takes_staged_solver_when_fused_does_not_fit(
    monkeypatch):
  """A mesh the fused solver cannot hold on the card (fused_fits False)
  goes to the staged solver, as the reference's stack pipeline does above
  its VMEM bound; the fused solver is not called."""
  from sofima_tpu_torch.pipeline import stack_align as tsa
  cfg = tsa.StackAlignConfig()
  cfg = dataclasses.replace(cfg, mesh=dataclasses.replace(
      cfg.mesh, num_iters=20, max_iters=60))
  rng = np.random.RandomState(5)
  flow = torch.from_numpy(rng.randn(2, 1, 12, 12).astype(np.float32))
  flow[:, :, 3, 4] = float('nan')
  solved_prev = torch.from_numpy(
      rng.randn(2, 1, 12, 12).astype(np.float32) * 0.5)
  fused_ref = tsa._solve_phase(flow, solved_prev, cfg)  # fits on the CPU
  asked, staged = [], []
  real_staged = tmesh.relax_mesh_fused

  def spy(x, prev, config):
    staged.append(real_staged(x, prev, config))
    return staged[-1]

  monkeypatch.setattr(cuda_mesh, 'fused_fits',
                      lambda x, c: asked.append(tuple(x.shape)) or False)
  monkeypatch.setattr(tmesh, 'relax_mesh_fused', spy)
  monkeypatch.setattr(cuda_mesh, 'relax_mesh_fused',
                      lambda *a: pytest.fail('the fused solver ran'))
  got = tsa._solve_phase(flow, solved_prev, cfg)
  assert asked == [(2, 1, 12, 12)] and len(staged) == 1
  assert got is staged[0][0]
  assert torch.equal(torch.isnan(got), torch.isnan(fused_ref))
  assert float(torch.nan_to_num((got - fused_ref).abs()).max()) < 0.4


# The fused solvers' routes at the edges of the H100's resident bound and
# of the reference's VMEM bound (786 432 nodes in 2d, 524 288 in 3d):
# (dim, nodes, route) with route 'tiled', 'grid' (the grid-stride kernel)
# or 'raise'.
ROUTE_EDGES = [
    (2, (1, 250, 250), 'tiled'),    # the stack path's and path (f)'s mesh
    (2, (1, 886, 886), 'tiled'),    # the largest square under the bound
    (2, (1, 768, 1024), 'tiled'),   # exactly the bound
    (2, (1, 100, 4700), 'tiled'),
    (2, (1, 100, 4800), 'grid'),    # elongated: no tiling fits the card
    (2, (1, 100, 7000), 'grid'),
    (2, (1, 100, 7865), 'raise'),   # one row of nodes over the bound
    (2, (1, 887, 887), 'raise'),
    (3, (8, 128, 256), 'tiled'),    # bench.py's mesh3d_fused mesh
    (3, (8, 128, 272), 'grid'),
    (3, (8, 256, 256), 'grid'),     # exactly the bound
    (3, (8, 256, 257), 'raise'),
]


def _reference_takes(dim, nodes):
  """Whether the reference's fused solver takes the mesh: its own size
  check, traced (jax.eval_shape) and not run."""
  kw = dict(dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
            num_iters=100, max_iters=200, stop_v_max=0.0, dt_max=100.0)
  cfg = jmesh.IntegrationConfig(**kw)
  solve = (pallas_mesh.relax_mesh_fused_pallas if dim == 2
           else pallas_mesh.relax_mesh_fused_pallas_3d)
  shape = (dim,) + nodes
  try:
    jax.eval_shape(lambda x: solve(x, None, cfg, interpret=True),
                   jax.ShapeDtypeStruct(shape, jnp.float32))
  except ValueError as e:
    assert str(e) == cuda_mesh.VMEM_MESSAGE
    return False
  return True


@pytest.mark.parametrize('dim, nodes, route', ROUTE_EDGES)
def test_fused_route(dim, nodes, route):
  """relax_mesh_fused{,_3d} take the tiled kernel where its tiles fit the
  card, the grid-stride kernel up to the reference's VMEM bound, and
  raise the reference's ValueError above it, as the reference does."""
  shape = nodes
  assert _reference_takes(dim, nodes) == (route != 'raise')
  if route == 'raise':
    with pytest.raises(ValueError, match=cuda_mesh.VMEM_MESSAGE):
      cuda_mesh.fire_route(dim, shape, _h100_blocks)
    cfg = tmesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
        num_iters=10, max_iters=10, stop_v_max=0.0)
    x = torch.zeros((dim,) + shape)  # the entries check before any work
    solve = (cuda_mesh.relax_mesh_fused if dim == 2
             else cuda_mesh.relax_mesh_fused_3d)
    with pytest.raises(ValueError, match=cuda_mesh.VMEM_MESSAGE):
      solve(x, None, cfg)
    assert not cuda_mesh.fused_fits(x, cfg)
    return
  plan = cuda_mesh.fire_route(dim, shape, _h100_blocks)
  assert (plan is None) == (route == 'grid')
  cfg = tmesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0,) * dim,
      num_iters=10, max_iters=10, stop_v_max=0.0)
  assert cuda_mesh.fused_fits(torch.zeros((dim,) + shape), cfg)
  assert not cuda_mesh.fused_fits(torch.zeros((dim,) + shape),
                                  dataclasses.replace(cfg, remove_drift=True))
  if plan is not None:
    assert plan == cuda_mesh.fire_plan(dim, shape, _h100_blocks)
  else:
    with pytest.raises(ValueError, match='does not fit'):
      cuda_mesh.fire_plan(dim, shape, _h100_blocks)


@pytest.mark.parametrize('grid_n', [886, 887])
def test_solve_phase_route_is_fits_vmem(monkeypatch, grid_n):
  """The stack pipeline's solve takes the fused solver exactly where the
  reference's `fits_vmem` (grid_n^2 * 32 <= 24 MiB) holds, and the staged
  one above it, on the CPU too."""
  from sofima_tpu_torch import map_utils
  from sofima_tpu_torch.pipeline import stack_align as tsa
  fits_vmem = grid_n * grid_n * 32 <= 24 * 1024 * 1024
  took = []
  monkeypatch.setattr(map_utils, 'compose_maps_fast',
                      lambda f, *a: torch.zeros_like(f))
  monkeypatch.setattr(tmesh, 'relax_mesh_fused',
                      lambda x, p, c: took.append('staged') or (x, None, 0))
  monkeypatch.setattr(cuda_mesh, 'relax_mesh_fused',
                      lambda x, p, c: took.append('fused') or (x, None, 0))
  flow = torch.zeros(2, 1, grid_n, grid_n)
  tsa._solve_phase(flow, flow, tsa.StackAlignConfig())
  assert took == ['fused' if fits_vmem else 'staged']
  assert fits_vmem == (grid_n == 886)
