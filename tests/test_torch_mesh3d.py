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
    # A link beyond the 26-neighbourhood raises ValueError, as the
    # reference's.
    x = torch.zeros(3, 2, 3, 3)
    with pytest.raises(ValueError, match='components'):
      jmesh.elastic_mesh_3d(jnp.zeros(x.shape), 0.1, STRIDE,
                            links=((2, 0, 0),))
    with pytest.raises(ValueError, match='components'):
      tmesh.elastic_mesh_3d(x, 0.1, STRIDE, links=((2, 0, 0),))

  # A subset of the half-links, and the same springs with some links in
  # their negative form (a link and its negation are one spring).
  @pytest.mark.parametrize('links', [
      ((1, 0, 0), (0, 1, 0), (1, 1, 1), (0, 1, -1)),
      ((-1, 0, 0), (0, -1, 1), (1, 1, 1), (0, 0, -1), (1, -1, 1)),
  ])
  @pytest.mark.parametrize('prefer', [False, True])
  def test_links_match_xla(self, links, prefer):
    x = _positions((3, 5, 20, 24), 8)
    ref = np.asarray(jmesh.elastic_mesh_3d(jnp.asarray(x), 0.1, STRIDE,
                                           prefer, links=links))
    got = tmesh.elastic_mesh_3d(torch.from_numpy(x), 0.1, STRIDE, prefer,
                                links=links).numpy()
    _close(got, ref, 1e-4)
    # K9's table holds each spring once, in forward form.
    table = cuda_mesh._link_table(0.1, STRIDE, links)
    fwd = {cuda_mesh._forward(d) for d in links}
    assert len(table) == len(fwd)
    assert {tuple(int(c) for c in row[:3]) for row in table} == fwd


def test_link_table_cache():
  """K9's and K11's link tables are cached: the same arguments give the
  same (read-only) table, each argument is part of the key, and a link in
  either sign form gives the same row."""
  links = tmesh.MESH_LINK_DIRECTIONS
  t = cuda_mesh._link_table(0.1, STRIDE, links)
  assert cuda_mesh._link_table(0.1, STRIDE, links) is t
  assert not t.flags.writeable and t.shape == (13, 8)
  np.testing.assert_allclose(
      sorted(t[:, 7]), sorted(tmesh.link_constants_3d(0.1, STRIDE)),
      rtol=1e-6)
  for other in (cuda_mesh._link_table(0.2, STRIDE, links),
                cuda_mesh._link_table(0.1, (40.0, 30.0, 21.0), links),
                cuda_mesh._link_table(0.1, STRIDE, links[:12])):
    assert other is not t and not np.array_equal(other, t)
  neg = tuple(tuple(-c for c in d) for d in links)
  np.testing.assert_array_equal(cuda_mesh._link_table(0.1, STRIDE, neg), t)
  t26 = cuda_mesh._fire_link_table(0.1, STRIDE)
  assert cuda_mesh._fire_link_table(0.1, STRIDE) is t26
  assert t26.shape == (26, 5) and not t26.flags.writeable
  assert not np.array_equal(cuda_mesh._fire_link_table(0.2, STRIDE), t26)


def _k9_warp_groups(r, rows):
  """force3d_kernel's spring groups for warp r at plane z, in its order:
  (source row, dz, dy, the source takes its share, where the far ends'
  share goes: 'acc' (row r of plane z), 'carry' (row r of plane z + 1),
  (exchange buffer, row) or None (the neighbouring tile's)). Rows are
  tile-relative, -1 and `rows` being the halo."""
  g = [(r, 0, 0, True, 'acc'),
       (r, 0, 1, True, ('sS', r + 1) if r + 1 < rows else None)]
  if r == 0:
    g.append((-1, 0, 1, False, ('sS', 0)))
  g += [(r, 1, -1, True, ('sDm', r - 1) if r > 0 else None),
        (r, 1, 0, True, 'carry')]
  if r == rows - 1:
    g.append((rows, 1, -1, False, ('sDm', rows - 1)))
  g.append((r, 1, 1, True, ('sDp', r + 1) if r + 1 < rows else None))
  if r == 1:
    g.append((-1, 1, 1, False, ('sDp', 0)))
  return g


def _k9_tile_tables(rows, warp_groups=_k9_warp_groups):
  """Per forward link e = (dz, dy, dx): how often one tile of `rows` rows
  gives the spring from tile-relative (row, col) its near share and its
  far share, as [rows + 2, cols + 2] tables indexed from the halo (-1,
  -1); and the exchange rows written, {(buffer, row): warp}."""
  kv = cuda_mesh.FORCE3D_NODES_A_LANE
  cols = 32 * kv
  near, far = {}, {}
  written = {}
  for r in range(rows):
    for src_row, dz, dy, src_takes, dest in warp_groups(r, rows):
      # Where the far ends' share lands must be the far ends' row.
      tgt_row = src_row + dy
      assert -1 <= src_row <= rows and -1 <= tgt_row <= rows  # staged
      if dest in ('acc', 'carry'):
        assert tgt_row == r and dz == (dest == 'carry')
      elif dest is not None:
        buf, q = dest
        assert q == tgt_row and dz == (buf != 'sS')
        assert (buf, q) not in written  # one writer a row
        written[buf, q] = r
      dxs = (1,) if (dz, dy) == (0, 0) else (-1, 0, 1)
      for dx in dxs:
        e = (dz, dy, dx)
        n = near.setdefault(e, np.zeros((rows + 2, cols + 2), np.int64))
        f = far.setdefault(e, np.zeros((rows + 2, cols + 2), np.int64))
        src = np.arange(cols)  # lane l's node j at column kv * l + j
        n[src_row + 1, src + 1] += src_takes
        if dest is not None:
          ok = (src + dx >= 0) & (src + dx < cols)  # in the warp
          f[src_row + 1, src[ok] + 1] += 1
          # Lane 0 (dx = 1) and lane 31 (dx = -1) evaluate the link from
          # the halo column into their edge node.
          f[src_row + 1, (0 if dx == 1 else cols + 1)] += dx != 0
  return near, far, written


def _k9_pairs_taken(shape, rows, near, far):
  """Over K9's tiles of a [*, nz, ny, nx] mesh, how often each spring
  between two nodes of the mesh is taken by its near and by its far end
  (two arrays per forward link, over the springs that exist)."""
  nz, ny, nx = shape
  cols = 32 * cuda_mesh.FORCE3D_NODES_A_LANE
  y = np.arange(ny)[:, None]
  x = np.arange(nx)[None, :]
  for e in near:
    dz, dy, dx = e
    cnt_n = np.zeros((ny, nx), np.int64)
    cnt_f = np.zeros((ny, nx), np.int64)
    # The tiles whose staged window holds the source node: its own and
    # its neighbours'.
    for oy in (-1, 0, 1):
      y0 = (y // rows + oy) * rows
      ry = y - y0
      for ox in (-1, 0, 1):
        x0 = (x // cols + ox) * cols
        rx = x - x0
        ok = ((ry >= -1) & (ry <= rows) & (y0 >= 0) & (y0 < ny)
              & (rx >= -1) & (rx <= cols) & (x0 >= 0) & (x0 < nx))
        iy = np.clip(ry + 1, 0, rows + 1)
        ix = np.clip(rx + 1, 0, cols + 1)
        cnt_n += np.where(ok, near[e][iy, ix], 0)
        cnt_f += np.where(ok, far[e][iy, ix], 0)
    spring = ((y + dy >= 0) & (y + dy < ny) & (x + dx >= 0) & (x + dx < nx)
              & (dz < nz))
    spring = np.broadcast_to(spring, (ny, nx))
    yield cnt_n[spring], cnt_f[spring]


# Path (a)'s tile meshes, path (b)'s mesh, and an odd one, at both tile
# heights.
@pytest.mark.parametrize('rows', cuda_mesh.FORCE3D_ROWS)
@pytest.mark.parametrize('shape', [(4, 36, 36), (8, 512, 1024), (5, 37, 71)])
def test_k9_tiling_model(shape, rows):
  """Over K9's tiles (origins from blockIdx as force3d_kernel computes
  them), every spring between two nodes of the mesh is taken once by its
  near end and once by its far end: every (node, link) pair once. The
  staged planes and exchange buffers fit a block's shared memory."""
  _, ny, nx = shape
  cols = 32 * cuda_mesh.FORCE3D_NODES_A_LANE
  tiles_x = -(-nx // cols)
  n_tiles = tiles_x * -(-ny // rows)
  origins = {(b // tiles_x * rows, b % tiles_x * cols)
             for b in range(n_tiles)}
  assert origins == {(y0, x0) for y0 in range(0, ny, rows)
                     for x0 in range(0, nx, cols)}
  # Three staged planes of 3 channels, (rows + 2) x (cols + 8) floats
  # each, and three exchange buffers of rows x 3 x cols floats.
  smem = 4 * (9 * (rows + 2) * (cols + 8) + 9 * rows * cols)
  assert smem <= 227 * 1024
  near, far, written = _k9_tile_tables(rows)
  # Every exchange row a warp reads is written once a plane.
  assert sorted(written) == sorted((b, q) for b in ('sS', 'sDm', 'sDp')
                                   for q in range(rows))
  assert sorted(near) == sorted(cuda_mesh._forward(d)[::-1]
                                for d in tmesh.MESH_LINK_DIRECTIONS)
  for cnt_n, cnt_f in _k9_pairs_taken(shape, rows, near, far):
    np.testing.assert_array_equal(cnt_n, 1)
    np.testing.assert_array_equal(cnt_f, 1)


def test_k9_tiling_model_misses_a_dropped_group():
  """The model is not blind: with any one of the kernel's spring groups
  left out, some (node, link) pair goes untaken or an exchange row
  unwritten."""
  rows = cuda_mesh.FORCE3D_ROWS[-1]
  full = [(r, i) for r in range(rows)
          for i in range(len(_k9_warp_groups(r, rows)))]
  for drop in full:
    groups = lambda r, n: [g for i, g in enumerate(_k9_warp_groups(r, n))
                           if (r, i) != drop]
    near, far, written = _k9_tile_tables(rows, groups)
    once = len(written) == 3 * rows and all(
        (n == 1).all() and (f == 1).all()
        for n, f in _k9_pairs_taken((5, 37, 71), rows, near, far))
    assert not once, f'dropping group {drop} goes unseen'


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
