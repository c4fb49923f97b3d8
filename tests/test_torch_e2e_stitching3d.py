"""examples/e2e_stitching3d.py's chain in sofima_tpu and sofima_tpu_torch (CPU).

The example's LICONN-style recipe at its own size: two 48 x 48 x 24
tiles cut with 16 px of x overlap from its seeded 24 x 48 x 80 volume,
the 3d fine flow over the overlap (`compute_flow_map3d`, patch 16^3,
stride 8), `aggregate_arrays`, the joint 3d solve (`relax_mesh` with the
target meshes as `prev_fn` and the 26-neighbour force), the npz mesh
exchange (`checkpoint.save_mesh_npz`) and the distance-weighted render
of one box by `StitchAndRender3dTiles`, in both packages (the port with
device='cpu'). Both renders must pass the example's gate (relative
error under 0.8 with coverage over 0.5). Between the packages: flow
x/y/z peaks and NaN placement exact, statistics within rtol = atol =
3e-4; the solve's steps equal and its meshes within 0.01 x stride; the
rendered box within 1e-2 gray levels with the same coverage.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import mesh as jmesh
from sofima_tpu import stitch_elastic as jse
from sofima_tpu.processor import warp as j_warp
from sofima_tpu.utils import checkpoint as j_ckpt
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu.utils.subvolume import Subvolume as JSub
from sofima_tpu_torch import mesh as tmesh
from sofima_tpu_torch import stitch_elastic as tse
from sofima_tpu_torch.processor import warp as t_warp
from sofima_tpu_torch.utils import checkpoint as t_ckpt
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox
from sofima_tpu_torch.utils.subvolume import Subvolume as TSub

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))
import e2e_stitching3d  # noqa: E402  (the example's volume and tile view)

torch.set_num_threads(2)
OVERLAP = 16
STRIDE = (8, 8, 8)
STAT_TOL = 3e-4


def _inputs():
  vol = e2e_stitching3d.make_volume((24, 48, 80), seed=3)
  tiles = {0: vol[:, :, :48], 1: vol[:, :, 32:]}
  cx = np.full((3, 1, 1, 2), np.nan)
  cx[:, 0, 0, 0] = (-OVERLAP, 0, 0)
  cy = np.full((3, 1, 1, 2), np.nan)
  coarse = np.zeros((3, 1, 1, 2), np.float32)
  coarse[0, 0, 0, 1] = -OVERLAP
  return vol, tiles, cx, cy, coarse


def _config(mod):
  return mod.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=STRIDE, num_iters=200,
      max_iters=5000, stop_v_max=0.01, dt_max=100.0)


def _chain(side, tmp_path):
  """The example's steps on one package ('jax' or 'torch')."""
  vol, tiles, cx, cy, coarse = _inputs()
  tile_map = {(0, 0): e2e_stitching3d.Tile(tiles[0]),
              (1, 0): e2e_stitching3d.Tile(tiles[1])}
  jax_side = side == 'jax'
  se, dev = (jse, {}) if jax_side else (tse, dict(device='cpu'))
  flows_x, off_x = se.compute_flow_map3d(
      tile_map, tile_shape=(48, 48, 24), offset_map=cx, axis=0,
      patch_size=(16, 16, 16), stride=STRIDE, batch_size=8, **dev)
  flows_x = {k: np.asarray(v) for k, v in flows_x.items()}
  fx, fy, x0, nbors, key_to_idx = se.aggregate_arrays(
      (cx[:, 0], flows_x, off_x), (cy[:, 0], {}, {}),
      list(tile_map.keys()), coarse[:, 0], STRIDE, tile_shape=(24, 48, 48))

  if jax_side:
    fx_j, fy_j, nb = jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(nbors)

    def prev_fn(x):
      return jnp.moveaxis(jax.vmap(lambda n: jse.compute_target_mesh(
          n, x=x, fx=fx_j, fy=fy_j, stride=STRIDE))(nb), 0, 1)

    solved, _, steps = jmesh.relax_mesh(
        jnp.asarray(x0), None, _config(jmesh), prev_fn=prev_fn,
        mesh_force=jmesh.elastic_mesh_3d)
  else:
    solved, _, steps = tmesh.relax_mesh(
        torch.from_numpy(np.asarray(x0)), None, _config(tmesh),
        prev_fn=tse.TargetMeshPlan(nbors, fx, fy, STRIDE, x0.shape[-3:]),
        mesh_force=tmesh.elastic_mesh_3d)
  solved = np.asarray(solved)

  mesh_path = str(tmp_path / f'meshes_{side}.npz')
  (j_ckpt if jax_side else t_ckpt).save_mesh_npz(mesh_path, solved,
                                                 key_to_idx)
  base = j_warp.StitchAndRender3dTiles if jax_side else (
      t_warp.StitchAndRender3dTiles)

  class Render(base):

    def _open_tile_volume(self, tile_id):
      return tiles[tile_id]

  _reset_caches(base)
  proc = Render(tile_map=[[0, 1]], tile_mesh_path=mesh_path, stride=STRIDE,
                margin=2, work_size=(64, 64, 32), **dev)
  box = (JBox if jax_side else TBox)(start=(0, 8, 4), size=(72, 32, 12))
  sv = (JSub if jax_side else TSub)(
      np.zeros((1,) + tuple(box.size[::-1]), np.float32), box)
  rendered = np.asarray(proc.process(sv).data[0])
  _reset_caches(base)
  return dict(vol=vol, flows_x=flows_x, solved=solved, steps=int(steps),
              key_to_idx=key_to_idx, rendered=rendered)


def _reset_caches(cls):
  cls._tile_meshes = None
  cls._tile_idx_to_xy = None
  cls._tile_boxes = {}
  cls._inverted_meshes = {}


def _gate(out):
  """e2e_stitching3d.py's check -> (relative error, coverage, passed)."""
  rendered, vol = out['rendered'], out['vol']
  mask = rendered > 0
  truth = vol[4:16, 8:40, 0:72]
  rel = np.abs(rendered - truth)[mask].mean() / truth.std()
  return rel, mask.mean(), rel < 0.8 and mask.mean() > 0.5


@pytest.fixture(scope='module')
def chains(tmp_path_factory):
  tmp = tmp_path_factory.mktemp('meshes')
  return _chain('jax', tmp), _chain('torch', tmp)


@pytest.mark.parametrize('side', ['reference', 'port'])
def test_example_gate(chains, side):
  rel, cover, ok = _gate(chains[0] if side == 'reference' else chains[1])
  print(f'{side}: rel err={rel:.3f} (coverage {cover:.1%})')
  assert ok, (side, rel, cover)


def test_flows_match(chains):
  want, got = chains
  assert got['flows_x'].keys() == want['flows_x'].keys()
  for key, w in want['flows_x'].items():
    g = got['flows_x'][key]
    assert g.shape == w.shape
    np.testing.assert_array_equal(np.nan_to_num(g[:3], nan=9e9),
                                  np.nan_to_num(w[:3], nan=9e9))
    np.testing.assert_allclose(g[3:], w[3:], rtol=STAT_TOL, atol=STAT_TOL,
                               equal_nan=True)


def test_solve_matches(chains):
  want, got = chains
  assert got['key_to_idx'] == want['key_to_idx']
  assert got['steps'] == want['steps']
  np.testing.assert_array_equal(np.isnan(got['solved']),
                                np.isnan(want['solved']))
  np.testing.assert_allclose(got['solved'], want['solved'], rtol=0,
                             atol=0.01 * STRIDE[0])


def test_render_matches(chains):
  want, got = chains
  np.testing.assert_array_equal(got['rendered'] > 0, want['rendered'] > 0)
  np.testing.assert_allclose(got['rendered'], want['rendered'], atol=1e-2)
