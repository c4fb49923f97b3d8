"""The invert layer on the CPU: csrc/invert.cu's host plan, and the plain
path that CPU tensors keep, against sofima_tpu's on the kernels' cases.

The kernels themselves run only on a card (tests/test_torch_gpu.py holds
them against the plain path): here `fill_plan` and `_fill_table` are
checked for every size up to the fused solver's bound, 786 432 nodes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import map_utils as jmap
from sofima_tpu.ops import fill as jfill
from sofima_tpu_torch import map_utils as tmap
from sofima_tpu_torch.ops import _build
from sofima_tpu_torch.ops import cuda_invert
from sofima_tpu_torch.ops import fill as tfill

torch.set_num_threads(2)


@pytest.mark.parametrize('shape', [(2, 2), (1, 1), (5, 1), (23, 23),
                                   (63, 63), (64, 65), (125, 125),
                                   (250, 250), (886, 887), (768, 1024),
                                   (3, 262144), (1, 786432)])
@pytest.mark.parametrize('mode', [0, 1, 2])
def test_fill_plan(shape, mode):
  plan = cuda_invert.fill_plan(shape, 16, mode)
  levels = plan.levels
  assert levels[0] == shape and max(levels[-1]) <= 2
  for a, b in zip(levels, levels[1:]):
    assert max(a) > 2 and b == ((a[0] + 1) // 2, (a[1] + 1) // 2)
  assert len(levels) <= cuda_invert.FILL_MAX_LEVELS
  assert plan.coarse_smem <= cuda_invert.SMEM_MAX
  assert plan.level_smem <= cuda_invert.SMEM_MAX
  kinds = [l[0] for l in plan.launches]
  assert kinds.count('jfa') == (len(cuda_invert.jfa_steps(shape))
                                if mode else 1)
  if mode == 2:
    assert set(kinds) == {'jfa'}
    return
  c = plan.coarse  # the first level one block holds
  assert levels[c][0] * levels[c][1] <= cuda_invert.FILL_COARSE_NODES
  assert c == 0 or levels[c - 1][0] * levels[c - 1][1] > (
      cuda_invert.FILL_COARSE_NODES)
  # the prep launches build levels 1 .. c, six at most each
  spans = [l[1:] for l in plan.launches if l[0] == 'prep']
  assert spans[0][0] == 0 and spans[-1][1] == c
  for (a, b), (a2, _) in zip(spans, spans[1:]):
    assert b == a2 and 0 < b - a <= cuda_invert.FILL_DOWN_LEVELS
  # one tiled launch a finer level, 32 x 32 interiors
  tiled = [l for l in plan.launches if l[0] == 'level']
  assert [l[1] for l in tiled] == list(range(c - 1, -1, -1))
  assert all(l[2] == 16 and l[3] for l in tiled)
  for k in range(c):
    h, w = levels[k]
    assert plan.level_tiles(k) == -(-h // 32) * -(-w // 32)
  assert kinds[-1] == 'jfa'
  if tiled:
    assert kinds.index('coarse') < kinds.index('level')
  if shape == (250, 250) and mode == 1:
    # the stack path's grid: 1 prep, 8 passes, coarse, levels 1 and 0, the
    # last pass with the output
    assert len(plan.launches) == 13 and c == 2


@pytest.mark.parametrize('shape,iters,lead,mode', [((250, 250), 16, 15, 1),
                                                   ((65, 71), 40, 2, 1),
                                                   ((886, 887), 16, 1, 1),
                                                   ((41, 46), 16, 1, 0),
                                                   ((41, 46), 0, 1, 2)])
def test_fill_table_layout(shape, iters, lead, mode):
  # Scratch regions are disjoint and inside the buffers; the table's rows
  # point at them, and the Jacobi chunks of a level end in its own buffer.
  table, _, fsz, isz, launches = cuda_invert._fill_table(
      shape, iters, mode, 2 * lead, lead)
  n_levels, coarse = int(table[0]), int(table[1])
  assert int(table[4]) == launches
  assert int(table[6]) == cuda_invert.level_smem_bytes()
  # the constants the table was laid out with, which the launch checks
  assert list(table[12:17]) == [
      cuda_invert.FILL_TILE, cuda_invert.FILL_HALO,
      cuda_invert.FILL_COARSE_NODES, cuda_invert.FILL_DOWN_TILE,
      cuda_invert.FILL_DOWN_LEVELS]
  rows = table[17:17 + 5 * n_levels].reshape(n_levels, 5)
  spans = []
  for k, (h, w, v, wt, f) in enumerate(rows):
    for off in (v, wt, f):
      if off >= 0:
        spans.append((int(off), int(off) + 2 * lead * int(h) * int(w)))
    smooth = mode != cuda_invert.MODE_NEAREST  # the nearest fill has none
    assert (f >= 0) == (smooth and k <= coarse)
    assert (v >= 0) == (smooth and 0 < k <= coarse)
  spans.sort()
  assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
  assert not spans or spans[-1][1] <= fsz
  ints = table[7:12]
  assert list(ints) == sorted(ints) and int(ints[-1]) + lead <= isz
  recs = table[17 + 5 * n_levels:].reshape(-1, 5)
  assert len(recs) == launches
  for kind, a, b, c, d in recs:
    if kind == 3:
      assert 0 <= d < fsz and c < fsz
  for k in range(coarse):
    last = [r for r in recs if r[0] == 3 and r[1] == k][-1]
    assert last[4] == rows[k][4]


def _mesh(g, seed, s=40.0):
  """An absolute map [2, g, g] with a NaN hole, NaN borders, a node beyond
  shift_bound and a collapsed band where the Newton det gate trips."""
  rng = np.random.RandomState(seed)
  yy, xx = np.mgrid[:g, :g].astype(np.float32)
  rel = np.stack([6.0 * np.sin(yy / 5.0) + 3.0,
                  -4.0 * np.cos(xx / 4.0)]).astype(np.float32)
  rel += rng.randn(2, g, g).astype(np.float32) * 0.3
  rel[:, g // 3:g // 3 + 3, g // 2:g // 2 + 3] = np.nan
  rel[:, 0] = np.nan
  rel[:, :, -1] = np.nan
  rel[:, g // 2, g // 4] = (300.0, -260.0)
  c = 3 * g // 4
  rel[:, c - 2:c + 2, c - 2:c + 2] = 0.0
  rel[0, c - 2:c + 2, c - 2:c + 2] = -s * np.arange(4, dtype=np.float32)
  q = np.stack([xx * s, yy * s]).astype(np.float32)
  return rel + q, q


def test_cpu_tensors_take_the_plain_path(monkeypatch):
  def card_only(*args, **kwargs):
    raise AssertionError('a CPU tensor reached the card path')

  for name in ('invert_section', 'fill_invalid', 'nearest_fill'):
    monkeypatch.setattr(cuda_invert, name, card_only)
  before = dict(_build.launch_counts)
  abs_map, q = _mesh(12, 0)
  inv = tmap._invert_section(torch.from_numpy(abs_map), (0.0, 0.0),
                             torch.from_numpy(q), (40.0, 40.0), num_iters=12,
                             newton_iters=2, shift_bound=4)
  rel = inv - torch.from_numpy(q)
  valid = torch.isfinite(rel).all(dim=0)
  tfill.fill_invalid(rel, valid, extrapolate=True)
  tfill.nearest_fill(rel, valid)
  assert _build.launch_counts == before


@pytest.mark.parametrize('dim', [2, 3])
def test_plain_functions_are_the_cpu_path(dim):
  # The plain bodies that the card's kernels are held to are what CPU
  # tensors run, bit for bit.
  rng = np.random.RandomState(dim)
  shape = (9, 11) if dim == 2 else (5, 6, 7)
  v = torch.from_numpy(rng.randn(3, dim, *shape).astype(np.float32))
  valid = torch.from_numpy(rng.rand(3, *shape) > 0.4)
  valid[1] = False
  for extrapolate in (False, True):
    torch.testing.assert_close(
        tfill.fill_invalid(v, valid, extrapolate, dim=dim),
        tfill.fill_invalid_plain(v, valid, extrapolate, dim=dim),
        rtol=0, atol=0, equal_nan=True)
  torch.testing.assert_close(tfill.nearest_fill(v, valid, dim),
                             tfill.nearest_fill_plain(v, valid, dim),
                             rtol=0, atol=0, equal_nan=True)
  if dim == 2:
    abs_map, q = _mesh(12, 1)
    args = (torch.from_numpy(abs_map), (0.0, 0.0), torch.from_numpy(q),
            (40.0, 40.0), 12, 1e-2, 2, 4, (0, 0))
    torch.testing.assert_close(tmap._invert_section(*args),
                               tmap._invert_section_plain(*args),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize('g,origin,pad_x', [(17, (0, 0), 0), (21, (-2, -2), 3)])
def test_invert_cpu_matches_reference(g, origin, pad_x):
  # The stack path's arguments (12 + 2 iterations, shift_bound 4), and the
  # montage's: a query grid padded around the map and wider than tall.
  abs_map, _ = _mesh(g, g)
  s = 40.0
  oy, ox = g - 2 * origin[0], g - 2 * origin[1] + pad_x
  q = np.stack(np.meshgrid((np.arange(ox) + origin[1]) * s,
                           (np.arange(oy) + origin[0]) * s)).astype(np.float32)
  kw = dict(num_iters=12, newton_iters=2, shift_bound=4, shift_origin=origin)
  ref = np.asarray(jmap._invert_section(
      jnp.asarray(abs_map), jnp.zeros(2), jnp.asarray(q), jnp.full((2,), s),
      **kw))
  got = tmap._invert_section(torch.from_numpy(abs_map), (0.0, 0.0),
                             torch.from_numpy(q), (s, s), **kw).numpy()
  assert 0 < np.isnan(ref).sum() < ref.size
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3, equal_nan=True)


@pytest.mark.parametrize('shape', [(19, 19), (33, 21)])
def test_fill_cpu_matches_reference(shape):
  # Odd sizes through every level; a batch with an all-invalid section.
  rng = np.random.RandomState(shape[1])
  v = rng.randn(2, 2, *shape).astype(np.float32)
  valid = rng.rand(2, *shape) > 0.3
  valid[0, :shape[0] // 3] = False
  valid[0, :, -2:] = False
  valid[1] = False
  v[~np.broadcast_to(valid[:, None], v.shape)] = np.nan
  for extrapolate in (True, False):
    got = tfill.fill_invalid(torch.from_numpy(v), torch.from_numpy(valid),
                             extrapolate).numpy()
    for z in range(2):
      ref = np.asarray(jfill.fill_invalid(jnp.asarray(v[z]),
                                          jnp.asarray(valid[z]),
                                          extrapolate=extrapolate))
      np.testing.assert_array_equal(np.isnan(got[z]), np.isnan(ref))
      np.testing.assert_allclose(got[z], ref, rtol=0, atol=1e-4,
                                 equal_nan=True)
  np.testing.assert_array_equal(got[1], v[1])
