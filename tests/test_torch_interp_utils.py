"""ops/interp and utils of sofima_tpu_torch against sofima_tpu (CPU).

  * interp.sample / sample_channels in all four methods (nearest,
    linear, cubic, Lanczos4), both modes, 2d (and 3d for the nearest and
    linear methods, whose reference programs compile fast), with NaN
    coordinates, NaN image values and exact grid points; map_coordinates
    (orders 0, 1, 3, coordinates as one array or a sequence); the raises
    (unknown method or order, rank mismatch); kernel_taps;
  * the cubic and Lanczos tap weights against the plain weights of the
    render kernel K4 (ops.shift_warp.make_weight_fn, whose numerics
    csrc/warp_weights.cuh copies);
  * map_utils.resample_map in 'nearest' and 'cubic';
  * utils: geom.integral_image (numpy and tensors) with
    query_integral_image, bounding_box (scale, hull, contains,
    intersections, containing), box_generator (the public properties,
    boxes, cropped_boxes, iteration, grid_boxes, iter_grid).
Tolerance: sampled values within 1e-5 of the reference's (float32
rounding of the same weights and sums; test_torch_warp.py's bar for
linear sampling), NaN placement exact; integer and box results exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import map_utils as jmu
from sofima_tpu.ops import interp as jinterp
from sofima_tpu.utils import bounding_box as jbb
from sofima_tpu.utils import box_generator as jbg
from sofima_tpu.utils import geom as jgeom
from sofima_tpu_torch import map_utils as tmu
from sofima_tpu_torch.ops import interp as tinterp
from sofima_tpu_torch.ops import shift_warp as tsw
from sofima_tpu_torch.utils import bounding_box as tbb
from sofima_tpu_torch.utils import box_generator as tbg
from sofima_tpu_torch.utils import geom as tgeom

torch.set_num_threads(2)
METHODS = ('nearest', 'linear', 'cubic', 'lanczos')
SAMPLE_TOL = 1e-5


def _inputs(shape, seed):
  rng = np.random.RandomState(seed)
  img = rng.randn(*shape).astype(np.float32)
  img.flat[7] = np.nan
  dim = len(shape)
  q = (rng.rand(dim, 6, 5) * (np.array(shape)[:, None, None] + 2)
       - 1).astype(np.float32)
  q[:, 0, 0] = 2.0   # an exact grid point
  q[:, 2, 2] = 2.5   # halfway: nearest rounds half to even
  q[0, 1, 1] = np.nan
  return img, q


def _close(got, want):
  np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
  np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_TOL)


@pytest.mark.parametrize('shape, method', [((9, 11), m) for m in METHODS]
                         + [((5, 7, 6), 'nearest'), ((5, 7, 6), 'linear')])
def test_sample(shape, method):
  img, q = _inputs(shape, seed=len(shape))
  for mode, cval in (('constant', np.nan), ('nearest', np.nan),
                     ('constant', 0.0)):
    want = np.asarray(jinterp.sample(jnp.asarray(img), jnp.asarray(q),
                                     method, mode, cval))
    got = tinterp.sample(torch.from_numpy(img), torch.from_numpy(q), method,
                         mode, cval).numpy()
    _close(got, want)


@pytest.mark.parametrize('method', METHODS)
def test_sample_channels(method):
  rng = np.random.RandomState(5)
  img = rng.randn(3, 8, 9).astype(np.float32)
  q = (rng.rand(2, 4, 7) * 10 - 1).astype(np.float32)
  want = np.asarray(jinterp.sample_channels(jnp.asarray(img), jnp.asarray(q),
                                            method, 'nearest'))
  got = tinterp.sample_channels(torch.from_numpy(img), torch.from_numpy(q),
                                method, 'nearest').numpy()
  assert got.shape == want.shape == (3, 4, 7)
  _close(got, want)


def test_map_coordinates_and_raises():
  img, q = _inputs((9, 11), seed=6)
  for order in (0, 1, 3):
    want = np.asarray(jinterp.map_coordinates(jnp.asarray(img),
                                              jnp.asarray(q), order))
    got = tinterp.map_coordinates(torch.from_numpy(img), torch.from_numpy(q),
                                  order).numpy()
    _close(got, want)
    seq = tinterp.map_coordinates(torch.from_numpy(img),
                                  [torch.from_numpy(c) for c in q], order)
    _close(seq.numpy(), want)
  for fn in (jinterp.map_coordinates, tinterp.map_coordinates):
    with pytest.raises(ValueError, match='Unsupported interpolation order'):
      fn(img, q, 2)
  for mod in (jinterp, tinterp):
    assert [mod.kernel_taps(m) for m in METHODS] == [1, 2, 4, 8]
    with pytest.raises(ValueError, match='Unknown interpolation method'):
      mod.kernel_taps('area')
  with pytest.raises(ValueError, match='Unknown interpolation method'):
    tinterp.sample(torch.from_numpy(img), torch.from_numpy(q), 'area')
  with pytest.raises(ValueError, match='coords dim'):
    jinterp.sample(jnp.asarray(img), jnp.asarray(q[:1]))
  with pytest.raises(ValueError, match='coords dim'):
    tinterp.sample(torch.from_numpy(img), torch.from_numpy(q[:1]))


@pytest.mark.parametrize('method', ['cubic', 'lanczos'])
def test_tap_weights_match_k4(method):
  # K4's plain version weighs the tap at integer shift s by K(d - s); the
  # interpolation taps sit at offsets o from floor(d), so with t = d -
  # floor(d) the weights must be K(t - o) (Lanczos4 normalized per axis,
  # as K4 divides by the product of its row and column sums).
  t = torch.linspace(0.0, 0.999, 203)
  offsets, weights = tinterp._tap_weights(t, method)
  k4 = tsw.make_weight_fn(t, method)
  plain = torch.stack([k4(o) for o in offsets])
  if method == 'lanczos':
    plain = plain / plain.sum(0)
  np.testing.assert_allclose(torch.stack(weights).numpy(), plain.numpy(),
                             rtol=0, atol=1e-6)
  want = jinterp._tap_weights(jnp.asarray(t.numpy()), method)
  assert want[0] == offsets
  np.testing.assert_allclose(np.stack([np.asarray(w) for w in want[1]]),
                             torch.stack(weights).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize('method', ['nearest', 'cubic'])
def test_resample_map_methods(method):
  rng = np.random.RandomState(7)
  cmap = rng.randn(2, 2, 6, 7).astype(np.float32) * 3
  cmap[:, 1, 2, 3] = np.nan
  src = jbb.BoundingBox(start=(0, 0, 0), size=(7, 6, 2))
  dst = jbb.BoundingBox(start=(1, 1, 0), size=(11, 9, 2))
  want = jmu.resample_map(cmap, src, dst, 20, 10, method=method)
  got = tmu.resample_map(cmap, tbb.BoundingBox(src.start, src.size),
                         tbb.BoundingBox(dst.start, dst.size), 20, 10,
                         method=method, device='cpu')
  _close(got, np.asarray(want))


def test_integral_image():
  rng = np.random.RandomState(8)
  for shape, patch, step in (((13, 17), (4, 5), (2, 3)),
                             ((6, 9, 11), (3, 4, 4), (1, 2, 3))):
    mask = rng.rand(*shape) < 0.4
    want = np.asarray(jgeom.integral_image(mask))
    got_np = tgeom.integral_image(mask)
    got_t = tgeom.integral_image(torch.from_numpy(mask))
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    q_want = jgeom.query_integral_image(jgeom.integral_image(mask), patch,
                                        step)
    np.testing.assert_array_equal(
        tgeom.query_integral_image(got_np, patch, step), q_want)
    np.testing.assert_array_equal(
        tgeom.query_integral_image(got_t, patch, step), q_want)
  assert tgeom.integral_image(None) is None


def _box_pairs():
  return [((0, 0, 0), (10, 8, 3)), ((4, -2, 1), (9, 5, 4)),
          ((20, 20, 0), (2, 2, 1)), ((3.5, 1, 0), (2, 2.5, 1))]


def test_bounding_box_functions():
  jb = [jbb.BoundingBox(s, z) for s, z in _box_pairs()]
  tb = [tbb.BoundingBox(s, z) for s, z in _box_pairs()]

  def same(t, j):
    assert (t is None) == (j is None)
    if t is not None:
      np.testing.assert_array_equal(t.start, j.start)
      np.testing.assert_array_equal(t.size, j.size)
      assert t.start.dtype == j.start.dtype

  for f in (0.5, (2, 0.25, 1), 3):
    for t, j in zip(tb, jb):
      same(t.scale(f), j.scale(f))
  for ta, ja in zip(tb, jb):
    for tb_, jb_ in zip(tb, jb):
      same(ta.hull(tb_), ja.hull(jb_))
      same(ta.intersection(tb_), ja.intersection(jb_))
    for p in ((0, 0, 0), (9, 7, 2), (10, 7, 2), (5, -1, 1), (4.5, 2, 0)):
      assert ta.contains(p) == ja.contains(p)
  got = tbb.intersections(tb[:2], tb[1:])
  want = jbb.intersections(jb[:2], jb[1:])
  assert len(got) == len(want) == 3
  for t, j in zip(got, want):
    same(t, j)
  same(tbb.containing(*tb), jbb.containing(*jb))
  same(tbb.containing(tb[2]), jbb.containing(jb[2]))
  for mod in (jbb, tbb):
    with pytest.raises(ValueError, match='At least one box'):
      mod.containing()


@pytest.mark.parametrize('overlap, back_shift', [(None, False), ((4, 2), True),
                                                 ((6, 0), False)])
def test_box_generator(overlap, back_shift):
  outer_j = jbb.BoundingBox(start=(3, -5), size=(47, 31))
  outer_t = tbb.BoundingBox(start=(3, -5), size=(47, 31))
  jg = jbg.BoxGenerator(outer_j, (16, 12), overlap, back_shift)
  tg = tbg.BoxGenerator(outer_t, (16, 12), overlap, back_shift)
  for name in ('grid_shape', 'box_size', 'overlap'):
    np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
  assert tg.num_boxes == jg.num_boxes

  def rows(boxes):
    return [(b.start.tolist(), b.size.tolist()) for b in boxes]

  assert rows(tg.boxes()) == rows(jg.boxes()) == rows(list(tg))
  assert rows(tg.cropped_boxes()) == rows(jg.cropped_boxes())
  assert rows(tbg.grid_boxes(outer_t, (16, 12), overlap)) == rows(
      jbg.grid_boxes(outer_j, (16, 12), overlap))
  assert list(tbg.iter_grid((2, 3, 1))) == list(jbg.iter_grid((2, 3, 1)))
