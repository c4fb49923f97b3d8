"""The coordinate-map library API of sofima_tpu_torch against sofima_tpu
(CPU, plain versions).

The same numpy-seeded maps go through sofima_tpu.map_utils and the
port's twins (device='cpu'): `to_absolute` / `to_relative`,
`fill_missing` (interpolate, extrapolate, invalid_to_zero, nearest
only), `invert_map` (float32 and float64; divergence counters),
`resample_map`, `compose_maps`, `outer_box` / `inner_box`,
`mask_irregular` and `make_affine_map`. Tolerance: 0.01 x stride for
inverted, filled, resampled and composed maps (the reference's solver
fixed-point bar), the NaN pattern equal; boxes and masks exact.
"""

import numpy as np
import pytest
import torch

from sofima_tpu import map_utils as jmap
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu_torch import map_utils as tmap
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox

torch.set_num_threads(2)
STRIDE = 20


def _boxes(start, size):
  return JBox(start=start, size=size), TBox(start=start, size=size)


def _map(seed, shape=(2, 2, 14, 17), amp=6.0, holes=True):
  rng = np.random.RandomState(seed)
  z, y, x = shape[1:]
  yy, xx = np.mgrid[:y, :x].astype(np.float32)
  m = np.stack([amp * np.sin(yy / 4.0 + 0.3) + rng.randn(y, x) * 0.3,
                amp * np.cos(xx / 5.0) + rng.randn(y, x) * 0.3])
  m = np.repeat(m[:, None], z, axis=1).astype(np.float32)
  m[:, 1] *= 0.7
  if holes:
    m[:, 0, 5:8, 6:9] = np.nan
    m[:, 1, :2, :] = np.nan
  return m


def _close(got, ref, tol=0.01 * STRIDE):
  assert got.shape == ref.shape and got.dtype == ref.dtype
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  np.testing.assert_allclose(got, ref, atol=tol, rtol=0, equal_nan=True)


def test_absolute_relative_roundtrip():
  m = _map(0, holes=False)
  jb, tb = _boxes((3, 2, 0), (17, 14, 2))
  a = tmap.to_absolute(m, STRIDE, tb)
  np.testing.assert_array_equal(a, jmap.to_absolute(m, STRIDE, jb))
  np.testing.assert_array_equal(tmap.to_relative(a, STRIDE, tb),
                                jmap.to_relative(a, STRIDE, jb))
  with pytest.raises(ValueError, match='mismatch'):
    tmap.to_absolute(m, STRIDE, TBox(start=(0, 0, 0), size=(5, 5, 2)))


@pytest.mark.parametrize('kw', [dict(), dict(extrapolate=True),
                                dict(interpolate_first=False,
                                     extrapolate=True),
                                dict(invalid_to_zero=True)])
def test_fill_missing(kw):
  m = _map(1)
  m[:, 1] = np.nan  # a fully invalid section
  _close(tmap.fill_missing(m, device='cpu', **kw),
         jmap.fill_missing(m, **kw))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_invert_map(dtype):
  m = _map(2)
  src_j, src_t = _boxes((0, 0, 0), (17, 14, 2))
  dst_j, dst_t = _boxes((-1, -1, 0), (19, 16, 2))
  before = dict(tmap.invert_stats)
  got = tmap.invert_map(m, src_t, dst_t, STRIDE, dtype=dtype, device='cpu')
  ref = jmap.invert_map(m, src_j, dst_j, STRIDE, dtype=dtype)
  _close(got, ref)
  assert np.isfinite(got).mean() > 0.5
  assert tmap.invert_stats['invert_map_sections'] == before.get(
      'invert_map_sections', 0) + 2


def test_invert_then_fill_3d():
  rng = np.random.RandomState(3)
  m = (rng.randn(3, 5, 6, 7) * 1.5).astype(np.float32)
  jb, tb = _boxes((0, 0, 0), (7, 6, 5))
  got = tmap.invert_map(m, tb, tb, (8, 10, 10), device='cpu')
  ref = jmap.invert_map(m, jb, jb, (8, 10, 10))
  _close(got, ref, tol=0.08)
  _close(tmap.fill_missing(got, extrapolate=True, device='cpu'),
         jmap.fill_missing(ref, extrapolate=True), tol=0.08)


def test_resample_map():
  m = _map(4)
  src_j, src_t = _boxes((0, 0, 0), (17, 14, 2))
  dst_j, dst_t = _boxes((0, 0, 0), (33, 27, 2))
  got = tmap.resample_map(m, src_t, dst_t, 2 * STRIDE, STRIDE, device='cpu')
  ref = jmap.resample_map(m, src_j, dst_j, 2 * STRIDE, STRIDE)
  _close(got, ref)


def test_compose_maps():
  a, b = _map(5), _map(6, holes=False)
  b[:, :, 3, 3] = np.nan
  b1_j, b1_t = _boxes((0, 0, 0), (17, 14, 2))
  b2_j, b2_t = _boxes((1, 0, 0), (17, 14, 2))
  got = tmap.compose_maps(a, b1_t, STRIDE, b, b2_t, STRIDE, device='cpu')
  ref = jmap.compose_maps(a, b1_j, STRIDE, b, b2_j, STRIDE)
  _close(got, ref)


def test_boxes():
  m = _map(7)
  jb, tb = _boxes((2, 1, 0), (17, 14, 2))
  for name in ('outer_box',):
    got, ref = (getattr(tmap, name)(m, tb, STRIDE),
                getattr(jmap, name)(m, jb, STRIDE))
    np.testing.assert_array_equal(got.start, ref.start)
    np.testing.assert_array_equal(got.size, ref.size)
  got = tmap.inner_box(m, tb, STRIDE, device='cpu')
  ref = jmap.inner_box(m, jb, STRIDE)
  np.testing.assert_array_equal(got.start, ref.start)
  np.testing.assert_array_equal(got.size, ref.size)
  assert tb.adjusted_by(start=(-1, -1, 0), end=(1, 1, 0)) == TBox(
      start=(1, 0, 0), size=(19, 16, 2))


def test_mask_irregular_and_affine():
  m = _map(8, holes=False)[:, 0]
  m[0, 4, 6] += 25.0  # a fold along x
  a, b = m.copy(), m.copy()
  np.testing.assert_array_equal(
      tmap.mask_irregular(a, (STRIDE, STRIDE), 0.5),
      jmap.mask_irregular(b, (STRIDE, STRIDE), 0.5))
  np.testing.assert_array_equal(a, b)
  mat = np.array([[1.01, 0.02, 0, 3.5], [-0.01, 0.99, 0, -2.0],
                  [0, 0, 1, 0]], np.float64)
  jb, tb = _boxes((0, 0, 0), (6, 5, 2))
  np.testing.assert_allclose(tmap.make_affine_map(mat, tb, STRIDE),
                             jmap.make_affine_map(mat, jb, STRIDE))
