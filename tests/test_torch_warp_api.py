"""The warping library API of sofima_tpu_torch against sofima_tpu (CPU,
plain versions).

The same numpy-seeded images and maps go through sofima_tpu.warp and the
port's twins (device='cpu', where the K4 / K13 wrappers run their plain
versions): `warp_subvolume` (uint8, uint16, float32, uint64 labels, an
all-NaN section, the uint32 guard), 2d and 3d `ndimage_warp` over work
boxes, `render_tiles` with margins, margin overrides, tile masks and
CLAHE (and `ops.clahe` alone), and `warp_points`. Tolerances: float
renders within 1e-2 gray levels; integer renders within 1 gray level,
on at most 1e-3 of the pixels (rint at .5 can fall either way; for
16-bit data spanning 0-51 000 the float32 noise is ~200x larger in gray
levels, and the share is 1e-2); labels, masks and integer points exact.
"""

import numpy as np
import pytest
import torch

from sofima_tpu import warp as jwarp
from sofima_tpu.ops import clahe as jclahe
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu_torch import warp as twarp
from sofima_tpu_torch.ops import clahe as tclahe
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox

torch.set_num_threads(2)


def _boxes(start, size):
  return JBox(start=start, size=size), TBox(start=start, size=size)


def _texture(n, seed, m=None):
  m = m or n
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, m).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(m)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  tex = np.fft.irfft2(f, s=(n, m)).astype(np.float32)
  return (tex - tex.min()) / np.ptp(tex) * 255.0


def _smooth_map(seed, shape, amp=3.0):
  rng = np.random.RandomState(seed)
  y, x = shape[-2:]
  yy, xx = np.mgrid[:y, :x].astype(np.float32)
  m = np.stack([amp * np.sin(yy / 3.0 + rng.rand()) + 1.3,
                amp * np.cos(xx / 4.0 + rng.rand()) - 0.7])
  return np.broadcast_to(m[:, None], (2,) + tuple(shape)).astype(
      np.float32).copy()


def _ints_close(got, ref, share=1e-3):
  assert got.dtype == ref.dtype and got.shape == ref.shape
  d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
  assert d.max() <= 1
  assert (d > 0).mean() <= share


@pytest.mark.parametrize('dtype,interp', [(np.uint8, 'lanczos'),
                                          (np.uint16, 'cubic'),
                                          (np.float32, 'linear'),
                                          (np.float32, 'lanczos')])
def test_warp_subvolume(dtype, interp):
  n, stride = 96, 16
  img = _texture(n, 0)[None, None]
  img = np.concatenate([img, img[:, :, ::-1]], axis=1)  # [1, 2, n, n]
  if dtype == np.uint16:
    img = img * 200
  img = img.astype(dtype)
  cmap = _smooth_map(1, (2, 7, 7))
  cmap[:, 0, 3, 2] = np.nan
  cmap[:, 1] = np.nan  # an all-NaN section renders 0
  ib_j, ib_t = _boxes((0, 0, 0), (n, n, 2))
  mb_j, mb_t = _boxes((0, 0, 0), (7, 7, 2))
  ob_j, ob_t = _boxes((4, -3, 0), (88, 90, 2))
  ref = jwarp.warp_subvolume(img, ib_j, cmap, mb_j, stride, ob_j,
                             interpolation=interp)
  got = twarp.warp_subvolume(img, ib_t, cmap, mb_t, stride, ob_t,
                             interpolation=interp, device='cpu')
  assert (got[:, 1] == 0).all()
  if np.issubdtype(dtype, np.integer):
    _ints_close(got, ref, 1e-2 if dtype == np.uint16 else 1e-3)
  else:
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_warp_subvolume_labels_and_guard():
  rng = np.random.RandomState(2)
  ids = np.array([0, 7, 2**40 + 3, 2**63 + 11], np.uint64)
  lab = ids[rng.randint(0, 4, size=(1, 1, 64, 64))]
  cmap = _smooth_map(3, (1, 5, 5), amp=2.2)
  b_j, b_t = _boxes((0, 0, 0), (64, 64, 1))
  mb_j, mb_t = _boxes((0, 0, 0), (5, 5, 1))
  ref = jwarp.warp_subvolume(lab, b_j, cmap, mb_j, 16, b_j)
  got = twarp.warp_subvolume(lab, b_t, cmap, mb_t, 16, b_t, device='cpu')
  assert got.dtype == np.uint64
  np.testing.assert_array_equal(got, ref)
  big = np.full((1, 1, 8, 8), 2**17, np.uint32)
  with pytest.raises(ValueError, match='uint16'):
    twarp.warp_subvolume(big, b_t, cmap, mb_t, 16, b_t, device='cpu')


@pytest.mark.parametrize('order', [0, 1, 3])
def test_ndimage_warp_2d(order):
  n = 80
  img = _texture(n, 4).astype(np.uint8)
  cmap = _smooth_map(5, (1, 9, 9), amp=2.0)[:, 0]
  kw = dict(stride=(10, 10), work_size=(32, 32), overlap=(6, 6),
            order=order)
  ref = jwarp.ndimage_warp(img, cmap, **kw)
  got = twarp.ndimage_warp(img, cmap, device='cpu', **kw)
  _ints_close(got, ref)


def test_ndimage_warp_3d(monkeypatch):
  # On the TPU the reference warps 3d boxes with its shift kernel (taps
  # outside the volume read 0), which K13 ports; on the CPU its cost
  # model prefers a gather whose outside taps poison the voxel. The
  # gather's cost is raised here so that the CPU reference takes the
  # shift path, the function the port computes.
  from sofima_tpu.ops import shift_warp as jsw
  monkeypatch.setattr(jsw, 'GATHER_COST_PER_TAP', 1.0)
  rng = np.random.RandomState(6)
  vol = np.stack([_texture(40, 7 + z) for z in range(12)])
  cmap = (rng.rand(3, 4, 5, 5) - 0.5).astype(np.float32) * 2.0
  kw = dict(stride=(4, 10, 10), work_size=(24, 24, 8), overlap=(4, 4, 2),
            order=1)
  ref = jwarp.ndimage_warp(vol, cmap, **kw)
  got = twarp.ndimage_warp(vol, cmap, device='cpu', **kw)
  assert got.dtype == np.float32
  np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def _tiles():
  tex = _texture(150, 8, 250).astype(np.uint8)
  tiles = {(0, 0): tex[:, :130].copy(), (1, 0): tex[:, 120:250].copy()}
  tiles[(1, 0)] = tiles[(1, 0)][:, :130]
  maps = {(0, 0): _smooth_map(9, (1, 9, 8), amp=1.5),
          (1, 0): _smooth_map(10, (1, 9, 8), amp=1.5)}
  maps[(1, 0)][0] -= 10.0
  return tiles, maps


@pytest.mark.parametrize('kw', [
    dict(margin=5),
    dict(margin_overrides={(1, 0): (2, 3, 8, 1)}, use_clahe=True,
         clahe_kwargs=dict(kernel_size=40, clip_limit=0.02)),
])
def test_render_tiles(kw):
  tiles, maps = _tiles()
  masks = {(0, 0): np.ones((150, 130), bool)}
  masks[(0, 0)][60:70, 20:90] = False
  ref = jwarp.render_tiles(tiles, maps, stride=(20, 20), tile_masks=masks,
                           return_warped_tiles=True, **kw)
  got = twarp.render_tiles(tiles, maps, stride=(20, 20), tile_masks=masks,
                           return_warped_tiles=True, device='cpu', **kw)
  np.testing.assert_array_equal(got[1], ref[1])
  _ints_close(got[0], ref[0])
  assert got[2].keys() == ref[2].keys()
  for k in ref[2]:
    assert got[2][k][:2] == ref[2][k][:2]
    _ints_close(got[2][k][2], ref[2][k][2])


def test_clahe():
  img = (_texture(96, 11, 80) * 0.3 + 60).astype(np.uint8)
  for kw in (dict(), dict(kernel_size=24, clip_limit=0.03, nbins=128)):
    np.testing.assert_allclose(
        tclahe.equalize_adapthist(img, device='cpu', **kw),
        jclahe.equalize_adapthist(img, **kw), atol=1e-6)


def test_warp_points():
  cmap = _smooth_map(12, (2, 6, 6))
  jb, tb = _boxes((1, 2, 3), (6, 6, 2))
  pts = np.array([[25.0, 47.5, 3], [60.2, 70.0, 4], [33.0, 90.0, 3]])
  np.testing.assert_allclose(twarp.warp_points(pts, cmap, tb, 20,
                                               device='cpu'),
                             jwarp.warp_points(pts, cmap, jb, 20), atol=1e-3)
  ipts = pts.astype(np.int64)
  np.testing.assert_array_equal(
      twarp.warp_points(ipts, cmap, tb, 20, device='cpu'),
      jwarp.warp_points(ipts, cmap, jb, 20))
