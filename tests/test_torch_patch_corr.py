"""Kernels K6 and K7 of sofima_tpu_torch against sofima_tpu (CPU, plain).

K6 (`ops.cuda_flow.flow_peaks`) and K7 (`ops.cuda_flow.corr_patches`)
take pre-cut [n, p1, p2] patch batches; on CPU tensors they run their
plain versions, held here against the Pallas kernels
`pallas_flow.flow_peaks_pallas` / `corr_patches_pallas` in interpret
mode on the same numpy-seeded batches, square (p = 16-32) and
rectangular. Tolerances are the JAX tests' own
(tests/test_flow_field.py:419-475): surfaces within atol 1.0, rtol 1e-3
on [0, 100) data (atol = rtol = 1e-3 with a constant mean on [0, 1));
integer peaks exact and sharpness / ratio within rtol 1e-3; a batch
without a peak gives NaN rows.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
from scipy import ndimage
import torch

from sofima_tpu.ops import pallas_flow
from sofima_tpu_torch.ops import cuda_flow

torch.set_num_threads(2)


def _pair(shape, seed, shift=(3, -2)):
  rng = np.random.RandomState(seed)
  a = (rng.rand(*shape) * 100).astype(np.float32)
  b = np.roll(a, shift, (1, 2)) + rng.rand(*shape).astype(np.float32) * 5
  return a, b.astype(np.float32)


@pytest.mark.parametrize('shape', [(5, 32, 32), (4, 24, 40), (3, 40, 16)])
def test_corr_patches_matches_pallas(shape):
  rng = np.random.RandomState(0)
  a = (rng.rand(*shape) * 100).astype(np.float32)
  b = (rng.rand(*shape) * 100).astype(np.float32)
  ref = np.asarray(pallas_flow.corr_patches_pallas(
      jnp.asarray(a), jnp.asarray(b), group=2, interpret=True))
  got = cuda_flow.corr_patches(torch.from_numpy(a), torch.from_numpy(b))
  assert got.shape == shape
  np.testing.assert_allclose(got.numpy(), ref, atol=1.0, rtol=1e-3)


def test_corr_patches_constant_mean():
  rng = np.random.RandomState(1)
  a = rng.rand(3, 16, 16).astype(np.float32)
  b = rng.rand(3, 16, 16).astype(np.float32)
  ref = np.asarray(pallas_flow.corr_patches_pallas(
      jnp.asarray(a), jnp.asarray(b), mean=0.5, group=4, interpret=True))
  got = cuda_flow.corr_patches(torch.from_numpy(a), torch.from_numpy(b),
                               mean=0.5)
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=1e-3)


def test_corr_patches_zero_shift_at_centre():
  a, _ = _pair((2, 24, 40), 2)
  b = np.roll(a, (5, -7), (1, 2))
  got = cuda_flow.corr_patches(torch.from_numpy(a), torch.from_numpy(b))
  peak = np.unravel_index(np.argmax(got[0].numpy()), (24, 40))
  # corr[s] peaks at s = pre - post = -(5, -7), centred at (12, 20).
  assert peak == (12 - 5, 20 + 7)


@pytest.mark.parametrize('shape,mean', [((7, 32, 32), None),
                                        ((6, 24, 40), None),
                                        ((5, 32, 16), 50.0)])
def test_flow_peaks_matches_pallas(shape, mean):
  a, b = _pair(shape, 2)
  ref = np.asarray(pallas_flow.flow_peaks_pallas(
      jnp.asarray(a), jnp.asarray(b), mean=mean, group=4, interpret=True))
  got = cuda_flow.flow_peaks(torch.from_numpy(a), torch.from_numpy(b),
                             mean=mean).numpy()
  assert got.shape == (shape[0], 4)
  np.testing.assert_array_equal(got[:, :2], ref[:, :2])
  np.testing.assert_array_equal(got[:, :2], np.tile([-2.0, 3.0],
                                                    (shape[0], 1)) * -1)
  np.testing.assert_allclose(got[:, 2:], ref[:, 2:], rtol=1e-3)


def test_flow_peaks_no_peak_gives_nan_rows():
  a = np.zeros((2, 16, 16), np.float32)
  ref = np.asarray(pallas_flow.flow_peaks_pallas(
      jnp.asarray(a), jnp.asarray(a), group=2, interpret=True))
  got = cuda_flow.flow_peaks(torch.from_numpy(a), torch.from_numpy(a))
  assert np.isnan(ref).all() and np.isnan(got.numpy()).all()


def test_patch_wrappers_check_shapes():
  a = torch.zeros(2, 16, 16)
  with pytest.raises(ValueError, match='batches'):
    cuda_flow.flow_peaks(a, torch.zeros(2, 16, 12))
  with pytest.raises(ValueError, match='batches'):
    cuda_flow.corr_patches(a[0], a[0])


# K7's shared-memory FFT (csrc/fft_smem.cuh) runs only on the card; its
# plan and tables come from `cuda_flow._fft_axis_np`. A numpy model of the
# kernel's steps on those tables (digit-reversed load, DIT forward passes,
# half-spectrum cross power, DIF column inverse, packed rows, DIF row
# inverse, store through the roll-folded index tables) must give the
# reference kernel's surfaces: a wrong table or stage order shows here.


def _fft_pass(x, n, dit, inverse):
  """All stages of K7's FFT along the last axis of x (complex64)."""
  rs, tw, root, _, _, _ = cuda_flow._fft_axis_np(n)
  tw = tw[:, 0] + 1j * tw[:, 1]
  root = root[:, 0] + 1j * root[:, 1]
  stages, ell, off = [], n, 0
  for r in rs:
    stages.append((r, ell // r, ell, off))
    off += (r - 1) * (ell // r)
    ell //= r
  x = x.copy()
  for r, m, ell, off in (stages[::-1] if dit else stages):
    blk, j, t = np.meshgrid(np.arange(n // ell), np.arange(m), np.arange(r),
                            indexing='ij')
    idx = blk * ell + j + t * m
    w = np.where(t > 0, tw[off + (np.maximum(t, 1) - 1) * m + j], 1.0)
    dft = root[(np.outer(np.arange(r), np.arange(r)) % r) * (n // r)]
    if inverse:
      w, dft = np.conj(w), np.conj(dft)
    v = x[..., idx]
    if dit:
      v = v * w
    y = (v @ dft).astype(np.complex64)
    x[..., idx] = y if dit else y * w
  return x


def _k7_model(a, b, centre=True, crop=None):
  """K7's shared-memory route in numpy, one pair [p1, p2] at a time
  (`centre`: each patch's mean removed first; `crop`: only the centred
  [crop, crop] core of a square pair, gathered as K1/K2's FFT route
  does)."""
  p1, p2 = a.shape
  ax1, ax2 = cuda_flow._fft_axis_np(p1), cuda_flow._fft_axis_np(p2)
  if centre:
    a, b = a - a.mean(), b - b.mean()
  z = np.zeros((p1, p2), np.complex64)
  z[np.ix_(ax1[3], ax2[3])] = a + 1j * b
  z = _fft_pass(z, p2, True, False)
  z = _fft_pass(z.T, p1, True, False).T
  h2 = p2 // 2 + 1
  z1 = z[:, :h2]
  z2 = np.conj(z[(-np.arange(p1)) % p1][:, (-np.arange(h2)) % p2])
  c = (z1 + z2) * 1j * np.conj(z1 - z2) * (0.25 / (p1 * p2))
  g = _fft_pass(c.T, p1, False, True).T
  g1, g2 = g[0::2], np.zeros_like(g[0::2])
  g2[:g[1::2].shape[0]] = g[1::2]
  sc = (np.arange(h2) == 0) | (2 * np.arange(h2) == p2)
  g1 = np.where(sc, g1.real, g1)
  g2 = np.where(sc, g2.real, g2)
  y = np.zeros((g1.shape[0], p2), np.complex64)
  y[:, (-np.arange(h2)) % p2] = np.conj(g1) + 1j * np.conj(g2)
  y[:, :h2] = g1 + 1j * g2
  y = _fft_pass(y, p2, False, True)
  rows, cols = ax1[4], ax2[4]
  if crop is not None:
    lo = p1 // 2 - crop // 2
    rows, cols = rows[lo:lo + crop], cols[lo:lo + crop]
  vals = y[rows // 2][:, cols]
  return np.where((rows % 2 == 1)[:, None], vals.imag, vals.real)


@pytest.mark.parametrize('shape', [(2, 7, 9), (2, 12, 10), (1, 40, 32)])
def test_fft_plan_model_matches_pallas(shape):
  rng = np.random.RandomState(3)
  a = (rng.rand(*shape) * 100).astype(np.float32)
  b = (rng.rand(*shape) * 100).astype(np.float32)
  ref = np.asarray(pallas_flow.corr_patches_pallas(
      jnp.asarray(a), jnp.asarray(b), group=1, interpret=True))
  got = np.stack([_k7_model(x, y) for x, y in zip(a, b)])
  np.testing.assert_allclose(got, ref, atol=1.0, rtol=1e-3)


# K5's pure route (csrc/masked_flow.cu `masked_pure_kernel`) runs K7's
# transform on a fully valid pair with each patch's mean removed, takes
# the four moments and rescales the surface in closed form. A numpy model
# of those steps on K7's tables must give the Padfield NCC of the pair
# (all pixels valid) that the dense route and the plain version compute:
# a wrong moment, tolerance or centring shows here. Within 1e-4 (NCC in
# [-1, 1], float32 transforms of different order).


def _k5_pure_model(a, b):
  p = a.shape[0]
  area = np.float32(p * p)
  pz = (a - np.float32(a.sum(dtype=np.float32) / area)).astype(np.float32)
  cz = (b - np.float32(b.sum(dtype=np.float32) / area)).astype(np.float32)
  s1, s2 = pz.sum(dtype=np.float32), (pz * pz).sum(dtype=np.float32)
  s3, s4 = cz.sum(dtype=np.float32), (cz * cz).sum(dtype=np.float32)
  var_p = max(s2 - s1 * s1 / area, np.float32(0))
  var_c = max(s4 - s3 * s3 / area, np.float32(0))
  denom = np.sqrt(np.float32(var_p * var_c))
  tol = np.float32(1e3) * np.finfo(np.float32).eps * denom
  x = _k7_model(pz, cz, centre=False)
  ncc = np.clip((x - s1 * s3 / area) / denom, -1.0, 1.0)
  return np.where(denom > tol, ncc, 0.0), pz, cz


@pytest.mark.parametrize('p', [32, 27])
def test_k5_pure_route_model_matches_padfield(p):
  rng = np.random.RandomState(4)
  a = (rng.rand(p, p) * 100).astype(np.float32)
  b = (np.roll(a, (2, -3), (0, 1)) + rng.rand(p, p) * 20).astype(np.float32)
  got, pz, cz = _k5_pure_model(a, b)
  ones = torch.ones((1, p, p), dtype=torch.bool)
  icorr = functools.partial(cuda_flow._irdft2_of_product, n1=p, n2=p)
  ref = cuda_flow.padfield_ncc(torch.from_numpy(pz)[None],
                               torch.from_numpy(cz)[None], ones, ones,
                               cuda_flow._rdft2, icorr, per_patch=True)
  ref = torch.roll(ref, (p // 2, p // 2), dims=(1, 2))[0].numpy()
  np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
  # The peak sits at the centre minus b's roll, near the NCC's 1.
  r, c = np.unravel_index(np.argmax(got), got.shape)
  assert (r - p // 2, c - p // 2) == (-2, 3) and got[r, c] > 0.9


# K1/K2's FFT route (csrc/flow_peaks.cu `flow_fft_kernel`) reads each pair
# from the images (the post patch at its offset, zeros outside the image),
# scatters it into K7's digit-reversed order, takes each patch's mean (or
# a given constant) off, runs K7's transform and gathers only the centred
# [crop, crop] core through the tables' `src` entries; a pair with a
# patch that is 0 everywhere after its mean (here: post patches wholly
# off the image) has the all-zero surface. A numpy model of those steps
# must give flow_peaks_plain's cores (within 1e-3 of each core's largest
# value) and, through the plain peak chain, its integer peaks and NaN
# rows exactly: a wrong offset, edge, mean or crop shows.


def _smooth_image(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.1 ** 2)))
  img = np.fft.irfft2(f, s=(n, n))
  return ((img - img.min()) / (img.max() - img.min()) * 255).astype(
      np.float32)


def _k12_fft_model(pre, post, offsets, grid, p, step, crop, mean):
  """The FFT route's cores [gy * gx, crop, crop] in numpy."""
  h, w = pre.shape
  gy, gx = grid
  cores = []
  for k in range(gy * gx):
    y0, x0 = (k // gx) * step[0], (k % gx) * step[1]
    qy0, qx0 = y0, x0
    if offsets is not None:
      qy0 += offsets[k // gx, k % gx, 0]
      qx0 += offsets[k // gx, k % gx, 1]
    yy, xx = np.mgrid[:p, :p]
    inb = ((qy0 + yy >= 0) & (qy0 + yy < h) & (qx0 + xx >= 0)
           & (qx0 + xx < w))
    b = np.where(inb, post[np.clip(qy0 + yy, 0, h - 1),
                           np.clip(qx0 + xx, 0, w - 1)], 0).astype(np.float32)
    a = pre[y0:y0 + p, x0:x0 + p]
    if mean is None:
      area = np.float32(p * p)
      a = a - a.sum(dtype=np.float32) / area
      b = b - b.sum(dtype=np.float32) / area
    else:
      a, b = a - np.float32(mean), b - np.float32(mean)
    if not (a.any() and b.any()):
      # A patch that is 0 everywhere: the all-zero surface (the kernel
      # writes its NaN row without the transform).
      cores.append(np.zeros((crop, crop), np.float32))
      continue
    # _k7_model scatters the pair into the digit-reversed order and runs
    # the transform; `crop` gathers the core through the `src` tables.
    cores.append(_k7_model(a, b, centre=False, crop=crop))
  return np.stack(cores)


@pytest.mark.parametrize('p,step,n,crop,offset,mean', [
    (32, 16, 96, None, None, None),      # K1
    (27, 27, 81, None, None, 120.0),     # K1, odd p, a constant mean
    (40, 20, 120, 16, (3, -2), None),    # K2, 1-5 px off the edges
    (40, 20, 120, 16, (-13, 17), None),  # K2, far off the top and right
    (40, 20, 120, 16, (-45, 3), None),   # K2, top row wholly off the image
])
def test_flow_fft_route_model_matches_plain(p, step, n, crop, offset, mean):
  pre = _smooth_image(n, 5)
  post = np.roll(pre, (2, -3), (0, 1)) + _smooth_image(n, 6) * 0.05
  gy = gx = (n - (p - step)) // step
  offs = None
  if offset is not None:
    rng = np.random.RandomState(7)
    offs = (rng.randint(-2, 3, size=(gy, gx, 2)) + offset).astype(np.int32)
  core = p if crop is None else crop
  got = _k12_fft_model(pre, post, offs, (gy, gx), p, (step, step), core,
                       mean)
  args = (torch.from_numpy(pre), torch.from_numpy(post),
          None if offs is None else torch.from_numpy(offs), (gy, gx), p,
          (step, step), core, mean)
  ref = cuda_flow.flow_surfaces_plain(*args).numpy()
  scale = np.maximum(np.abs(ref).max(axis=(1, 2), keepdims=True), 1e-30)
  assert float((np.abs(got - ref) / scale).max()) < 1e-3
  if offset is not None and offset[0] < -p:
    # The top row's post patches lie wholly above the image: NaN rows.
    assert (offs[0, :, 0] <= -p).all() and not (ref[:gx] != 0).any()
  elif offset is not None and offset[0] < 0:
    # Some post patches hang off the top and some off the right edge.
    assert (offs[0, :, 0] < 0).any() and (
        (gx - 1) * step + offs[:, -1, 1] + p > n).any()
  rows = cuda_flow.batched_peaks(torch.from_numpy(got), (core // 2,
                                                         core // 2))
  peaks = cuda_flow.flow_peaks_plain(*args, 2, 0.5, 5)
  rows = rows.reshape(gy, gx, 4).permute(2, 0, 1)
  np.testing.assert_array_equal(np.nan_to_num(rows[:2].numpy(), nan=9e9),
                                np.nan_to_num(peaks[:2].numpy(), nan=9e9))
  assert np.isfinite(peaks[:2].numpy()).any()


# K6's FFT route (csrc/patch_corr.cu `patch_fft_kernel`) runs K7's
# transform on each pre-cut pair, then the peak chain of
# csrc/flow_peaks.cuh: the pair is read into the digit-reversed order of
# the wrapper's plan tables for (p1, p2) along both axes as a + i b, each
# patch's mean (or the constant `mean`) comes off, a pair with a patch
# that is then 0 everywhere gives its NaN row without the transform, and
# the centred p1 x p2 surface is gathered through the `src` tables. A
# numpy model of those steps and of the chain (threshold first, the
# clipped local-max window, the first peak at the smallest index, the
# clamped sharpness window) must give patch_flow_peaks_plain's rows and
# flow_peaks_pallas's (interpret mode): integer peaks and NaN rows exact,
# sharpness and ratio within rtol 1e-3 (float32 transforms in another
# order). The shapes take radix 2, 3 and 5 stages, rectangular both ways,
# and a pair of odd primes (31 x 37, generic stages); each batch has a
# flat post patch (NaN row) and, with a constant mean, a pair whose
# surface is negative everywhere, so that no value passes the threshold
# (NaN row).


def _peak_chain_model(corr, min_distance=2, threshold_rel=0.5,
                      peak_radius=5):
  """flow_peaks.cuh `peak_chain` on one centred [n1, n2] surface."""
  n1, n2 = corr.shape
  nan_row = np.full(4, np.nan, np.float32)
  if np.isnan(corr).any():
    return nan_row
  thr = np.float32(threshold_rel) * corr.max()
  local = ndimage.maximum_filter(corr, 2 * min_distance + 1,
                                 mode='constant', cval=-np.inf)
  flat = corr.ravel()
  cand = np.flatnonzero(((corr > thr) & (corr == local)).ravel())
  if cand.size == 0:
    return nan_row
  first = cand[np.argmax(flat[cand])]  # the smallest index on ties
  rest = flat[cand[cand != first]]
  v1, v2 = flat[first], rest.max() if rest.size else -np.inf
  py, px = divmod(int(first), n2)
  w = 2 * peak_radius + 1
  wy0 = min(max(py - peak_radius, 0), n1 - w)
  wx0 = min(max(px - peak_radius, 0), n2 - w)
  wmin = corr[max(wy0, 0):wy0 + w, max(wx0, 0):wx0 + w].min()
  return np.array([px - n2 // 2, py - n1 // 2, v1 / wmin,
                   0.0 if v2 == -np.inf else v1 / v2], np.float32)


def _k6_fft_model(a, b, mean):
  """K6's FFT route on one [p1, p2] pair -> its (x, y, sharpness, ratio)."""
  area = np.float32(a.size)
  if mean is None:
    a = a - a.sum(dtype=np.float32) / area
    b = b - b.sum(dtype=np.float32) / area
  else:
    a, b = a - np.float32(mean), b - np.float32(mean)
  if not (a.any() and b.any()):
    return np.full(4, np.nan, np.float32)
  # _k7_model scatters the pair into the digit-reversed order, runs the
  # transform and gathers the centred surface through the `src` tables.
  return _peak_chain_model(_k7_model(a, b, centre=False).astype(np.float32))


@pytest.mark.parametrize('mean', [None, 50.0])
@pytest.mark.parametrize('shape', [(24, 12), (40, 20), (12, 30), (31, 37)])
def test_patch_fft_route_model_matches_plain(shape, mean):
  a, b = _pair((6, *shape), 8)
  b[4] = 37.0 if mean is None else mean  # flat post patch
  if mean is not None:
    rng = np.random.RandomState(9)
    a[5] = mean + 10 + rng.rand(*shape) * 40
    b[5] = mean - 10 - rng.rand(*shape) * 40
  got = np.stack([_k6_fft_model(x, y, mean) for x, y in zip(a, b)])
  nan_rows = [4] if mean is None else [4, 5]
  assert np.isnan(got[nan_rows]).all()
  assert np.isfinite(np.delete(got, nan_rows, 0)).all()
  # b = roll(a, (3, -2)) + noise: the flow (x, y) is (2, -3).
  np.testing.assert_array_equal(got[:4, :2], np.tile([2.0, -3.0], (4, 1)))
  ref = cuda_flow.flow_peaks(torch.from_numpy(a), torch.from_numpy(b),
                             mean=mean).numpy()
  pal = np.asarray(pallas_flow.flow_peaks_pallas(
      jnp.asarray(a), jnp.asarray(b), mean=mean, group=3, interpret=True))
  for r in (ref, pal):
    np.testing.assert_array_equal(got[:, :2], r[:, :2])  # NaN rows too
    np.testing.assert_allclose(got[:, 2:], r[:, 2:], rtol=1e-3)
