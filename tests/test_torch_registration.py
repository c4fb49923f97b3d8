"""The registration primitives of sofima_tpu_torch against sofima_tpu (CPU).

`ops.registration.phase_cross_correlation` and `optim_transform` (ECC)
run on the same numpy-seeded images in both packages (the port with
device='cpu'):
  * phase correlation in 2d and 3d, with 'phase' normalization and
    without: shifts exact, the error (1 - peak) within 1e-5 relative.
    The images are white noise: with phase normalization every spectral
    bin weighs the same, and in a band-limited texture the bins far out
    hold only float32 rounding, which moves the peak value by ~1e-3 in
    either package;
  * ECC in all three motion models on an affinely warped texture: the
    matrix within 1e-3, the correlation coefficient within 1e-4; an
    unknown motion raises; the moment sums that replace the [n, 6]
    Jacobian equal J^T J and J^T r built from it in float64 (within the
    float32 rounding of the image products).
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from sofima_tpu.ops import registration as j_reg
from sofima_tpu_torch.ops import registration as t_reg

torch.set_num_threads(2)


def _texture(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.1 ** 2)))
  tex = np.fft.irfft2(f, s=(n, n))
  return ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)


@pytest.mark.parametrize('normalization', ['phase', None])
@pytest.mark.parametrize('shape, shift', [((64, 48), (5, -7)),
                                          ((16, 24, 20), (-3, 4, 9))])
def test_phase_cross_correlation(shape, shift, normalization):
  rng = np.random.RandomState(len(shape))
  ref_img = rng.rand(*shape).astype(np.float32)
  mov = np.roll(ref_img, shift, tuple(range(len(shape))))
  j_shift, j_err, j_diff = j_reg.phase_cross_correlation(
      ref_img, mov, normalization=normalization)
  t_shift, t_err, t_diff = t_reg.phase_cross_correlation(
      ref_img, mov, normalization=normalization, device='cpu')
  np.testing.assert_array_equal(t_shift, j_shift)
  np.testing.assert_array_equal(t_shift, -np.asarray(shift, np.float32))
  assert t_shift.dtype == np.float32
  np.testing.assert_allclose(t_err, j_err, rtol=1e-5, atol=1e-5)
  assert t_diff == j_diff == 0.0


def _affine_pair(n=96, seed=1):
  """An [x, y] texture and its copy moved by a known affine M (xy rows):
  mov(M p) = fix(p)."""
  fix = _texture(n, seed).T
  th = np.deg2rad(2.0)
  m = np.array([[1.01 * np.cos(th), -np.sin(th), 1.5],
                [np.sin(th), np.cos(th), -0.7], [0, 0, 1]])
  inv = np.linalg.inv(m)
  mov = ndimage.affine_transform(fix, inv[:2, :2], inv[:2, 2], order=1,
                                 mode='nearest')
  return fix, mov.astype(np.float32), m[:2]


@pytest.mark.parametrize('motion', ['translation', 'euclidean', 'affine'])
def test_optim_transform(motion):
  fix, mov, truth = _affine_pair()
  j_cc, j_m = j_reg.optim_transform(fix, mov, num_iters=60, motion=motion)
  t_cc, t_m = t_reg.optim_transform(fix, mov, num_iters=60, motion=motion,
                                    device='cpu')
  assert t_m.dtype == np.float64 and t_m.shape == (2, 3)
  np.testing.assert_allclose(t_m, j_m, atol=1e-3)
  assert abs(t_cc - j_cc) < 1e-4
  if motion == 'affine':
    np.testing.assert_allclose(t_m, truth, atol=0.05)
  if motion == 'euclidean':
    np.testing.assert_allclose(t_m[:, :2] @ t_m[:, :2].T, np.eye(2),
                               atol=1e-6)


def test_optim_transform_initial_and_unknown_motion():
  fix, mov, _ = _affine_pair(seed=2)
  init = np.array([[1.0, 0.0, 1.0], [0.0, 1.0, -1.0]], np.float32)
  j_cc, j_m = j_reg.optim_transform(fix, mov, transform_initial=init,
                                    num_iters=20)
  t_cc, t_m = t_reg.optim_transform(fix, mov, transform_initial=init,
                                    num_iters=20, device='cpu')
  np.testing.assert_allclose(t_m, j_m, atol=1e-3)
  assert abs(t_cc - j_cc) < 1e-4
  with pytest.raises(ValueError, match='unknown motion'):
    t_reg.optim_transform(fix, mov, motion='homography', device='cpu')


def test_normal_equations_equal_the_jacobian():
  rng = np.random.RandomState(3)
  h, w = 23, 31
  gx, gy, r = (torch.from_numpy(rng.randn(h, w).astype(np.float32))
               for _ in range(3))
  ys, xs = torch.arange(h).double(), torch.arange(w).double()
  pow_y = torch.stack([ys ** k for k in range(3)], 1)
  pow_x = torch.stack([xs ** k for k in range(3)], 1)
  jtj, jtr = t_reg._normal_equations(gx, gy, r, pow_y, pow_x)
  yy, xx = np.mgrid[:h, :w].astype(np.float64)
  g = [gx.double().numpy(), gy.double().numpy()]
  jmat = np.stack([c.ravel() for c in (g[0] * xx, g[0] * yy, g[0],
                                       g[1] * xx, g[1] * yy, g[1])], 1)
  # The products of two images are formed in float32, then summed in
  # float64.
  np.testing.assert_allclose(jtj.numpy(), jmat.T @ jmat, rtol=1e-6)
  np.testing.assert_allclose(jtr.numpy(), jmat.T @ r.double().numpy().ravel(),
                             rtol=1e-6, atol=1e-4)
