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

import jax.numpy as jnp
import numpy as np
import pytest
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
