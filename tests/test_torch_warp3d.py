"""3d render of sofima_tpu_torch against sofima_tpu (CPU, plain version).

The plain version of kernel K13 (ops.cuda_warp.shift_warp_3d) against
`pallas_warp.pallas_shift_warp_3d` in interpret mode on a small volume,
trilinear and Lanczos4, with NaN coordinates, taps outside the volume,
displacements past the static bounds (where the TPU lattice has no
shift, a tap adds nothing) and a nonzero origin. Tolerance: max |diff|
< 1e-2 gray levels (the bar the 2d render is held to); the arithmetic
is the same sum in the same order, so the measured difference is f32
rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu.ops import pallas_warp
from sofima_tpu_torch.ops import cuda_warp

torch.set_num_threads(2)


def _case(seed=0, shape=(10, 20, 36), out=(12, 22, 40), origin=(-1, -1, -2)):
  rng = np.random.RandomState(seed)
  vol = (rng.rand(*shape) * 255).astype(np.float32)
  zz, yy, xx = np.meshgrid(*[np.arange(n, dtype=np.float32) + o
                             for n, o in zip(out, origin)], indexing='ij')
  coords = np.stack([
      zz + 0.8 * np.sin(yy / 5.0) + 0.3,
      yy + 1.7 * np.cos(xx / 7.0) - 0.4,
      xx + 2.2 * np.sin(zz / 3.0 + yy / 9.0) + 0.6,
  ]).astype(np.float32)
  # Displacements past the static bounds in a block ...
  coords[2, 3:5, 4:9, 10:20] += 3.4
  coords[1, 6:8, 10:15, 5:12] -= 2.9
  # ... NaN coordinates and taps far outside the volume.
  coords[:, 0, 0, :5] = np.nan
  coords[1, 9, 3, 3] = np.nan
  coords[0, -1, -3:, -6:] += 9.0
  return vol, coords, origin


# The Lanczos lattice is 8 shifts wider per axis, and the reference
# unrolls its product: a narrower y bound keeps its compile short.
@pytest.mark.parametrize('method,bounds', [
    ('linear', (-2, 2, -2, 2, -2, 2)),
    ('lanczos', (-1, 1, 0, 0, -2, 1))])
def test_matches_pallas_kernel(method, bounds):
  vol, coords, origin = _case()
  ref = np.asarray(pallas_warp.pallas_shift_warp_3d(
      jnp.asarray(vol), jnp.asarray(coords), method, *bounds,
      origin_z=origin[0], origin_y=origin[1], origin_x=origin[2],
      interpret=True))
  got = cuda_warp.shift_warp_3d(torch.from_numpy(vol),
                                torch.from_numpy(coords), method, *bounds,
                                *origin).numpy()
  assert got.shape == ref.shape
  assert np.abs(got - ref).max() < 1e-2
  # The bounds bite: a wider lattice renders those voxels differently.
  wide = cuda_warp.shift_warp_3d(torch.from_numpy(vol),
                                 torch.from_numpy(coords), method,
                                 -6, 6, -6, 6, -6, 6, *origin).numpy()
  assert np.abs(wide - got).max() > 1.0
  assert (got[0, 0, :5] == 0).all()


def test_asymmetric_bounds_zero_origin():
  vol, coords, _ = _case(seed=1, out=(10, 20, 36), origin=(0, 0, 0))
  bounds = (-1, 2, -3, 1, -2, 3)
  ref = np.asarray(pallas_warp.pallas_shift_warp_3d(
      jnp.asarray(vol), jnp.asarray(coords), 'linear', *bounds,
      interpret=True))
  got = cuda_warp.shift_warp_3d(torch.from_numpy(vol),
                                torch.from_numpy(coords), 'linear',
                                *bounds).numpy()
  assert np.abs(got - ref).max() < 1e-2


def test_bad_arguments_raise():
  vol = torch.zeros(4, 5, 6)
  with pytest.raises(ValueError):
    cuda_warp.shift_warp_3d(vol, torch.zeros(2, 4, 5, 6), 'linear',
                            0, 0, 0, 0, 0, 0)
  with pytest.raises(ValueError):
    cuda_warp.shift_warp_3d(vol, torch.zeros(3, 4, 5, 6), 'bogus',
                            0, 0, 0, 0, 0, 0)
