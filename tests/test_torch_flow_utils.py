"""Flow cleaning, reconciliation and connected components of
sofima_tpu_torch against sofima_tpu (CPU, plain versions).

The same numpy-seeded flows go through sofima_tpu.flow_utils
(`clean_flow`, `reconcile_flows`, `_steep_gradient`) and
sofima_tpu.ops.morphology (`label_components`, `component_sizes`,
`small_component_mask`) and the port's twins (device='cpu'). Everything
here is a selection or a median of the inputs, so the outputs agree
exactly, NaN pattern included; component labels are compared as
partitions (label values are arbitrary in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_utils as jfu
from sofima_tpu.ops import morphology as jmorph
from sofima_tpu_torch import flow_utils as tfu
from sofima_tpu_torch.ops import morphology as tmorph

torch.set_num_threads(2)


def _flow(seed, shape=(1, 24, 30), nan_share=0.1):
  rng = np.random.RandomState(seed)
  f = np.stack([
      rng.randn(*shape) * 3 + 2.0, rng.randn(*shape) * 3 - 1.0,
      rng.rand(*shape) * 4, rng.choice([0.0, 1.2, 2.5], size=shape)
  ]).astype(np.float32)
  f[:2, rng.rand(*shape) < nan_share] = np.nan
  f[0, 0, 5:8, 10:14] += 40.0  # an outlier block
  return f


@pytest.mark.parametrize('kw', [
    dict(min_peak_ratio=1.6, min_peak_sharpness=1.6, max_magnitude=40,
         max_deviation=10),
    dict(min_peak_ratio=0, min_peak_sharpness=0, max_magnitude=0,
         max_deviation=2),
])
def test_clean_flow(kw):
  f = _flow(0)
  ref = jfu.clean_flow(f, **kw)
  got = tfu.clean_flow(f, device='cpu', **kw)
  assert got.shape == ref.shape == (2, 1, 24, 30)
  np.testing.assert_array_equal(got, ref)
  # dim + 1 channels keep the extra channel, as the reference does.
  f3 = f[:3].copy()
  np.testing.assert_array_equal(
      tfu.clean_flow(f3, 0, 0, 5, 3, device='cpu'),
      jfu.clean_flow(f3, 0, 0, 5, 3))


def test_steep_gradient():
  rng = np.random.RandomState(1)
  comp = rng.randn(2, 9, 11).astype(np.float32) * 3
  comp[0, 3, 4] = np.nan
  for axis in (-1, -2):
    np.testing.assert_array_equal(tfu._steep_gradient(comp, axis, 2.5),
                                  jfu._steep_gradient(comp, axis, 2.5))


@pytest.mark.parametrize('kw', [
    dict(max_gradient=0, max_deviation=20, min_patch_size=0),
    dict(max_gradient=4, max_deviation=5, min_patch_size=6),
    dict(max_gradient=0, max_deviation=0, min_patch_size=30),
])
def test_reconcile_flows(kw):
  a = _flow(2, nan_share=0.3)[:2]
  b = _flow(3, nan_share=0.2)[:2]
  c = _flow(4, nan_share=0.05)[:2]
  ref = jfu.reconcile_flows([a, b, c], **kw)
  got = tfu.reconcile_flows([a, b, c], device='cpu', **kw)
  np.testing.assert_array_equal(got, ref)
  assert np.isnan(got).any() and np.isfinite(got).any()


def test_reconcile_flows_min_delta_z():
  rng = np.random.RandomState(5)
  a = _flow(6, nan_share=0.4)[:3]
  b = _flow(7, nan_share=0.0)[:3]
  b[2] = rng.choice([0.0, 1.0, 3.0], size=b.shape[1:])
  ref = jfu.reconcile_flows([a, b], 0, 0, 0, min_delta_z=2)
  got = tfu.reconcile_flows([a, b], 0, 0, 0, min_delta_z=2, device='cpu')
  np.testing.assert_array_equal(got, ref)


def _partition_equal(got, ref, mask):
  assert (got[~mask] == -1).all() and (ref[~mask] == -1).all()
  pairs = set(zip(got[mask].tolist(), ref[mask].tolist()))
  assert len(pairs) == len(np.unique(got[mask])) == len(np.unique(ref[mask]))


@pytest.mark.parametrize('seed', [0, 1])
def test_components(seed):
  rng = np.random.RandomState(seed)
  mask = rng.rand(31, 27) < 0.55
  # A serpentine: the geodesic length pointer jumping has to cover.
  mask[:, 20] = False
  for r in range(0, 31, 2):
    mask[r, 21:] = True
    mask[r + 1 if r + 1 < 31 else r, 21 if (r // 2) % 2 else 26] = True
  ref = np.asarray(jmorph.label_components(jnp.asarray(mask)))
  got = tmorph.label_components(torch.from_numpy(mask)).numpy()
  _partition_equal(got, ref, mask)
  np.testing.assert_array_equal(
      tmorph.component_sizes(torch.from_numpy(got)).numpy(),
      np.asarray(jmorph.component_sizes(jnp.asarray(ref))))
  for size in (1, 4, 12):
    np.testing.assert_array_equal(
        tmorph.small_component_mask(torch.from_numpy(mask), size).numpy(),
        np.asarray(jmorph.small_component_mask(jnp.asarray(mask), size)))
