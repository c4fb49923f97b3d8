"""Signatures of sofima_tpu_torch's public functions against sofima_tpu's (CPU).

The reference's own calls must work on the port. Each function below
takes the reference's parameters in the reference's order, with its
names and defaults; the port may only add parameters at the end
(`device`, `timings`). Then the calls that once raised or shifted:
  * masked_xcorr(..., use_jax=True, dim=2, per_item=True), as
    sofima_tpu/stitch_rigid.py calls it, and a dim=3 call over a batch,
    each against the reference within atol 1e-4 (test_torch_montage.py's
    masked NCC bar);
  * coarse_to_fine_flow(..., batch_size=..., bf16=True) by keyword:
    equal to the call without them (the port computes in float32 and
    sizes its own launches) and to the reference's float32 flow.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu.pipeline import stitch3d as js3
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch.pipeline import stitch3d as ts3

torch.set_num_threads(2)

# (reference, port, parameters the port may add at the end)
CASES = {
    'coarse_to_fine_flow': (jff.coarse_to_fine_flow, tff.coarse_to_fine_flow,
                            ()),
    'masked_xcorr': (jff.masked_xcorr, tff.masked_xcorr, ()),
    'dense_flow_field': (jff.dense_flow_field, tff.dense_flow_field, ()),
    'stitch_and_render_3d': (js3.stitch_and_render_3d,
                             ts3.stitch_and_render_3d, ('device', 'timings')),
}


def _params(fn):
  fn = inspect.unwrap(fn)
  return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('name', sorted(CASES))
def test_signature_matches_reference(name):
  ref_fn, port_fn, extra = CASES[name]
  ref, port = _params(ref_fn), _params(port_fn)
  assert [n for n, _ in port[:len(ref)]] == [n for n, _ in ref]
  for (n, d_port), (_, d_ref) in zip(port, ref):
    if d_ref is inspect.Parameter.empty:
      assert d_port is inspect.Parameter.empty, n
    else:
      assert d_port == d_ref, (n, d_port, d_ref)
  assert tuple(n for n, _ in port[len(ref):]) == extra


def _masked_pair(shape_prev, shape_curr, seed):
  rng = np.random.RandomState(seed)
  prev = rng.rand(*shape_prev).astype(np.float32)
  curr = rng.rand(*shape_curr).astype(np.float32)
  prev[1] *= 0.01  # a low-contrast item: per-item thresholds differ
  return (prev, curr, rng.rand(*prev.shape) < 0.2,
          rng.rand(*curr.shape) < 0.3)


@pytest.mark.parametrize('dim, shapes', [
    (2, ((3, 30, 24), (3, 26, 20))),
    (3, ((2, 6, 12, 10), (2, 5, 9, 8))),
])
def test_masked_xcorr_reference_call(dim, shapes):
  prev, curr, pm, cm = _masked_pair(*shapes, seed=dim)
  ref = np.asarray(jff.masked_xcorr(prev, curr, pm, cm, use_jax=True,
                                    dim=dim, per_item=True))
  got = tff.masked_xcorr(torch.from_numpy(prev), torch.from_numpy(curr),
                         torch.from_numpy(pm), torch.from_numpy(cm),
                         use_jax=True, dim=dim, per_item=True)
  assert got.shape == ref.shape
  assert ref.shape[-dim:] == tuple(a + b - 1 for a, b in
                                   zip(shapes[0][-dim:], shapes[1][-dim:]))
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def _texture(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  return (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)


def test_coarse_to_fine_flow_bf16_keyword():
  pre = _texture(128, seed=4)
  post = np.roll(pre, (3, -2), (0, 1))
  kw = dict(patch_size=(32, 32), step=(16, 16), max_displacement=16,
            residual=4)
  got = tff.coarse_to_fine_flow(torch.from_numpy(pre), torch.from_numpy(post),
                                batch_size=8, bf16=True, **kw).numpy()
  plain = tff.coarse_to_fine_flow(torch.from_numpy(pre),
                                  torch.from_numpy(post), **kw).numpy()
  ref = np.asarray(jff.coarse_to_fine_flow(jnp.asarray(pre),
                                           jnp.asarray(post), bf16=False,
                                           **kw))
  np.testing.assert_array_equal(got, plain)
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  assert np.isfinite(got[:2]).any()
