"""Per-axis peak windows: `min_distance` / `peak_radius` as an int or a
per-axis sequence, in the port and in sofima_tpu (CPU, plain versions).

The reference's `_batched_peaks` takes either form for both windows (the
local-max window and the sharpness window). The same seeded inputs go
through `dense_flow_field(circular=True)` (K1's plain version, and the
masked K5's) and the calculator's padfield mode with min_distance=(1, 3),
peak_radius=(4, 2), and through `batched_peaks` on 2d and 3d surfaces;
`coarse_to_fine_flow` (K1 then K2), whose reference takes int windows
only, against the reference's peak step; a sequence whose entries are
equal must give the scalar call's bits.
Tolerances: integer x/y peaks and NaN placement exact; sharpness and
ratio rtol = atol = 3e-4 (tests/test_torch_flow.py's bar).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch.ops import cuda_flow

torch.set_num_threads(2)

MIN_DISTANCE = (1, 3)
PEAK_RADIUS = (4, 2)


def _texture(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  return (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)


def _pair(n=240, seed=5, shift=(3, -5)):
  pre = _texture(n, seed)
  return pre, np.roll(pre, shift, (0, 1))


def _assert_flow_equal(got, ref):
  got, ref = np.asarray(got), np.asarray(ref)
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  np.testing.assert_allclose(got[2:], ref[2:], rtol=3e-4, atol=3e-4,
                             equal_nan=True)


def _same_bits(a, b):
  a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
  return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                               b.view(np.int32))


@pytest.mark.parametrize('md, pr, shape', [
    ((1, 3), (4, 2), (33, 41)),
    ((3, 1), (2, 5), (40, 40)),
    ((1, 2, 3), (2, 3, 1), (12, 17, 19)),
])
def test_batched_peaks_matches_reference(md, pr, shape):
  rng = np.random.RandomState(7)
  img = rng.rand(6, *shape).astype(np.float32)
  img[1] = 0.5                               # flat: no local max above thr
  img[2, (0,) * len(shape)] = np.nan         # a NaN anywhere: NaN row
  center = tuple(s // 2 for s in shape)
  ref = np.asarray(jff._batched_peaks(jnp.asarray(img), center, md, 0.5, pr))
  got = cuda_flow.batched_peaks(torch.from_numpy(img), center, md, 0.5,
                                pr).numpy()
  _assert_flow_equal(got.T, ref.T)


def test_equal_entries_give_the_scalar_bits():
  rng = np.random.RandomState(8)
  img = torch.from_numpy(rng.rand(5, 48, 40).astype(np.float32))
  a = cuda_flow.batched_peaks(img, (24, 20), 2, 0.5, 5)
  b = cuda_flow.batched_peaks(img, (24, 20), (2, 2), 0.5, [5, 5])
  assert _same_bits(a.numpy(), b.numpy())
  pre, post = _pair()
  args = ((80, 80), (40, 40))
  kw = dict(circular=True)
  a = tff.dense_flow_field(torch.from_numpy(pre), torch.from_numpy(post),
                           *args, min_distance=2, peak_radius=5, **kw)
  b = tff.dense_flow_field(torch.from_numpy(pre), torch.from_numpy(post),
                           *args, min_distance=(2, 2), peak_radius=(5, 5),
                           **kw)
  assert _same_bits(a.numpy(), b.numpy())
  scalar = tff.JAXMaskedXCorrWithStatsCalculator(device='cpu').flow_field(
      pre, post, 80, 40, batch_size=16)
  seq = tff.JAXMaskedXCorrWithStatsCalculator(
      peak_min_distance=(2, 2), peak_radius=(5, 5),
      device='cpu').flow_field(pre, post, 80, 40, batch_size=16)
  assert _same_bits(scalar, seq)


def test_wrong_length_raises():
  img = torch.zeros((1, 9, 9))
  with pytest.raises(ValueError):
    cuda_flow.batched_peaks(img, (4, 4), (1, 2, 3), 0.5, 5)


@pytest.mark.parametrize('masked', [False, True])
def test_dense_flow_field_per_axis(masked):
  pre, post = _pair(seed=6)
  mask = None
  if masked:
    mask = np.zeros(pre.shape, bool)
    mask[100:130, 20:200] = True
  kw = dict(min_distance=MIN_DISTANCE, peak_radius=PEAK_RADIUS,
            circular=True)
  ref = jff.dense_flow_field(
      jnp.asarray(pre), jnp.asarray(post), (80, 80), (40, 40),
      pre_mask=None if mask is None else jnp.asarray(mask), **kw)
  got = tff.dense_flow_field(
      torch.from_numpy(pre), torch.from_numpy(post), (80, 80), (40, 40),
      pre_mask=None if mask is None else torch.from_numpy(mask), **kw)
  _assert_flow_equal(got.numpy(), ref)
  scalar = tff.dense_flow_field(
      torch.from_numpy(pre), torch.from_numpy(post), (80, 80), (40, 40),
      pre_mask=None if mask is None else torch.from_numpy(mask),
      circular=True)
  assert not _same_bits(got.numpy()[2:], scalar.numpy()[2:])


def test_calculator_padfield_per_axis():
  pre, post = _pair(seed=9, shift=(-4, 2))
  kw = dict(peak_min_distance=MIN_DISTANCE, peak_radius=PEAK_RADIUS)
  ref = jff.JAXMaskedXCorrWithStatsCalculator(**kw).flow_field(
      pre, post, 80, 40, batch_size=16)
  got = tff.JAXMaskedXCorrWithStatsCalculator(**kw, device='cpu').flow_field(
      pre, post, 80, 40, batch_size=16)
  _assert_flow_equal(got, ref)


def test_coarse_to_fine_per_axis(monkeypatch):
  """The reference's coarse_to_fine_flow takes int windows only (its
  grid kernels loop to `min_distance`: a sequence raises TypeError), so
  the port's per-axis run is held against the port's chain with every
  peak step (K1's and K2's plain versions) taken by the reference's
  `_batched_peaks`, the only step the windows reach."""
  pre, post = _pair(n=320, seed=10, shift=(6, -9))
  kw = dict(min_distance=MIN_DISTANCE, peak_radius=PEAK_RADIUS)
  with pytest.raises(TypeError):
    jff.coarse_to_fine_flow(jnp.asarray(pre), jnp.asarray(post), (80, 80),
                            (40, 40), **kw)

  def run():
    return tff.coarse_to_fine_flow(
        torch.from_numpy(pre), torch.from_numpy(post), (80, 80), (40, 40),
        return_overflow=True, **kw)

  got, got_over = run()

  def ref_peaks(img, center, md, thr, pr):
    return torch.from_numpy(np.array(jff._batched_peaks(
        jnp.asarray(img.numpy()), tuple(int(c) for c in center), md, thr,
        pr)))

  monkeypatch.setattr(cuda_flow, 'batched_peaks', ref_peaks)
  ref, ref_over = run()
  _assert_flow_equal(got.numpy(), ref.numpy())
  assert bool(got_over) == bool(ref_over)
  assert np.isfinite(got.numpy()[0]).mean() > 0.9
