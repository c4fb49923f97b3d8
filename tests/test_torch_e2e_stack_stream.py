"""examples/e2e_stack_stream.py's chain in sofima_tpu and sofima_tpu_torch (CPU).

The example's synthetic stack (its seeded texture, cumulative drift plus
a low-frequency wobble per section, sampled with the reference's linear
sampler) aligned by `stack_align.align_stack` with the example's
configuration (`max_displacement=64`, `residual=8`) in both packages
(the port with device='cpu'), cut from the example's 1024^2 x 6 to
640^2 x 2. One pair keeps the file near its floor, the reference's jit
compile of the chain, which does not shrink with the stack; the
section-to-section hand-off of the solved mesh is held against the
reference in tests/test_torch_stack_align.py. Both renders must pass
the example's gate (every section's mean residual against the base frame on the interior [160:-160] below a
third of the residual before). Between the packages: the overflow flag
equal, the solved meshes within 0.4 px (0.01 x stride, the pipeline's
fixed-point bar) with equal NaN patterns, each section's residual within
2% of the reference's and the renders within 0.1 gray levels on average.
The port correlates in float32 where the reference feeds bfloat16 to the
matrix unit, so the meshes differ by up to ~0.34 px and the renders by
several gray levels on a few steep pixels, which is why the render bar
is a mean.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu.ops import interp as jinterp
from sofima_tpu.pipeline import stack_align as jsa
from sofima_tpu_torch.pipeline import stack_align as tsa

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))
import e2e_stack_stream  # noqa: E402  (the example's texture)

torch.set_num_threads(2)
N, SECTIONS = 640, 2
INTERIOR = np.s_[160:-160, 160:-160]


def _stack():
  """The example's stack at N^2 x SECTIONS."""
  base = e2e_stack_stream.make_texture(N)
  yy, xx = np.mgrid[:N, :N].astype(np.float32)
  sections = [base]
  for z in range(1, SECTIONS):
    dy = 2.5 * z + 5.0 * np.sin(2 * np.pi * xx / N + 0.7 * z)
    dx = -2.0 * z + 5.0 * np.cos(2 * np.pi * yy / N + 0.4 * z)
    coords = jnp.stack([jnp.asarray(yy + dy), jnp.asarray(xx + dx)])
    sections.append(np.asarray(jinterp.sample(
        jnp.asarray(base), coords, method='linear', mode='nearest')))
  return base, np.stack(sections).astype(np.uint8)


@pytest.fixture(scope='module')
def chains():
  base, stack = _stack()
  want = jsa.align_stack(stack, jsa.StackAlignConfig(max_displacement=64,
                                                     residual=8))
  got = tsa.align_stack(stack, tsa.StackAlignConfig(max_displacement=64,
                                                    residual=8),
                        device='cpu')
  as_np = [tuple(np.asarray(v) for v in want),
           tuple(v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in got)]
  return base, stack, as_np[0], as_np[1]


def _residuals(base, stack, rendered):
  """The example's (before, after) mean residual of each section."""
  out = []
  for z in range(1, SECTIONS):
    before = np.abs(stack[z].astype(np.float32)[INTERIOR]
                    - base[INTERIOR]).mean()
    after = np.abs(rendered[z][INTERIOR] - base[INTERIOR]).mean()
    out.append((float(before), float(after)))
  return out


@pytest.mark.parametrize('side', ['reference', 'port'])
def test_example_gate(chains, side):
  base, stack, want, got = chains
  rendered = (want if side == 'reference' else got)[0]
  for z, (before, after) in enumerate(_residuals(base, stack, rendered), 1):
    print(f'{side} z={z}: |err| raw={before:6.2f}  aligned={after:6.2f}')
    assert after < before / 3, (side, z, before, after)


def test_overflow_flag_equal(chains):
  _, _, want, got = chains
  assert bool(got[2]) == bool(want[2]) is False


def test_solved_meshes_match(chains):
  _, _, want, got = chains
  assert got[1].shape == want[1].shape
  np.testing.assert_array_equal(np.isnan(got[1]), np.isnan(want[1]))
  np.testing.assert_allclose(got[1], want[1], rtol=0, atol=0.4)


def test_renders_match(chains):
  base, stack, want, got = chains
  for (_, a_ref), (_, a_port) in zip(_residuals(base, stack, want[0]),
                                     _residuals(base, stack, got[0])):
    assert abs(a_port - a_ref) <= 0.02 * a_ref, (a_port, a_ref)
  for z in range(1, SECTIONS):
    diff = np.abs(got[0][z] - want[0][z])[INTERIOR]
    assert diff.mean() <= 0.1, (z, diff.mean())
