"""The library-API alignment chain of examples/e2e_alignment.py through
sofima_tpu_torch against sofima_tpu (CPU, plain versions), at 384^2.

One synthetic section pair (e2e_alignment's band-limited texture and its
smooth deformation at its default amplitude, 12 px, applied with the JAX
package's linear sampler) goes through both packages' chain:
calculator flow (padfield mode), `clean_flow`, padding onto the node
grid, the fused FIRE solve with e2e's IntegrationConfig (K3's plain
version in the port), `invert_map` + `fill_missing(extrapolate=True)`,
`warp_subvolume(interpolation='lanczos')`, and the residual padfield
flow between the render and the reference section. Both must pass
e2e's gate (mean residual flow under 1.5 px and under a fifth of the
mean before). The size is the smallest that keeps e2e's 12 px
deformation smooth enough for that gate with 64 px patches at stride 16:
at 256^2 the reference itself measures 7.65 px before and 1.94 after,
at 320^2 (10 px) 6.04 and 1.28; at 384^2 7.52 and 1.11. Between the packages: flow x/y and NaN exact, the cleaned
flow equal, meshes and inverted maps within 0.01 x stride, the render
within 1 gray level on at most 1e-3 of the pixels.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu import flow_utils as jfu
from sofima_tpu import map_utils as jmap
from sofima_tpu import mesh as jmesh
from sofima_tpu import warp as jwarp
from sofima_tpu.ops import interp as jinterp
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu_torch import convert
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch import flow_utils as tfu
from sofima_tpu_torch import map_utils as tmap
from sofima_tpu_torch import warp as twarp
from sofima_tpu_torch.ops import cuda_mesh
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'examples'))
import e2e_alignment  # noqa: E402  (the JAX example's data generators)

torch.set_num_threads(2)
N, STRIDE, PATCH = 384, 16, 64


def _pair():
  pre = e2e_alignment.make_texture(N)
  deform = e2e_alignment.smooth_deformation(N, 12.0)
  grid = np.mgrid[:N, :N].astype(np.float32)
  post = np.asarray(jinterp.sample(
      jnp.asarray(pre.astype(np.float32)),
      jnp.asarray(np.stack([grid[0] + deform[1], grid[1] + deform[0]])),
      method='linear', mode='nearest')).astype(np.uint8)
  return pre, post


def _config():
  return jmesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(STRIDE, STRIDE),
      num_iters=1000, max_iters=100000, stop_v_max=0.005, dt_max=100.0,
      start_cap=0.01, final_cap=10.0, cap_scale=1.1, prefer_orig_order=True)


def _chain(pkg, pre, post):
  """e2e_alignment's chain through one package -> dict of stages."""
  jax_side = pkg == 'jax'
  calc = (jff.JAXMaskedXCorrWithStatsCalculator() if jax_side else
          tff.JAXMaskedXCorrWithStatsCalculator(device='cpu'))
  dev = {} if jax_side else dict(device='cpu')
  flow = np.asarray(calc.flow_field(pre, post, patch_size=PATCH, step=STRIDE,
                                    batch_size=256))
  fu = jfu if jax_side else tfu
  clean = fu.clean_flow(flow[:, None], min_peak_ratio=1.6,
                        min_peak_sharpness=1.6, max_magnitude=40,
                        max_deviation=10, **dev)
  pad = PATCH // 2 // STRIDE
  g = N // STRIDE
  full = np.full((2, 1, g, g), np.nan, np.float32)
  full[:, :, pad:pad + clean.shape[2], pad:pad + clean.shape[3]] = clean
  cfg = _config()
  if jax_side:
    solved = np.asarray(jmesh.relax_mesh_fused(
        jnp.zeros_like(jnp.asarray(full)), jnp.asarray(full), cfg)[0])
    box = JBox(start=(0, 0, 0), size=(g, g, 1))
    img_box = JBox(start=(0, 0, 0), size=(N, N, 1))
  else:
    prev = torch.from_numpy(full)
    solved = cuda_mesh.relax_mesh_fused(
        torch.zeros_like(prev), prev, convert.config_from_jax(cfg))[0].numpy()
    box = TBox(start=(0, 0, 0), size=(g, g, 1))
    img_box = TBox(start=(0, 0, 0), size=(N, N, 1))
  mu = jmap if jax_side else tmap
  inv = mu.invert_map(solved, box, box, STRIDE, **dev)
  inv = mu.fill_missing(inv, extrapolate=True, **dev)
  wp = jwarp if jax_side else twarp
  rendered = wp.warp_subvolume(post[None, None], img_box, inv, box, STRIDE,
                               img_box, interpolation='lanczos', **dev)
  resid = np.asarray(calc.flow_field(pre, rendered[0, 0], patch_size=PATCH,
                                     step=STRIDE, batch_size=256))
  before = np.nanmean(np.hypot(flow[0], flow[1]))
  after = np.nanmean(np.hypot(resid[0], resid[1]))
  return dict(flow=flow, clean=clean, solved=solved, inv=inv,
              rendered=rendered, before=before, after=after)


def test_e2e_alignment_chain():
  pre, post = _pair()
  ref = _chain('jax', pre, post)
  got = _chain('torch', pre, post)
  for r in (ref, got):
    assert r['after'] < 1.5 and r['after'] < r['before'] / 5, (
        r['before'], r['after'])
  np.testing.assert_array_equal(np.nan_to_num(got['flow'][:2], nan=9e9),
                                np.nan_to_num(ref['flow'][:2], nan=9e9))
  np.testing.assert_array_equal(got['clean'], ref['clean'])
  tol = 0.01 * STRIDE
  for key in ('solved', 'inv'):
    np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]))
    np.testing.assert_allclose(got[key], ref[key], atol=tol, rtol=0)
  d = np.abs(got['rendered'].astype(int) - ref['rendered'].astype(int))
  assert d.max() <= 1 and (d > 0).mean() <= 1e-3
  assert got['rendered'].dtype == np.uint8
