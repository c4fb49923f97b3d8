"""ReconcileCrossBlockMaps of sofima_tpu_torch against sofima_tpu (CPU).

Twins of tests/test_cross_block.py. The closed-form cases (constant
maps, forward and backward, NaN passthrough) run both processors on the
same maps and hold each to the reference test's closed form. The two-
level blockwise solve builds its 9-section stack, flows and block
meshes once, with the port (device='cpu'); both packages' processors
then blend the same maps, and the port's blend meets the reference
test's gates (block starts pinned to the cross-block solution, no jump
at z=4, a contiguous render across the boundary).
Tolerances: the blended maps of the two packages within 0.01 x stride
(the reference's solver fixed-point bar), NaN pattern equal; the closed
forms within the reference test's 0.05 px.
"""

import numpy as np
import pytest
import torch

from sofima_tpu.processor import maps as j_maps
from sofima_tpu.utils.bounding_box import BoundingBox as JBox
from sofima_tpu.utils.subvolume import Subvolume as JSub
from sofima_tpu.utils.volume import InMemoryVolume as JVol
from sofima_tpu_torch.processor import maps as t_maps
from sofima_tpu_torch.utils.bounding_box import BoundingBox as TBox
from sofima_tpu_torch.utils.subvolume import Subvolume as TSub
from sofima_tpu_torch.utils.volume import InMemoryVolume as TVol

torch.set_num_threads(2)

PKGS = ((j_maps, JBox, JSub, JVol, {}),
        (t_maps, TBox, TSub, TVol, {'device': 'cpu'}))


def _const_map(value_xy, nz, n):
  m = np.zeros((2, nz, n, n), np.float32)
  m[0] = value_xy[0]
  m[1] = value_xy[1]
  return m


def _blend(volumes, data, z_map, stride, xy_overlap, backward=False):
  """Runs both packages' ReconcileCrossBlockMaps -> (reference, port)."""
  outs = []
  for maps, box_cls, sub_cls, vol_cls, kw in PKGS:
    cfg = maps.ReconcileCrossBlockMaps.Config(
        cross_block=vol_cls(volumes['xblock']),
        cross_block_inv=vol_cls(volumes['xblock_inv']),
        last_inv=vol_cls(volumes['last_inv']),
        main_inv=vol_cls(volumes['main_inv']), z_map=z_map, stride=stride,
        xy_overlap=xy_overlap, backward=backward)
    nz, n = data.shape[1], data.shape[2]
    box = box_cls(start=(0, 0, 0), size=(data.shape[3], n, nz))
    outs.append(maps.ReconcileCrossBlockMaps(cfg, **kw).process(
        sub_cls(data.copy(), box)))
  ref, got = outs
  np.testing.assert_array_equal(got.bbox.start, ref.bbox.start)
  np.testing.assert_array_equal(got.bbox.size, ref.bbox.size)
  np.testing.assert_array_equal(np.isnan(got.data), np.isnan(ref.data))
  np.testing.assert_allclose(got.data, ref.data, atol=0.01 * stride,
                             equal_nan=True)
  return got


def _boundary_volumes(nz, n):
  xblock_vals = {0: (1.0, 0.0), 4: (5.0, 0.0), 8: (9.0, 0.0)}
  xblock = np.zeros((2, nz, n, n), np.float32)
  xblock_inv = np.zeros((2, nz, n, n), np.float32)
  for z, (vx, vy) in xblock_vals.items():
    xblock[0, z], xblock[1, z] = vx, vy
    xblock_inv[0, z], xblock_inv[1, z] = -vx, -vy
  return xblock_vals, dict(xblock=xblock, xblock_inv=xblock_inv,
                           last_inv=_const_map((-3.0, 0.0), nz, n),
                           main_inv=_const_map((-2.0, 0.0), nz, n))


@pytest.mark.parametrize('backward', [False, True])
def test_constant_map_blend(backward):
  n, block, nz = 8, 4, 9
  data = _const_map((2.0, 0.0), nz, n)
  xblock_vals, volumes = _boundary_volumes(nz, n)
  out = _blend(volumes, data, {'0': 0, '4': 4, '8': 8}, 4, 4, backward)
  for zi in range(out.data.shape[1]):
    z = zi + int(out.bbox.start[2])
    z0 = 0 if z < block else block
    z1 = block if z < block else 2 * block
    i = z - z0
    if backward:
      xpost = xblock_vals[z0][0]
      xpre = xblock_vals[z1][0] if z1 != 8 else 0.0
      bend = 2.0 if z0 == 0 else 3.0
      first, last = xpost, xpre
      scale = (block - i) / block
    else:
      xpre = xblock_vals[z0][0] if z0 > 0 else 0.0
      xpost = xblock_vals[z1][0]
      bend = 3.0 if z1 != 8 else 2.0
      first, last = xpre, xpost
      scale = i / block
    if i == 0:
      expected = first
    elif i == block:
      expected = last
    else:
      expected = 2.0 + xpre + scale * (-xpre - bend + xpost)
    np.testing.assert_allclose(out.data[0, zi], expected, atol=0.05,
                               err_msg=f'z={z}')
    np.testing.assert_allclose(out.data[1, zi], 0.0, atol=0.05)


def test_nan_passthrough():
  n, nz = 8, 5
  data = _const_map((1.0, 0.0), nz, n)
  data[:, 2, 3, 3] = np.nan
  zeros = _const_map((0.0, 0.0), nz, n)
  volumes = dict(xblock=zeros, xblock_inv=zeros, last_inv=zeros,
                 main_inv=zeros)
  out = _blend(volumes, data, {'0': 0, '4': 4}, 4, 4)
  rel = np.array([2, 3, 3]) - out.bbox.start[::-1]
  assert np.isnan(out.data[(slice(None),) + tuple(rel)]).all()


def _solve_stack():
  """The reference test's 9-section stack, solved with the port.

  The force cap starts at its final value (10): the reference test's
  escalation from 0.01 takes 20 000 steps a solve, ~10 s each in the
  plain solver on one CPU core."""
  from sofima_tpu_torch import flow_field, flow_utils, map_utils, mesh
  from sofima_tpu_torch.ops import interp

  n, stride, patch = 160, 10, 40
  nz = 9
  grid_n = n // stride
  pad = patch // 2 // stride

  rng = np.random.RandomState(0)
  noise = rng.rand(n, n).astype(np.float32)
  f = np.fft.rfft2(noise)
  fy = np.fft.fftfreq(n)[:, None]
  fx = np.fft.rfftfreq(n)[None, :]
  f *= np.exp(-((fx**2 + fy**2) / (2 * 0.08**2)))
  tex = np.fft.irfft2(f, s=(n, n))
  tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.float32)

  y, x = np.mgrid[:n, :n].astype(np.float32)
  dx = 2.0 * np.sin(2 * np.pi * y / n)
  dy = 2.0 * np.cos(2 * np.pi * x / n)
  sections = np.stack([interp.sample(
      torch.from_numpy(tex), torch.from_numpy(np.stack([y + z * dy,
                                                        x + z * dx])),
      method='linear', mode='nearest').numpy() for z in range(nz)])

  mfc = flow_field.JAXMaskedXCorrWithStatsCalculator(device='cpu')
  flows = {}
  for z in range(1, nz):
    fl = mfc.flow_field(sections[z - 1], sections[z], patch_size=patch,
                        step=stride, batch_size=64)
    cl = flow_utils.clean_flow(fl[:, np.newaxis], min_peak_ratio=1.4,
                               min_peak_sharpness=1.4, max_magnitude=40,
                               max_deviation=10, device='cpu')
    full = np.full((2, 1, grid_n, grid_n), np.nan, np.float32)
    full[:, :, pad:pad + cl.shape[2], pad:pad + cl.shape[3]] = cl
    flows[z] = full

  cfg = mesh.IntegrationConfig(
      dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(stride, stride),
      num_iters=500, max_iters=20000, stop_v_max=0.01, dt_max=100.0,
      start_cap=10.0, final_cap=10.0, cap_scale=1.1)
  xcfg = mesh.IntegrationConfig(**{**cfg.__dict__, 'k0': 0.01})

  def relax(prev, config):
    prev = torch.from_numpy(prev)
    solved, _, _ = mesh.relax_mesh_fused(torch.zeros_like(prev), prev,
                                         config)
    return solved.numpy()

  def compose(flow, ref_mesh):
    return map_utils.compose_maps_fast(
        torch.from_numpy(flow), (0.0, 0.0), (stride, stride),
        torch.from_numpy(ref_mesh), (0.0, 0.0), (stride, stride)).numpy()

  zeros = np.zeros((2, 1, grid_n, grid_n), np.float32)
  main = {0: zeros.copy(), 4: zeros.copy()}
  for z in (1, 2, 3):
    main[z] = relax(compose(flows[z], main[z - 1]), cfg)
  last4 = relax(compose(flows[4], main[3]), cfg)
  for z in (5, 6, 7):
    main[z] = relax(compose(flows[z], main[z - 1]), cfg)
  last8 = relax(compose(flows[8], main[7]), cfg)
  main[8] = last8

  xblock = [zeros.copy()]
  for cross_flow in (last4, last8):
    xblock.append(relax(compose(cross_flow, xblock[-1]), xcfg))
  return dict(n=n, stride=stride, patch=patch, nz=nz, grid_n=grid_n,
              sections=sections, main=main, last4=last4,
              xblock=np.concatenate(xblock, axis=1))


def test_two_level_blockwise_solve():
  from sofima_tpu_torch import map_utils, warp
  s = _solve_stack()
  stride, grid_n, nz = s['stride'], s['grid_n'], s['nz']
  gbox = TBox(start=(0, 0, 0), size=(grid_n, grid_n, 1))

  def inv(m):
    out = map_utils.invert_map(m, gbox, gbox, stride, device='cpu')
    return map_utils.fill_missing(out, extrapolate=True, device='cpu')

  main_stack = np.concatenate([s['main'][z] for z in range(nz)], axis=1)
  main_inv = np.zeros_like(main_stack)
  main_inv[:, 8:9] = inv(s['main'][8])
  last_inv = np.zeros_like(main_stack)
  last_inv[:, 4:5] = inv(s['last4'])
  xblock_inv = np.concatenate(
      [inv(s['xblock'][:, i:i + 1]) for i in range(3)], axis=1)
  out = _blend(dict(xblock=s['xblock'], xblock_inv=xblock_inv,
                    last_inv=last_inv, main_inv=main_inv), main_stack,
               {'0': 0, '4': 1, '8': 2}, stride, 2)
  z_off = int(out.bbox.start[2])
  c_off = int(out.bbox.start[0])
  sel = np.s_[:, :, c_off:c_off + out.data.shape[2],
              c_off:c_off + out.data.shape[3]]

  def at(z):
    return out.data[:, z - z_off]

  np.testing.assert_allclose(at(4), s['xblock'][sel][:, 1], atol=1e-4)
  np.testing.assert_allclose(at(8), s['xblock'][sel][:, 2], atol=1e-4)

  def mag(d):
    return np.nanmean(np.hypot(d[0], d[1]))

  jump_main = mag(s['main'][4][:, 0] - s['main'][3][:, 0])
  step_typ = np.median([mag(s['main'][z][:, 0] - s['main'][z - 1][:, 0])
                        for z in (2, 3, 6, 7)])
  jump_blend = mag(at(4) - at(3))
  assert jump_main > 3 * step_typ, (jump_main, step_typ)
  assert jump_blend < 2 * step_typ, (jump_blend, step_typ)

  n, patch = s['n'], s['patch']
  ibox = TBox(start=(0, 0, 0), size=(n, n, 1))

  def render(z, m):
    return warp.warp_subvolume(
        s['sections'][z][np.newaxis, np.newaxis], ibox, inv(m), gbox,
        stride, ibox, interpolation='lanczos', device='cpu')[0, 0]

  def embed(m2d):
    fullm = np.full((2, 1, grid_n, grid_n), np.nan, np.float32)
    fullm[:, 0, c_off:c_off + m2d.shape[1], c_off:c_off + m2d.shape[2]] = m2d
    return fullm

  interior = np.s_[patch:-patch, patch:-patch]
  zeros_m = np.zeros((2, 1, grid_n, grid_n), np.float32)
  naive = np.abs(render(3, s['main'][3]) - render(4, zeros_m))
  blended = np.abs(render(3, embed(at(3))) - render(4, embed(at(4))))
  assert blended[interior].mean() < 0.6 * naive[interior].mean(), (
      blended[interior].mean(), naive[interior].mean())
