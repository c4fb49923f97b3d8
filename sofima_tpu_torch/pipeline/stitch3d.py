"""Device-resident 3d tile stitching (LICONN): flow -> joint solve -> render.

Twin of sofima_tpu/pipeline/stitch3d.py, on PyTorch and CUDA. The tiles
stay on their device through the three phases:

  1. FLOW    per-pair 3d overlap flow (stitch_elastic.compute_flow_map3d,
             circular strip path; torch.fft for the correlation)
  2. SOLVE   joint 26-neighbour elastic solve of all tile meshes
             (mesh.relax_mesh with mesh.elastic_mesh_3d, kernel K9 on
             CUDA, and the batched target meshes of
             stitch_elastic.TargetMeshPlan as `prev_fn`)
  3. RENDER  per tile: 3d map inversion (fixed point + Newton) and
             harmonic fill, trilinear render of the tile through it
             (ops.cuda_warp.shift_warp_3d, kernel K13), blend weights in
             closed form at the source coordinates, and distance-weighted
             accumulation into one canvas.

Only the solver's per-chunk statistics and the per-tile mean offsets
cross to the host. Channel orders are the reference's: meshes and maps
are xyz channels, render coordinates zyx, strides zyx.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import mesh
from sofima_tpu_torch import placement
from sofima_tpu_torch import stitch_elastic
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import fill as fill_ops
from sofima_tpu_torch.pipeline.stack_align import _PhaseClock
from sofima_tpu_torch.warp import _densify_box_3d

TileXY = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Stitch3dConfig:
  """Static configuration of the 3d stitch chain.

  Same fields and defaults as sofima_tpu's Stitch3dConfig.
  """
  stride: tuple[int, int, int] = (16, 16, 16)
  patch_size: tuple[int, int, int] = (32, 32, 32)
  flow_batch: int = 64
  flow_mode: str = 'circular'
  # Blend margin (px removed at interior tile edges before the distance
  # transform).
  margin: int = 8
  # Render halo beyond the nominal tile extent, in mesh nodes.
  pad_nodes: int = 2
  # Map-inversion iterations (stitch meshes are smooth).
  invert_fp_iters: int = 16
  invert_newton_iters: int = 4
  # Joint elastic solve.
  mesh_cfg: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(16.0, 16.0, 16.0),
          num_iters=400, max_iters=10000, stop_v_max=0.005, dt_max=100.0))


def _render_tile_3d(tile: torch.Tensor, edges, resid_rel: torch.Tensor,
                    stride, pad_nodes: int, bounds_px, fp_iters: int,
                    newton_iters: int):
  """Warps ONE tile and its blend weights by its solved mesh.

  Args:
    tile: [tz, ty, tx] tile image (float32)
    edges: (y_lo, y_hi, x_lo, x_hi) blend-weight anchors: the weight at
      source position (sy, sx) is max(min(sy - y_lo, y_hi - sy,
      sx - x_lo, x_hi - sx), 0), the closed form of the 2d distance
      transform of the rectangular margin mask
    resid_rel: [3 (x, y, z), gz, gy, gx] relative solved mesh minus the
      tile's integer mean offset (the mean is applied at paste time)
    stride: mesh node spacing (sz, sy, sx)
    pad_nodes: output halo beyond the tile extent, in nodes
    bounds_px: static per-axis (z, y, x) bounds on the residual
      displacement (px)
    fp_iters/newton_iters: map inversion iterations

  Returns:
    (warped [oz, oy, ox], warped_dts [oz, oy, ox]) where o* = tile
    extent + 2 * pad_nodes * stride; output voxel (0, 0, 0) sits at tile
    voxel (-pad, -pad, -pad).
  """
  sz, sy, sx = (int(s) for s in stride)
  gz, gy, gx = resid_rel.shape[-3:]
  p = int(pad_nodes)
  oz_n, oy_n, ox_n = gz + 2 * p, gy + 2 * p, gx + 2 * p
  dev = resid_rel.device

  def ar(n, shift=0):
    return torch.arange(n, dtype=torch.float32, device=dev) - shift

  # Forward absolute map on the source node grid (tile-local px, xyz).
  fwd_abs = torch.stack([
      resid_rel[0] + (ar(gx) * sx)[None, None, :],
      resid_rel[1] + (ar(gy) * sy)[None, :, None],
      resid_rel[2] + (ar(gz) * sz)[:, None, None]])
  # Query grid: the expanded output nodes, tile-local px (xyz).
  shape_n = (oz_n, oy_n, ox_n)
  query = torch.stack([
      (ar(ox_n, p) * sx)[None, None, :].expand(shape_n),
      (ar(oy_n, p) * sy)[None, :, None].expand(shape_n),
      (ar(oz_n, p) * sz)[:, None, None].expand(shape_n)])
  inv_abs = map_utils._invert_section(
      fwd_abs, (0.0, 0.0, 0.0), query, (float(sz), float(sy), float(sx)),
      num_iters=fp_iters, newton_iters=newton_iters)
  rel_inv = inv_abs - query
  valid = torch.isfinite(rel_inv).all(dim=0)
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True, dim=3)
  inv_abs = rel_inv + query

  # Per-voxel sampling coords (tile-local px, zyx). Output voxel v sits
  # at expanded-node index v / stride.
  out_shape = (oz_n * sz, oy_n * sy, ox_n * sx)
  src_zyx = torch.stack([inv_abs[2], inv_abs[1], inv_abs[0]])
  dense = _densify_box_3d(src_zyx, (0, 0, 0), (1.0 / sz, 1.0 / sy, 1.0 / sx),
                          (0, 0, 0), out_shape)
  bz, by, bx = (int(b) for b in bounds_px)
  warped = cuda_warp.shift_warp_3d(tile, dense, 'linear', -bz, bz, -by, by,
                                   -bx, bx, -p * sz, -p * sy, -p * sx)

  # Analytic blend weights at the source coords, zeroed where the sample
  # falls outside the tile volume.
  src_z, src_y, src_x = dense[0], dense[1], dense[2]
  tz, tyy, txx = tile.shape
  y_lo, y_hi, x_lo, x_hi = edges
  wdts = torch.minimum(torch.minimum(src_y - y_lo, y_hi - src_y),
                       torch.minimum(src_x - x_lo, x_hi - src_x))
  inside = ((src_z > -1.0) & (src_z < tz) & (src_y > -1.0) & (src_y < tyy)
            & (src_x > -1.0) & (src_x < txx))
  warped_dts = torch.where(inside, torch.clamp(wdts, min=0.0),
                           torch.zeros_like(wdts))
  return warped, warped_dts


def _paste_blend(img_acc, w_acc, warped, warped_dts, z0, y0, x0):
  """Distance-weighted accumulation into the canvas (in place)."""
  oz, oy, ox = warped.shape
  sel = (slice(z0, z0 + oz), slice(y0, y0 + oy), slice(x0, x0 + ox))
  img_acc[sel] += warped * warped_dts
  w_acc[sel] += warped_dts


def _bucket(v, b) -> int:
  return int(-(-(float(v) + 2.0) // b) * b)


def render_stitched_3d(tiles: dict, solved: torch.Tensor,
                       key_to_idx: dict, cfg: Stitch3dConfig | None = None,
                       yx_shape: tuple[int, int] | None = None):
  """Blended render of the stitched volume.

  The solved meshes are split into a per-tile integer mean offset (the
  paste position) and a residual deformation (the render), so the
  render's displacement bounds stay small and shared across tiles.

  Args:
    tiles: (x, y) -> [tz, ty, tx] tensors
    solved: [3 (x, y, z), n, gz, gy, gx] solved meshes (on the tiles'
      device; per-tile statistics are reduced there and fetched as one
      small vector)
    key_to_idx: (x, y) -> mesh index
    cfg: chain configuration
    yx_shape: tile grid shape (inferred from keys if omitted)

  Returns:
    (canvas [Z, Y, X], weight sum [Z, Y, X]): the distance-weight
    normalized canvas, 0 where no tile contributed, covering
    [0, tz) x [0, ty*ny) x [0, tx*nx) in nominal tile coordinates.
  """
  cfg = cfg or Stitch3dConfig()
  any_tile = next(iter(tiles.values()))
  tz, ty, tx = (int(s) for s in any_tile.shape)
  dev = any_tile.device
  if yx_shape is None:
    yx_shape = (max(y for _, y in tiles) + 1, max(x for x, _ in tiles) + 1)
  sz, sy, sx = cfg.stride

  solved = solved.to(dev, torch.float32)
  n_m = solved.shape[1]
  flat = solved.reshape(3, n_m, -1)
  means_d = torch.round(torch.nan_to_num(torch.nanmean(flat, dim=-1)))
  resid_d = torch.abs(flat - means_d[..., None])
  resid_max_d = torch.where(torch.isnan(resid_d), torch.zeros_like(resid_d),
                            resid_d).amax(dim=(1, 2))
  stats = torch.cat([means_d.reshape(-1), resid_max_d]).cpu().numpy()
  means = stats[:-3].reshape(3, n_m)
  max_resid_xyz = stats[-3:]
  offs, resids = {}, {}
  for key, i in key_to_idx.items():
    if key not in tiles:
      continue
    off = means[:, i].astype(int)
    offs[key] = off
    resids[key] = solved[:, i] - torch.as_tensor(
        off, dtype=torch.float32, device=dev)[:, None, None, None]

  # Static per-axis displacement bounds: residual + 1 px inversion
  # slack, bucketed (z to 2, y/x to 4) as the reference does.
  bounds_px = (_bucket(max_resid_xyz[2], 2), _bucket(max_resid_xyz[1], 4),
               _bucket(max_resid_xyz[0], 4))
  pad_nodes = max(cfg.pad_nodes, -(-max(bounds_px) // min(sz, sy, sx)) + 1)
  pad_z, pad_y, pad_x = pad_nodes * sz, pad_nodes * sy, pad_nodes * sx
  max_off = max(int(np.abs(o).max()) for o in offs.values())
  pc = -(-(max_off + max(pad_z, pad_y, pad_x) + 8) // 64) * 64
  canvas_shape = (tz + 2 * pc, ty * yx_shape[0] + 2 * pc,
                  tx * yx_shape[1] + 2 * pc)
  img_acc = torch.zeros(canvas_shape, dtype=torch.float32, device=dev)
  w_acc = torch.zeros(canvas_shape, dtype=torch.float32, device=dev)

  def blend_edges(txi, tyi):
    # The 2d EDT of the rectangular margin mask (margin trimmed at
    # interior edges, 1 px at grid-boundary edges) is min(axis
    # distances to the mask edges) inside it.
    if cfg.margin > 0:
      x_lo = (cfg.margin if txi > 0 else 0) - 1.0
      x_hi = float(tx - (cfg.margin if txi < yx_shape[1] - 1 else 1))
      y_lo = (cfg.margin if tyi > 0 else 0) - 1.0
      y_hi = float(ty - (cfg.margin if tyi < yx_shape[0] - 1 else 1))
    else:
      x_lo, x_hi, y_lo, y_hi = -1.0, float(tx), -1.0, float(ty)
    return (y_lo, y_hi, x_lo, x_hi)

  for key in key_to_idx:
    tile = tiles.get(key)
    if tile is None:
      continue
    warped, warped_dts = _render_tile_3d(
        tile.to(torch.float32), blend_edges(key[0], key[1]), resids[key],
        (sz, sy, sx), pad_nodes, bounds_px, cfg.invert_fp_iters,
        cfg.invert_newton_iters)
    z0 = int(offs[key][2]) - pad_z + pc
    y0 = ty * key[1] + int(offs[key][1]) - pad_y + pc
    x0 = tx * key[0] + int(offs[key][0]) - pad_x + pc
    if (min(z0, y0, x0) < 0 or z0 + warped.shape[0] > canvas_shape[0]
        or y0 + warped.shape[1] > canvas_shape[1]
        or x0 + warped.shape[2] > canvas_shape[2]):
      raise ValueError(f'tile {key} paste box out of canvas: {offs[key]}')
    _paste_blend(img_acc, w_acc, warped, warped_dts, z0, y0, x0)
    del warped, warped_dts

  sl = (slice(pc, pc + tz), slice(pc, pc + ty * yx_shape[0]),
        slice(pc, pc + tx * yx_shape[1]))
  img_acc, w_acc = img_acc[sl], w_acc[sl]
  canvas = torch.where(w_acc > 0, img_acc / torch.clamp(w_acc, min=1e-20),
                       torch.zeros_like(img_acc))
  return canvas, w_acc


class _TileView:
  """[1, z, y, x] array-like over a tile tensor, as compute_flow_map3d
  expects; slices stay on the tensor's device."""

  def __init__(self, t: torch.Tensor):
    self._t = t
    self.shape = (1,) + tuple(int(s) for s in t.shape)

  def __getitem__(self, sel):
    return self._t[None][sel]


def stitch_and_render_3d(tiles: dict, offset_x: np.ndarray,
                         offset_y: np.ndarray, coarse: np.ndarray,
                         cfg: Stitch3dConfig | None = None,
                         device_tiles: dict | None = None, device=None,
                         timings: dict | None = None):
  """End-to-end 3d stitch: fine flow -> joint solve -> blended render.

  Args:
    tiles: (x, y) -> [tz, ty, tx] tiles: host (numpy) arrays go to
      `device` (default: the CUDA card; without one, pass device='cpu'),
      tensors stay where they are
    offset_x/offset_y: [3, 1, ny, nx] coarse XYZ offsets between x- and
      y-adjacent tiles (NaN for absent pairs; stitch_rigid conventions)
    coarse: [3, 1, ny, nx] per-tile coarse positions
    cfg: chain configuration
    device_tiles: optional (x, y) -> [tz, ty, tx] device copies of the
      tiles (as in the reference), used in place of an upload; `tiles`
      then gives only the keys
    device: where host tiles go
    timings: if a dict, it receives the wall seconds of the phases
      'flow', 'solve' and 'render' (synchronizing at each phase end)

  Returns a dict: canvas and weight sum ([Z, Y, X] tensors), solved
  meshes ([3, n, gz, gy, gx]), key_to_idx, solve step count.
  """
  cfg = cfg or Stitch3dConfig()
  src = tiles if device_tiles is None else {k: device_tiles[k] for k in tiles}
  tiles = {k: placement.place(t, device, torch.float32)
           for k, t in src.items()}
  any_tile = next(iter(tiles.values()))
  tz, ty, tx = (int(s) for s in any_tile.shape)
  dev = any_tile.device
  clock = _PhaseClock(timings, dev)
  yx_shape = (offset_x.shape[-2], offset_x.shape[-1])
  offset_x = np.asarray(offset_x)
  offset_y = np.asarray(offset_y)

  views = {k: _TileView(t) for k, t in tiles.items()}
  flows_x, off_x = stitch_elastic.compute_flow_map3d(
      views, tile_shape=(tx, ty, tz), offset_map=offset_x, axis=0,
      patch_size=cfg.patch_size, stride=cfg.stride,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  flows_y, off_y = stitch_elastic.compute_flow_map3d(
      views, tile_shape=(tx, ty, tz), offset_map=offset_y, axis=1,
      patch_size=cfg.patch_size, stride=cfg.stride,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  clock.mark('flow')

  fx, fy, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
      (offset_x[:, 0], flows_x, off_x), (offset_y[:, 0], flows_y, off_y),
      list(tiles.keys()), np.asarray(coarse)[:, 0], cfg.stride,
      tile_shape=(tz, ty, tx))
  x0 = torch.from_numpy(x0).to(dev)
  prev_fn = stitch_elastic.TargetMeshPlan(nbors, fx.to(dev), fy.to(dev),
                                          cfg.stride, x0.shape[-3:])
  solved, _, steps = mesh.relax_mesh(x0, None, cfg.mesh_cfg, prev_fn=prev_fn,
                                     mesh_force=mesh.elastic_mesh_3d)
  clock.mark('solve')

  canvas, w_acc = render_stitched_3d(tiles, solved, key_to_idx, cfg,
                                     yx_shape=yx_shape)
  clock.mark('render')
  return dict(canvas=canvas, weights=w_acc, solved=solved,
              key_to_idx=key_to_idx, solve_steps=int(steps))
