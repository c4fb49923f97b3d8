"""Device-resident 2d tile montage: coarse -> place -> fine -> solve -> render.

Twin of sofima_tpu/pipeline/montage.py, on PyTorch and CUDA. The tiles
stay on their device through the five stages:

  1. COARSE  batched full-strip masked xcorr over all tile pairs
             (stitch_rigid.compute_coarse_offsets_batched; torch.fft),
             one small peak-row fetch per overlap width and axis
  2. PLACE   stitch_rigid.optimize_coarse_mesh (one node per tile)
  3. FINE    per-pair overlap flow on device-sliced strips
             (stitch_elastic.compute_flow_map; kernel K1)
  4. SOLVE   joint elastic solve of all tile meshes (mesh.relax_mesh,
             whose in-plane force is kernel K8 on the card, with the
             batched targets of stitch_elastic.TargetMeshPlan as
             `prev_fn`)
  5. RENDER  per tile: map inversion (fixed point + Newton) with the
             shift-bound sampling contract, harmonic fill, dense
             coordinates and the Lanczos render (ops.cuda_warp; kernel
             K4), pasted into one canvas (`render_tiles_device`).

The render keeps the reference's static envelope check as its
`overflow` flag: the gather reaches every tap, so it equals the TPU
render wherever that flag is False. The per-tile mean offsets and the
solver's chunk statistics are the only values read back during a run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import mesh
from sofima_tpu_torch import placement
from sofima_tpu_torch import stitch_elastic
from sofima_tpu_torch import stitch_rigid
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import fill as fill_ops
from sofima_tpu_torch.ops import interp as interp_ops
from sofima_tpu_torch.ops import shift_warp
from sofima_tpu_torch.pipeline.stack_align import _PhaseClock

TileXY = tuple[int, int]


@dataclasses.dataclass(frozen=True)
class MontageConfig:
  """Static configuration of the 2d montage chain.

  Same fields and defaults as sofima_tpu's MontageConfig. Every
  circular `flow_mode` correlates in float32 (K1 takes each overlap
  strip in one launch), and 'padfield' runs the calculator's padfield
  mode in batches of `flow_batch` (stitch_elastic.compute_flow_map).
  """
  stride: int = 40
  patch_size: int = 160
  # Coarse whole-overlap search grid (stitch_rigid contract).
  coarse_overlaps: tuple[int, ...] = (360, 440)
  min_range: tuple[float, ...] = (10, 100, 0)
  min_overlap: int = 200
  filter_size: int = 10
  flow_mode: str = 'circular_dft_bf16'
  flow_batch: int = 256
  # Render.
  margin: int = 16
  method: str = 'lanczos'
  # Residual shift-lattice envelope around each render tile's integer
  # base (px), for the `overflow` check.
  residual: int = 8
  invert_fp_iters: int = 16
  invert_newton_iters: int = 4
  # Render halo beyond the nominal tile extent, in mesh nodes; bumped in
  # buckets of 4 nodes to cover the solved residual deformation.
  pad_nodes: int = 8
  mesh_cfg: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
          num_iters=1000, max_iters=20000, stop_v_max=0.005,
          dt_max=100.0))


def _render_tile_device(tile: torch.Tensor, resid_rel: torch.Tensor,
                        stride: int, margin: int, pad_nodes: int,
                        bound_nodes: int, residual: int, method: str,
                        fp_iters: int, newton_iters: int):
  """Warps ONE tile by its (mean-removed) solved mesh.

  Args:
    tile: [ty, tx] tile image (float32)
    resid_rel: [2 (x, y), gy, gx] relative solved mesh minus the tile's
      integer mean offset (the mean is applied at paste time)
    stride: mesh node spacing
    margin: tile-edge pixels excluded from rendering
    pad_nodes: output halo beyond the tile extent, in nodes
    bound_nodes: bound on |resid_rel| in nodes (inversion shift bound and
      render base envelope)
    residual: render residual envelope around per-tile bases (px)
    method: interpolation kernel
    fp_iters/newton_iters: map inversion iterations

  Returns:
    (warped [oy, ox] float32, mask [oy, ox] bool, overflow bool tensor)
    where oy/ox = tile extent + 2 * pad_nodes * stride; output pixel
    (0, 0) sits at tile pixel (-pad, -pad).
  """
  s = int(stride)
  ty, tx = tile.shape
  gy, gx = resid_rel.shape[-2:]
  p = int(pad_nodes)
  oy_n, ox_n = gy + 2 * p, gx + 2 * p
  dev = resid_rel.device

  def ar(n, shift=0):
    return (torch.arange(n, dtype=torch.float32, device=dev) - shift) * s

  # Forward absolute map on the source node grid (tile-local px).
  fwd_abs = torch.stack([resid_rel[0] + ar(gx)[None, :],
                         resid_rel[1] + ar(gy)[:, None]])
  # Query grid: the expanded output nodes, tile-local px.
  query = torch.stack([ar(ox_n, p)[None, :].expand(oy_n, ox_n),
                       ar(oy_n, p)[:, None].expand(oy_n, ox_n)])
  inv_abs = map_utils._invert_section(
      fwd_abs, (0.0, 0.0), query, (float(s), float(s)), num_iters=fp_iters,
      newton_iters=newton_iters, shift_bound=bound_nodes + 1,
      shift_origin=(-p, -p))
  rel_inv = inv_abs - query
  valid = torch.isfinite(rel_inv[0]) & torch.isfinite(rel_inv[1])
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True)
  inv_abs = rel_inv + query

  # Per-pixel sampling coordinates (tile-local px, (y, x)).
  out_shape = (oy_n * s, ox_n * s)
  dense = interp_ops.upsample_map_linear(
      torch.stack([inv_abs[1], inv_abs[0]]), s, (0, 0), out_shape)

  # The reference's static render envelope (output positions are
  # tile-local + pad), kept as the `overflow` flag.
  node_out = np.arange(max(oy_n, ox_n), dtype=np.float64) * s
  bb = bound_nodes * s + s
  plan = shift_warp.tiled_plan_device(
      rel_inv[1][None], rel_inv[0][None], node_out[:oy_n], node_out[:ox_n],
      out_shape, (-residual, residual, -residual, residual),
      (-bb, bb, -bb, bb))

  # K4 samples the tile at the dense (tile-local) positions themselves:
  # the reference's origin (-pad, -pad) only re-bases its shift lattice.
  warped = cuda_warp.shift_warp(tile.to(torch.float32)[None].contiguous(),
                                dense[None].contiguous(), method)[0]

  # Analytic margin mask on the sampling positions.
  in_y = (dense[0] >= margin) & (dense[0] <= ty - 2 - margin)
  in_x = (dense[1] >= margin) & (dense[1] <= tx - 2 - margin)
  return warped, in_y & in_x, plan['overflow']


def _paste(canvas: torch.Tensor, cmask: torch.Tensor, warped: torch.Tensor,
           wmask: torch.Tensor, y0: int, x0: int) -> None:
  """Pastes one warped tile in place, with the reference's overwrite
  rule (warp.render_tiles: mask |= wmask; img[wmask & warped > 0] =
  warped)."""
  h, w = warped.shape
  cur = canvas[y0:y0 + h, x0:x0 + w]
  cur.copy_(torch.where(wmask & (warped > 0), warped, cur))
  cmask[y0:y0 + h, x0:x0 + w] |= wmask


def render_tiles_device(tiles: dict, coord_maps: dict, stride: int = 20,
                        margin: int = 50, cfg: MontageConfig | None = None,
                        width: int | None = None, height: int | None = None):
  """Renders the tiles through their solved meshes into one canvas.

  The solved maps ([2, 1, gy, gx] per tile, tensors or host arrays) are
  split into a per-tile integer mean offset, applied as the paste
  position, and a residual deformation, rendered per tile. Tensor maps
  are reduced on their device and fetched as one small vector. The
  inversion's shift bound and the render pad come from the largest
  residual, in buckets of 4 nodes, as in the reference.

  Returns:
    (canvas [height, width] float32, mask [height, width] bool,
     overflow: bool tensor, True if any tile left its static envelope)
    on the tiles' device.
  """
  cfg = cfg or MontageConfig()
  any_tile = next(iter(tiles.values()))
  ty, tx = int(any_tile.shape[0]), int(any_tile.shape[1])
  dev = any_tile.device
  if width is None or height is None:
    max_x = max(x for x, _ in tiles)
    max_y = max(y for _, y in tiles)
    height, width = ty * (max_y + 1), tx * (max_x + 1)
  s = int(stride)

  offs, resids = {}, {}
  keys = list(coord_maps.keys())
  if keys and isinstance(coord_maps[keys[0]], torch.Tensor):
    stacked = torch.stack([coord_maps[k][:, 0].to(dev, torch.float32)
                           for k in keys], dim=1)
    flat = stacked.reshape(2, len(keys), -1)
    means_d = torch.round(torch.nan_to_num(torch.nanmean(flat, dim=-1)))
    resid_d = torch.abs(flat - means_d[..., None])
    rmax_d = torch.where(torch.isnan(resid_d), torch.zeros_like(resid_d),
                         resid_d).amax()
    stats = torch.cat([means_d.reshape(-1), rmax_d[None]]).cpu().numpy()
    means = stats[:-1].reshape(2, len(keys))
    max_resid = float(stats[-1])
    for j, key in enumerate(keys):
      off = means[:, j].astype(int)
      offs[key] = off
      resids[key] = stacked[:, j] - torch.as_tensor(
          off, dtype=torch.float32, device=dev)[:, None, None]
  else:
    max_resid = 0.0
    for key, cmap in coord_maps.items():
      m = np.asarray(cmap)[:, 0]  # [2, gy, gx]
      off = np.round([np.nanmean(m[0]), np.nanmean(m[1])]).astype(int)
      offs[key] = off
      r = m - off[:, None, None]
      resids[key] = torch.as_tensor(r, dtype=torch.float32, device=dev)
      if np.isfinite(r).any():
        max_resid = max(max_resid, float(np.nanmax(np.abs(r))))

  bound_nodes = int(-(-(max_resid + 2.0) // s)) + 1
  bound_nodes = -(-bound_nodes // 4) * 4
  pad_nodes = max(cfg.pad_nodes, bound_nodes)
  pad_px = pad_nodes * s

  # Canvas with a halo covering the paste offsets and the render pad.
  pc = int(-(-(max(abs(o).max() for o in offs.values()) + pad_px + s)
             // 256) * 256) if offs else pad_px
  canvas = torch.zeros((height + 2 * pc, width + 2 * pc),
                       dtype=torch.float32, device=dev)
  cmask = torch.zeros(canvas.shape, dtype=torch.bool, device=dev)

  overflow = torch.zeros((), dtype=torch.bool, device=dev)
  for key in coord_maps:
    tile = tiles.get(key)
    if tile is None:
      continue
    warped, wmask, ovf = _render_tile_device(
        tile, resids[key], s, int(margin), pad_nodes, bound_nodes,
        cfg.residual, cfg.method, cfg.invert_fp_iters,
        cfg.invert_newton_iters)
    y0 = ty * key[1] + int(offs[key][1]) - pad_px + pc
    x0 = tx * key[0] + int(offs[key][0]) - pad_px + pc
    if y0 < 0 or x0 < 0 or (y0 + warped.shape[0] > canvas.shape[0]
                            or x0 + warped.shape[1] > canvas.shape[1]):
      raise ValueError(
          f'tile {key} paste box out of canvas; offset {offs[key]}')
    _paste(canvas, cmask, warped, wmask, y0, x0)
    overflow = overflow | ovf
    del warped, wmask

  return (canvas[pc:pc + height, pc:pc + width],
          cmask[pc:pc + height, pc:pc + width], overflow)


def montage_align_2d(tiles: dict, yx_shape: tuple[int, int],
                     cfg: MontageConfig | None = None, device=None,
                     timings: dict | None = None):
  """End-to-end 2d montage: coarse -> place -> fine -> solve -> render.

  Args:
    tiles: (x, y) -> [ty, tx] tiles; host (numpy) arrays go to `device`
      (default: the CUDA card; without one, pass device='cpu'), tensors
      stay where they are
    yx_shape: tile grid shape (rows, columns)
    cfg: chain configuration
    device: where host tiles go
    timings: if a dict, it receives the wall seconds of the stages
      'coarse', 'place', 'fine', 'solve' and 'render' (synchronizing the
      device at each stage end)

  Returns a dict: canvas and mask ([height, width] tensors), solved
  meshes ([2, n, gy, gx] tensor), key_to_idx, the coarse offsets cx / cy
  and tile positions `coarse` (numpy), the render `overflow` flag (bool
  tensor) and `solve_steps`.
  """
  cfg = cfg or MontageConfig()
  tiles = {k: placement.place(t, device, torch.float32)
           for k, t in tiles.items()}
  any_tile = next(iter(tiles.values()))
  dev = any_tile.device
  clock = _PhaseClock(timings, dev)
  s = cfg.stride
  stride_t = (s, s)
  tile_shape = (int(any_tile.shape[0]), int(any_tile.shape[1]))

  ov = tuple(cfg.coarse_overlaps)
  cx, cy = stitch_rigid.compute_coarse_offsets_batched(
      yx_shape, tiles, overlaps_xy=(ov, ov), min_range=cfg.min_range,
      min_overlap=cfg.min_overlap, filter_size=cfg.filter_size)
  cx = stitch_rigid.interpolate_missing_offsets(cx, axis=-1)
  cy = stitch_rigid.interpolate_missing_offsets(cy, axis=-2)
  clock.mark('coarse')
  coarse = stitch_rigid.optimize_coarse_mesh(cx, cy, device=dev)
  clock.mark('place')

  patch = (cfg.patch_size, cfg.patch_size)
  fine_x, off_x = stitch_elastic.compute_flow_map(
      tiles, cx[:, 0], axis=0, patch_size=patch, stride=stride_t,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  fine_y, off_y = stitch_elastic.compute_flow_map(
      tiles, cy[:, 0], axis=1, patch_size=patch, stride=stride_t,
      batch_size=cfg.flow_batch, flow_mode=cfg.flow_mode)
  clock.mark('fine')

  fx, fy, x0, nbors, key_to_idx = stitch_elastic.aggregate_arrays(
      (cx[:, 0], fine_x, off_x), (cy[:, 0], fine_y, off_y),
      list(tiles.keys()), coarse[:, 0], stride_t, tile_shape=tile_shape)
  x0 = torch.from_numpy(x0).to(dev)
  prev_fn = stitch_elastic.TargetMeshPlan(nbors, fx.to(dev), fy.to(dev),
                                          stride_t, x0.shape[-2:])
  solved, _, steps = mesh.relax_mesh(x0, None, cfg.mesh_cfg, prev_fn=prev_fn)
  clock.mark('solve')

  maps = {k: solved[:, i:i + 1] for k, i in key_to_idx.items()}
  canvas, cmask, overflow = render_tiles_device(
      tiles, maps, stride=s, margin=cfg.margin, cfg=cfg)
  clock.mark('render')
  return dict(canvas=canvas, mask=cmask, solved=solved,
              key_to_idx=key_to_idx, cx=cx, cy=cy, coarse=coarse,
              overflow=overflow, solve_steps=int(steps))
