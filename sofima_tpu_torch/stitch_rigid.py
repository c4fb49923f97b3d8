"""Rigid (coarse) 2d tile stitching.

Twin of sofima_tpu/stitch_rigid.py:
  1. a coarse XY offset for every pair of adjacent tiles from one
     full-strip masked cross-correlation per (overlap width, dynamic-range
     limit), with the reference's preference logic `_select_offset`:
       - sequentially, one probe at a time (`compute_coarse_offsets`,
         `_find_offset`, `_estimate_offset`: the calculator's padfield
         mode on one strip-sized patch, with external tile masks);
       - batched, all pairs of an axis at once
         (`compute_coarse_offsets_batched`, `_strip_peaks_batched`,
         flow_field.masked_xcorr on torch.fft); the strips stay on the
         tiles' device and only [limits, pairs, 4] peak rows per overlap
         width cross to the host;
  2. tile placement by relaxing a spring system with one node per tile
     (`optimize_coarse_mesh`, `elastic_tile_mesh` in 2d and
     `elastic_tile_mesh_3d` with a z coupling, mesh.relax_mesh).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import mesh
from sofima_tpu_torch import placement

TileXY = tuple[int, int]
MaskMap = Mapping[TileXY, Any]


def _overlap_crops(pre, post, overlap: int, axis: int):
  """Crops the facing `overlap`-wide strips of an adjacent tile pair."""
  if axis == 0:  # horizontal neighbours: right edge of pre, left of post
    return pre[:, -overlap:], post[:, :overlap]
  return pre[-overlap:, :], post[:overlap, :]


def _select_offset(get_estimate, overlaps, min_range, min_overlap: int,
                   max_ortho_shift: int, axis: int):
  """Preference logic over (range_limit, overlap) estimates.

  Per range limit: a unique-peak estimate ends the search at once;
  otherwise two consecutive overlap estimates within 20 px of each other;
  otherwise the valid estimate with the best peak ratio. Returns
  [inf, inf] if nothing valid was found. `get_estimate(range_limit,
  overlap) -> ([x_off, y_off], |peak ratio|)`; the `overlap` subtraction
  along `axis` happens here.
  """

  def valid(off):
    return (abs(off[1 - axis]) < max_ortho_shift
            and abs(off[axis]) >= min_overlap)

  result = None
  for range_limit in min_range:
    estimates = []
    best_pr, best_idx = 0.0, -1
    for overlap in overlaps:
      offset, pr = get_estimate(range_limit, overlap)
      offset = list(offset)
      offset[axis] -= overlap

      if pr == 0.0:  # single unambiguous peak
        return offset
      estimates.append(offset)
      if pr > best_pr and valid(offset):
        best_pr, best_idx = pr, len(estimates) - 1

    min_diff, min_idx = np.inf, 0
    for i, (off0, off1) in enumerate(zip(estimates, estimates[1:])):
      diff = abs(off1[axis] - off0[axis])
      if diff < min_diff and valid(off1):
        min_diff, min_idx = diff, i

    if min_diff < 20:  # two consistent consecutive estimates
      result = estimates[min_idx + 1]
      break
    if best_idx >= 0:
      result = estimates[best_idx]
      break

  if result is None or abs(result[axis]) < min_overlap:
    return [np.inf, np.inf]
  return result


def _local_range(img: torch.Tensor, filter_size: int) -> torch.Tensor:
  """Moving max - min over a filter_size^2 window of [b, y, x] images,
  with XLA's 'SAME' padding (the extra row / column on the high side)."""
  lo = (filter_size - 1) // 2
  pad = (lo, filter_size - 1 - lo, lo, filter_size - 1 - lo)

  def max_filter(v, fill):
    v = torch.nn.functional.pad(v, pad, value=fill)
    return torch.nn.functional.max_pool2d(v, filter_size, stride=1)

  return (max_filter(img, float('-inf'))
          + max_filter(-img, float('-inf')))  # hi - lo


def _dynamic_range_mask(img: torch.Tensor, range_limit: float,
                        filter_size: int) -> torch.Tensor:
  """True where the local max - min of a 2d image is below `range_limit`
  (`_local_range`'s 'SAME' window)."""
  return _local_range(img.to(torch.float32)[None], filter_size)[0] < (
      range_limit)


def _estimate_offset(a: torch.Tensor, b: torch.Tensor, range_limit: float,
                     filter_size: int = 10, masks=None):
  """Single global offset between overlap crops `a` (pre) and `b` (post).

  The flat-region masks (ORed with the caller's `masks`, True where
  invalid), then the calculator's padfield mode on one patch the size of
  the strip, on the crops' device. Returns ([x_offset, y_offset],
  |peak ratio|); the ratio is exactly 0.0 for a single peak.
  """
  a_f, b_f = a.to(torch.float32), b.to(torch.float32)
  a_mask = _dynamic_range_mask(a_f, range_limit, filter_size)
  b_mask = _dynamic_range_mask(b_f, range_limit, filter_size)
  if masks is not None:
    a_mask = a_mask | masks[0]
    b_mask = b_mask | masks[1]
  mfc = flow_field.JAXMaskedXCorrWithStatsCalculator(device=a.device)
  xo, yo, _, pr = mfc.flow_field(
      a_f, b_f, pre_mask=a_mask, post_mask=b_mask,
      patch_size=tuple(a.shape), step=(1, 1), batch_size=1).squeeze()
  return [xo, yo], abs(pr)


def _find_offset(pre: torch.Tensor, post: torch.Tensor, overlaps, min_range,
                 min_overlap: int, max_ortho_shift: int, axis: int,
                 filter_size: int, masks=None):
  """Searches overlap widths / range limits for a reliable offset.

  Sequential search: one `_estimate_offset` per (range_limit, overlap)
  probe, in `_select_offset`'s order and with its early exits. A tile
  mask that would blank a whole strip is dropped for that strip.
  """

  def get_estimate(range_limit, overlap):
    ov_masks = None
    if masks is not None:
      ma, mb = _overlap_crops(masks[0], masks[1], overlap, axis)
      ma = torch.zeros_like(ma) if bool(ma.all()) else ma
      mb = torch.zeros_like(mb) if bool(mb.all()) else mb
      ov_masks = (ma, mb)
    a, b = _overlap_crops(pre, post, overlap, axis)
    return _estimate_offset(a, b, range_limit, filter_size, ov_masks)

  return _select_offset(get_estimate, overlaps, min_range, min_overlap,
                        max_ortho_shift, axis)


def _strip_peaks_batched(pre_strips: torch.Tensor, post_strips: torch.Tensor,
                         range_limits, filter_size: int,
                         max_masked: float = 0.75) -> torch.Tensor:
  """Full-strip masked-xcorr peak stats for a batch of tile-pair strips.

  For each dynamic-range limit: the flat-region masks, deselection of
  strips whose mask occupancy reaches `max_masked`, then ONE batched
  masked NCC (per-item thresholds) and the peak extraction. The limits
  run one after another, bounding the memory to one limit's spectra.

  Args:
    pre_strips/post_strips: [b, sy, sx] facing overlap strips
    range_limits: dynamic-range thresholds
    filter_size: moving max-min window
    max_masked: occupancy deselection threshold

  Returns:
    [len(range_limits), b, 4] rows (x, y, sharpness, peak ratio), NaN rows
    for deselected strips.
  """
  pre_f = pre_strips.to(torch.float32)
  post_f = post_strips.to(torch.float32)
  range_pre = _local_range(pre_f, filter_size)
  range_post = _local_range(post_f, filter_size)
  center = tuple(int(n) - 1 for n in pre_strips.shape[-2:])

  def masked_mean(img, mask):
    s = torch.where(mask, torch.zeros_like(img), img).sum(
        dim=(-2, -1), keepdim=True)
    n = (~mask).to(torch.float32).sum(dim=(-2, -1), keepdim=True)
    return s / torch.clamp(n, min=1.0)

  rows = []
  for limit in range_limits:
    pre_mask = range_pre < limit
    post_mask = range_post < limit
    occ_pre = pre_mask.to(torch.float32).mean(dim=(-2, -1))
    occ_post = post_mask.to(torch.float32).mean(dim=(-2, -1))
    deselect = (occ_pre >= max_masked) | (occ_post >= max_masked)
    xc = flow_field.masked_xcorr(
        pre_f - masked_mean(pre_f, pre_mask),
        post_f - masked_mean(post_f, post_mask),
        pre_mask, post_mask, per_item=True)
    r = flow_field._batched_peaks(xc, center, 2, 0.5, 5)
    rows.append(torch.where(deselect[:, None], torch.full_like(r, np.nan), r))
    del xc
  return torch.stack(rows)


def compute_coarse_offsets_batched(
    yx_shape: tuple[int, int],
    tile_map: Mapping[TileXY, Any],
    overlaps_xy=((200, 300), (200, 300)),
    min_range=(10, 100, 0),
    min_overlap: int = 160,
    filter_size: int = 10,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
  """Coarse offset between every adjacent tile pair of a grid.

  Per axis and overlap width, the facing strips of every adjacent pair
  are stacked and correlated in one batch on the tiles' device (host
  tiles go to `device`, default the CUDA card); the shared
  `_select_offset` then picks each pair's offset on the host.

  Returns (conn_x, conn_y), each [2, 1, ys, xs]: the XY offset between
  tiles (x, y)->(x+1, y) / (x, y)->(x, y+1), the latter tile moving. inf
  marks failed estimates, NaN missing tiles.
  """
  tiles = {k: placement.place(v, device) for k, v in tile_map.items()}
  conns = []
  for axis in range(2):
    conn = np.full((2, 1, yx_shape[0], yx_shape[1]), np.nan)
    dx, dy = (1, 0) if axis == 0 else (0, 1)
    pairs = [((x, y), (x + dx, y + dy))
             for y in range(yx_shape[0] - dy)
             for x in range(yx_shape[1] - dx)
             if (x, y) in tiles and (x + dx, y + dy) in tiles]
    if not pairs:
      conns.append(conn)
      continue

    peaks = {}  # overlap -> [n_limits, n_pairs, 4] host array
    for overlap in overlaps_xy[axis]:
      crops = [_overlap_crops(tiles[a], tiles[b], overlap, axis)
               for a, b in pairs]
      pre_strips = torch.stack([c[0] for c in crops])
      post_strips = torch.stack([c[1] for c in crops])
      peaks[overlap] = _strip_peaks_batched(
          pre_strips, post_strips, tuple(min_range),
          filter_size).cpu().numpy()

    limit_idx = {rl: i for i, rl in enumerate(min_range)}
    for pair_i, ((x, y), _) in enumerate(pairs):

      def get_estimate(range_limit, overlap, pair_i=pair_i):
        row = peaks[overlap][limit_idx[range_limit], pair_i]
        return [row[0], row[1]], abs(row[3])

      conn[:, 0, y, x] = _select_offset(
          get_estimate, overlaps_xy[axis], min_range, min_overlap,
          max(overlaps_xy[1 - axis]), axis)
    conns.append(conn)

  return conns[0], conns[1]


def compute_coarse_offsets(
    yx_shape: tuple[int, int],
    tile_map: Mapping[TileXY, Any],
    overlaps_xy=((200, 300), (200, 300)),
    min_range=(10, 100, 0),
    min_overlap: int = 160,
    filter_size: int = 10,
    mask_map: MaskMap | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
  """Coarse offset between every adjacent tile pair of a grid.

  The sequential search: each pair's probes run one after another
  (`_find_offset`) on the tiles' device (host tiles go to `device`,
  default the CUDA card). `mask_map` gives tiles' invalid-pixel masks
  (True / nonzero = invalid), cropped to the widest overlap of the axis,
  each on its tile's device.

  Returns (conn_x, conn_y), each [2, 1, ys, xs]: the XY offset between
  tiles (x, y)->(x+1, y) / (x, y)->(x, y+1), the latter tile moving. inf
  marks failed estimates, NaN missing tiles.
  """
  tiles = {k: placement.place(v, device) for k, v in tile_map.items()}
  masks = None
  if mask_map is not None:  # each on its tile's device
    masks = {k: placement.place(v, tiles[k].device) != 0
             for k, v in mask_map.items() if k in tiles}

  def tile_masks(key_a, key_b, axis):
    if masks is None:
      return None
    width = max(overlaps_xy[axis])
    return _overlap_crops(masks[key_a], masks[key_b], width, axis)

  conn_x = np.full((2, 1, yx_shape[0], yx_shape[1]), np.nan)
  for x in range(yx_shape[1] - 1):
    for y in range(yx_shape[0]):
      if (x, y) not in tiles or (x + 1, y) not in tiles:
        continue
      conn_x[:, 0, y, x] = _find_offset(
          tiles[(x, y)], tiles[(x + 1, y)], overlaps_xy[0], min_range,
          min_overlap, max(overlaps_xy[1]), 0, filter_size,
          tile_masks((x, y), (x + 1, y), 0))

  conn_y = np.full((2, 1, yx_shape[0], yx_shape[1]), np.nan)
  for y in range(yx_shape[0] - 1):
    for x in range(yx_shape[1]):
      if (x, y) not in tiles or (x, y + 1) not in tiles:
        continue
      conn_y[:, 0, y, x] = _find_offset(
          tiles[(x, y)], tiles[(x, y + 1)], overlaps_xy[1], min_range,
          min_overlap, max(overlaps_xy[0]), 1, filter_size,
          tile_masks((x, y), (x, y + 1), 1))

  return conn_x, conn_y


def interpolate_missing_offsets(conn: np.ndarray, axis: int,
                                max_r: int = 4) -> np.ndarray:
  """Replaces inf offsets with the mean of nearest finite neighbours.

  Searches up to `max_r` steps along `axis` (-1 for x, -2 for y);
  modifies `conn` in place and returns it.
  """
  if conn.ndim != 4:
    raise ValueError('conn array must have rank 4')

  missing = np.isinf(conn[0, 0])
  for y, x in np.argwhere(missing):
    found = []
    for r in range(1, max_r):
      for sign in (-1, 1):
        pos = [0, 0, y, x]
        pos[axis] += sign * r
        if 0 <= pos[axis] < conn.shape[axis] and np.isfinite(
            conn[0, 0, pos[2], pos[3]]):
          found.append(conn[:, 0, pos[2], pos[3]])
      if found:
        break
    if found:
      conn[:, 0, y, x] = np.mean(found, axis=0)
  return conn


def _offset_springs(x: torch.Tensor, combos) -> torch.Tensor:
  """Sum of linear offset-matching spring forces.

  Each combo is (channel, grid_axis, target): the difference of channel
  `channel` between grid neighbours along `grid_axis` (-1: x, -2: y)
  should equal `target`. For a pair (i, i+1): f = diff - target acts as
  +f on node i and -f on node i+1.
  """
  total = torch.zeros_like(x)
  for channel, axis, target in combos:
    lo = [slice(None)] * (x.ndim - 1)
    hi = [slice(None)] * (x.ndim - 1)
    lo[axis], hi[axis] = slice(None, -1), slice(1, None)
    f = torch.nan_to_num(x[channel][tuple(hi)] - x[channel][tuple(lo)]
                         - target[tuple(lo)])
    p = 2 * (-axis - 1)  # this axis's (left, right) in pad order
    pad_lo = [0] * (2 * -axis)
    pad_hi = [0] * (2 * -axis)
    pad_lo[p + 1] = 1  # scatter +f onto node i
    pad_hi[p] = 1      # scatter -f onto node i+1
    total[channel] = (total[channel] + torch.nn.functional.pad(f, pad_lo)
                      - torch.nn.functional.pad(f, pad_hi))
  return total


def elastic_tile_mesh(x: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                      k=None, stride=None, prefer_orig_order=False,
                      links=None) -> torch.Tensor:
  """Force on a 2d tile grid pulling NN offsets toward (cx, cy).

  x: [2, z, y, x] tile node positions; cx/cy: [2, z, y, x] desired
  offsets between (x,y)->(x+1,y) / (x,y)->(x,y+1) tiles. The other
  arguments exist for the mesh-solver signature.
  """
  del k, stride, prefer_orig_order, links
  combos = [
      (0, -1, cx[0]),  # x spacing of horizontal neighbours
      (1, -2, cy[1]),  # y spacing of vertical neighbours
      (0, -2, cy[0]),  # x shear of vertical neighbours
      (1, -1, cx[1]),  # y shear of horizontal neighbours
  ]
  return _offset_springs(x, combos)


def elastic_tile_mesh_3d(x: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                         k=None, stride=None, prefer_orig_order=False,
                         links=None) -> torch.Tensor:
  """3d variant of `elastic_tile_mesh`: [3, z, y, x] nodes, XYZ offsets,
  with the z coordinates of horizontal and vertical neighbours coupled
  too."""
  del k, stride, prefer_orig_order, links
  combos = [
      (0, -1, cx[0]), (1, -2, cy[1]),
      (0, -2, cy[0]), (1, -1, cx[1]),
      (2, -1, cx[2]), (2, -2, cy[2]),  # z coupling
  ]
  return _offset_springs(x, combos)


def optimize_coarse_mesh(cx: np.ndarray, cy: np.ndarray,
                         cfg: mesh.IntegrationConfig | None = None,
                         mesh_fn=elastic_tile_mesh,
                         device=None) -> np.ndarray:
  """Relaxes the tile spring system on `device` (default: the CUDA card);
  returns per-tile position offsets (numpy float32)."""
  if cfg is None:
    cfg = mesh.IntegrationConfig(
        dt=0.001, gamma=0.0, k0=0.0, k=0.1, stride=(1, 1), num_iters=1000,
        max_iters=100000, stop_v_max=0.001, dt_max=100)

  # NaN targets (missing tiles) add no force: _offset_springs
  # nan_to_nums each spring. inf entries (failed estimates) must be
  # fixed with interpolate_missing_offsets before solving.
  cx_t = placement.place(np.asarray(cx, np.float32), device)
  cy_t = placement.place(np.asarray(cy, np.float32), device)

  def _force(x, *args, **kwargs):
    return mesh_fn(x, cx_t, cy_t, *args, **kwargs)

  x, _, _ = mesh.relax_mesh(torch.zeros_like(cx_t), None, cfg,
                            mesh_force=_force)
  return x.cpu().numpy()
