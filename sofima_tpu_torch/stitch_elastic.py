"""Elastic (fine) 2d and 3d tile stitching.

Twin of sofima_tpu/stitch_elastic.py. Every tile is a spring mesh; all
tile meshes are packed into one [2|3, N, (z,) y, x] array and relaxed
together, coupled through virtual springs whose targets come from
composing inter-tile flow fields with the neighbouring tiles' meshes.

Ported: `NeighborInfo`, `_relative_intersection`, `compute_flow_map`
(2d: the calculator's padfield mode, the default, or its circular
modes, kernel K1), `compute_flow_map3d` (its circular strip branch, the
padfield mode where the strips do not fit or when asked for, and tile
masks on both), `aggregate_arrays` (2d and 3d), and the target-mesh
machinery (`_window_edge_start`, the
reference's `_apply_flow` window rule, `compute_target_mesh`). The
reference evaluates the targets inside the solver as a vmap over tiles
of a scan over the neighbour rows, with `lax.cond` on the row values;
here the rows are a host table, so `TargetMeshPlan` resolves every
(tile, neighbour) window to Python ints once, before the solve, and
each solver step is then one batched 3d composition and a fixed short
sequence of slice pastes, with no host read. 2d meshes take the same
plan as z = 1 (the reference composes 2d as z = 1 too).
"""

from __future__ import annotations

import enum
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import map_utils
from sofima_tpu_torch import placement
from sofima_tpu_torch.utils.bounding_box import BoundingBox

TileXY = tuple[int, int]


class NeighborInfo(enum.IntEnum):
  """Indices into a tile-pair metadata row (the `nbors` table)."""

  nbor_idx = 0             # neighbouring tile index
  flow_idx = 1             # index into the flow array
  coarse_offset_ortho = 2  # offset orthogonal to the overlap dim (px)
  flow_size_ortho = 3      # flow grid size, orthogonal dim
  flow_size_overlap = 4    # flow grid size, overlap dim
  fine_off_x = 5           # XY offset used when computing the flow
  fine_off_y = 6
  dim = 7                  # 0: horizontal (x) neighbour, 1: vertical (y)
  coarse_offset_z = 8      # 3d only
  flow_size_z = 9
  fine_off_z = 10


def _relative_intersection(box1: BoundingBox, box2: BoundingBox):
  ibox = box1.intersection(box2)
  return (BoundingBox(start=ibox.start - box1.start, size=ibox.size),
          BoundingBox(start=ibox.start - box2.start, size=ibox.size))


def _overlap_flow(pre: torch.Tensor, post: torch.Tensor, pre_mask, post_mask,
                  patch_size, stride, batch_size: int,
                  circular: bool) -> torch.Tensor:
  """The flow between two overlap crops, as a tensor on their device:
  the circular dense branch (`circular`, which needs equal crops) or the
  calculator's padfield mode."""
  patch = tuple(int(p) for p in patch_size)
  step = tuple(int(v) for v in stride)
  if circular:
    return flow_field.dense_flow_field(
        pre.to(torch.float32), post.to(torch.float32), patch, step,
        batch_size=batch_size, circular=True, pre_mask=pre_mask,
        post_mask=post_mask)
  mfc = flow_field.JAXMaskedXCorrWithStatsCalculator(device=pre.device)
  return torch.from_numpy(mfc.flow_field(
      pre, post, patch, step, pre_mask=pre_mask, post_mask=post_mask,
      batch_size=batch_size)).to(pre.device)


def compute_flow_map(tile_map: Mapping[TileXY, Any], offset_map: np.ndarray,
                     axis: int, patch_size=(120, 120), stride=(20, 20),
                     batch_size: int = 256, flow_mode: str = 'padfield',
                     device=None):
  """Fine flow between adjacent 2d tiles along `axis` (0: x, 1: y).

  For each valid tile pair, crops stride-aligned overlap strips (shifted
  by the rounded orthogonal offset) from both tiles and estimates the
  patch flow between them: with 'padfield' (the default), the
  calculator's padfield mode in dispatch batches of `batch_size`; with
  a circular mode, its dense branch (kernel K1 on the card, one launch
  per strip; every circular mode correlates in float32,
  `flow_field.check_flow_mode`). Tiles may be tensors (the strips are
  sliced on their device) or host arrays (they go to `device`, default
  the CUDA card).

  Returns ({(x, y): [4, gy, gx] flow tensor padded with NaN to the tile
  mesh grid}, {(x, y): xy offset used for the crop}).
  """
  flow_field.check_flow_mode(flow_mode)
  yx_shape = offset_map.shape[-2:]
  flows, offsets = {}, {}
  pad_y = patch_size[0] // 2 // stride[0]
  pad_x = patch_size[1] // 2 // stride[1]

  for y in range(yx_shape[0] - axis):
    for x in range(yx_shape[1] - (1 - axis)):
      if np.isnan(offset_map[0, y, x]):
        continue

      pre = placement.place(tile_map[x, y], device, torch.float32)
      post = placement.place(tile_map[x + (1 - axis), y + axis], device,
                             torch.float32)
      offset = offset_map[:, y, x]  # (off_x, off_y)

      # Stride-align the overlap: shrink it so the crop start within the
      # 'pre' tile is a stride multiple.
      overlap = -int(offset[axis])
      overlap = pre.shape[1 - axis] - (
          (pre.shape[1 - axis] - overlap) // stride[1 - axis]
          * stride[1 - axis])
      rounded = np.asarray(stride)[::-1] * np.round(
          offset / np.asarray(stride)[::-1])
      ortho_offset = int(rounded[1 - axis])

      pre_sel = [slice(None), slice(None)]
      post_sel = [slice(None), slice(None)]
      pre_sel[1 - axis] = slice(-overlap, None)
      post_sel[1 - axis] = slice(None, overlap)
      if ortho_offset > 0:
        pre_sel[axis] = slice(ortho_offset, None)
        post_sel[axis] = slice(None, -ortho_offset)
      elif ortho_offset < 0:
        pre_sel[axis] = slice(None, ortho_offset)
        post_sel[axis] = slice(-ortho_offset, None)

      f = _overlap_flow(
          pre[tuple(pre_sel)].contiguous(), post[tuple(post_sel)].contiguous(),
          None, None, patch_size, stride, batch_size,
          flow_mode != 'padfield')
      flows[(x, y)] = torch.nn.functional.pad(
          f, (pad_x, pad_x - 1, pad_y, pad_y - 1), value=float('nan'))
      offsets[(x, y)] = ((-overlap, ortho_offset) if axis == 0
                         else (ortho_offset, -overlap))

  return flows, offsets


def compute_flow_map3d(tile_map: Mapping[TileXY, Any], tile_shape,
                       offset_map: np.ndarray, axis: int,
                       patch_size=(120, 120, 120), stride=(40, 40, 40),
                       batch_size: int = 16, flow_mode: str = 'circular',
                       mask_map=None, device=None):
  """Fine flow between adjacent 3d tiles along `axis` (0: x, 1: y).

  `tile_map` values are [1, z, y, x] array-likes (slices of tensors stay
  on their device; host slices go to `device`, default the CUDA card);
  `offset_map` is [3, 1, ys, xs] with coarse XYZ offsets; `tile_shape`
  is XYZ; `patch_size` and `stride` are ZYX. Crop starts are
  stride-aligned in every dimension. With `flow_mode='circular'` each
  overlap pair takes the 3d circular strip path; unequal crops, a stride
  that does not divide the patch, or any other mode take the
  calculator's padfield mode in batches of `batch_size`, as the
  reference falls back. `mask_map` maps tile coordinates to [1, z, y, x]
  invalid-voxel masks (nonzero = invalid), used on both branches.
  Returns flows ([5, gz, gy, gx] tensors, padded with NaN to the mesh
  grid) and the XYZ offsets at which the neighbouring tile was placed.
  """
  flows, offsets = {}, {}
  grid_yx = offset_map.shape[-2:]
  pad_zyx = np.array(patch_size) // 2 // np.asarray(stride)

  for y in range(grid_yx[0] - axis):
    for x in range(grid_yx[1] - (1 - axis)):
      nx, ny = x + (1 - axis), y + axis
      offset = offset_map[:, 0, y, x]  # xyz

      curr_box = BoundingBox(start=(0, 0, 0), size=tile_shape)
      nbor_box = BoundingBox(
          start=(tile_shape[0] * (1 - axis) + offset[0],
                 tile_shape[1] * axis + offset[1], offset[2]),
          size=tile_shape)
      isec_curr, isec_nbor = _relative_intersection(curr_box, nbor_box)

      s = stride[2 - axis]
      # Stride-align the overlap dimension...
      overlap = isec_curr.size[axis]
      within = tile_shape[axis] - overlap
      new_overlap = tile_shape[axis] - within // s * s
      shift = np.zeros(3)
      shift[axis] = -(new_overlap - overlap)
      # ...and the orthogonal crop starts.
      for ax in range(3):
        if ax == axis:
          continue
        if isec_curr.start[ax] > 0:
          shift[ax] = (s * np.round(isec_curr.start[ax] / s)
                       - isec_curr.start[ax])
        elif isec_nbor.start[ax] > 0:
          shift[ax] = -(s * np.round(isec_nbor.start[ax] / s)
                        - isec_nbor.start[ax])

      nbor_box = nbor_box.translate(shift)
      isec_curr, isec_nbor = _relative_intersection(curr_box, nbor_box)
      assert np.all(isec_curr.start % s == 0)
      assert np.all(isec_nbor.start % s == 0)

      final = np.array(nbor_box.start - curr_box.start)
      final[axis] = -isec_curr.size[axis]
      offsets[(x, y)] = tuple(int(v) for v in final)

      def take(view, box, like=None):
        t = view[box.to_slice4d()][0]
        return placement.place(t, device if like is None else like.device)

      pre = take(tile_map[(x, y)], isec_curr)
      post = take(tile_map[(nx, ny)], isec_nbor, pre)
      pre_mask = post_mask = None
      if mask_map is not None:
        if (x, y) in mask_map:
          pre_mask = take(mask_map[(x, y)], isec_curr, pre)
        if (nx, ny) in mask_map:
          post_mask = take(mask_map[(nx, ny)], isec_nbor, pre)
      strips = (flow_mode == 'circular'
                and tuple(pre.shape) == tuple(post.shape)
                and all(p % st == 0 for p, st in zip(patch_size, stride)))
      f = _overlap_flow(pre, post, pre_mask, post_mask, patch_size, stride,
                        batch_size, strips)
      pad = []
      for p in pad_zyx[::-1]:  # torch pad order: x, y, z
        pad += [int(p), int(p) - 1]
      flows[(x, y)] = torch.nn.functional.pad(f, pad, value=float('nan'))
  return flows, offsets


def aggregate_arrays(x_data, y_data, tile_coords: Sequence[TileXY],
                     coarse_mesh: np.ndarray, stride, tile_shape):
  """Packs per-tile meshes, flows and neighbour metadata into flat arrays.

  Args:
    x_data: (coarse offsets cx [2|3, ny, nx], horizontal flows, crop
      offsets)
    y_data: same for vertical neighbours
    tile_coords: (x, y) coordinates of all tiles
    coarse_mesh: rigid-stitching solution (per-tile position offsets)
    stride: [Z]YX mesh/flow stride
    tile_shape: [Z]YX tile image shape

  Returns:
    (fx_all, fy_all, x_all, nbors, key_to_idx): the packed flows as
    float32 tensors on the flows' device (host flows, as clean_flow
    returns them, are packed on the host), the initial meshes as a
    numpy float32 array, the int `nbors` table (see NeighborInfo; 8
    columns in 2d, 11 in 3d) on the host.
  """
  cx, fine_x, offsets_x = x_data
  cy, fine_y, offsets_y = y_data
  assert cx.ndim == 3 and cy.ndim == 3
  fine_x = {k: torch.as_tensor(v) for k, v in fine_x.items()}
  fine_y = {k: torch.as_tensor(v) for k, v in fine_y.items()}
  key_to_idx = {tuple(k): i for i, k in enumerate(tile_coords)}
  dim = len(stride)
  n = len(key_to_idx)
  flows = list(fine_x.values()) + list(fine_y.values())
  dev = flows[0].device if flows else torch.device('cpu')

  def _pack(fine, shapes_floor):
    shape = np.max([tuple(v.shape) for v in fine.values()] + [shapes_floor],
                   axis=0)
    out = torch.full([dim, n] + shape[1:].tolist(), float('nan'),
                     dtype=torch.float32, device=dev)
    for k, i in key_to_idx.items():
      if k in fine:
        f = fine[k]
        out[(slice(None), i) + tuple(slice(0, v) for v in f.shape[1:])] = (
            f[:dim])
    return out

  floor = (dim,) + (1,) * dim
  fx_all = _pack(fine_x, floor)
  fy_all = _pack(fine_y, floor)

  def _nbor_row(key, flow_key, coarse, fine, offsets, axis):
    ortho, overlap = fine[flow_key].shape[-2:]
    if axis == 1:
      overlap, ortho = ortho, overlap
    off = offsets[flow_key]
    row = [key_to_idx[key], key_to_idx[flow_key],
           coarse[1] if axis == 0 else coarse[0], ortho, overlap, off[0],
           off[1], axis]
    if dim == 3:
      row += [coarse[2], fine[flow_key].shape[-3], off[2]]
    return row

  nbors = np.full((n, 4, 8 if dim == 2 else 11), -1, dtype=int)
  for tx, ty in tile_coords:
    i = key_to_idx[tx, ty]
    if (tx - 1, ty) in fine_x:  # left neighbour
      k = (tx - 1, ty)
      nbors[i, 0] = _nbor_row(k, k, cx[:, ty, tx - 1], fine_x, offsets_x, 0)
    if (tx, ty) in fine_x:      # right neighbour
      nbors[i, 1] = _nbor_row((tx + 1, ty), (tx, ty), cx[:, ty, tx],
                              fine_x, offsets_x, 0)
    if (tx, ty - 1) in fine_y:  # top neighbour
      k = (tx, ty - 1)
      nbors[i, 2] = _nbor_row(k, k, cy[:, ty - 1, tx], fine_y, offsets_y, 1)
    if (tx, ty) in fine_y:      # bottom neighbour
      nbors[i, 3] = _nbor_row((tx, ty + 1), (tx, ty), cy[:, ty, tx],
                              fine_y, offsets_y, 1)

  mesh_shape = (np.asarray(tile_shape) // np.asarray(stride)).tolist()
  x_all = np.zeros([dim, n] + mesh_shape, dtype=np.float32)
  for tx, ty in tile_coords:
    x_all[:, key_to_idx[tx, ty]] = coarse_mesh[:, ty, tx].reshape(
        (dim,) + (1,) * dim)
  return fx_all, fy_all, x_all, nbors, key_to_idx


def _window_edge_start(at_high_edge: bool, extent: int, window: int) -> int:
  """Start index of a window abutting one edge of an axis: index 0 at
  the low edge, or flush against the high edge (`extent - window`)."""
  return extent - window if at_high_edge else 0


def _windows(row, mult: int, mesh_shape):
  """(neighbour window start, own window start), both (z, y, x) ints, of
  one neighbour row; see the reference's `_apply_flow` for the rule."""
  axis = int(row[NeighborInfo.dim])
  overlap = int(row[NeighborInfo.flow_size_overlap])
  ortho = int(row[NeighborInfo.flow_size_ortho])
  off_ortho = int(row[NeighborInfo.coarse_offset_ortho])
  off_z = int(row[NeighborInfo.coarse_offset_z])
  gz, h, w = mesh_shape
  par_extent, ortho_extent = (w, h) if axis == 0 else (h, w)

  def start(on_neighbor: bool):
    s = 1 if on_neighbor else -1
    par = _window_edge_start(s * mult > 0, par_extent, overlap)
    orth = _window_edge_start(s * mult * off_ortho > 0, ortho_extent, ortho)
    z = _window_edge_start(s * mult * off_z > 0, gz,
                           int(row[NeighborInfo.flow_size_z]))
    return (z, orth, par) if axis == 0 else (z, par, orth)

  return start(True), start(False)


def _fine_offset(row) -> list[int]:
  return [int(row[a]) for a in (NeighborInfo.fine_off_x,
                                NeighborInfo.fine_off_y,
                                NeighborInfo.fine_off_z)]


def _lift_2d(v: torch.Tensor) -> torch.Tensor:
  """[2, n, y, x] -> [3, n, 1, y, x]: a zero z channel and a unit z axis."""
  return torch.cat([v, torch.zeros_like(v[:1])])[:, :, None]


class TargetMeshPlan:
  """`prev_fn` of the joint solve: every tile's target mesh per step.

  The reference's `compute_target_mesh` vmapped over the tiles ([2|3,
  n, (z,) y, x]), with the per-row window geometry, flow slabs, fine
  offsets and composition taps resolved once from the host `nbors`
  table. The flows of all rows are NaN-padded to one common block shape
  (NaN updates keep what is there, as in the reference), so one batched
  composition serves every row; the pastes then run in the reference's
  order, tile by tile and row by row. 2d meshes, flows and rows are
  lifted to z = 1 with a zero z channel: the z taps then weigh exactly
  1 and 0, so the composition equals the reference's bilinear one.
  """

  def __init__(self, nbors: np.ndarray, fx: torch.Tensor, fy: torch.Tensor,
               stride, mesh_shape):
    nbors = np.asarray(nbors)
    self.dim = fx.shape[0]
    if self.dim == 2:
      fx, fy = _lift_2d(fx), _lift_2d(fy)
      stride = (1.0,) + tuple(float(v) for v in stride)
      mesh_shape = (1,) + tuple(mesh_shape)
      # coarse_offset_z 0, flow_size_z 1, fine_off_z 0.
      extra = np.broadcast_to(np.array([0, 1, 0]), nbors.shape[:-1] + (3,))
      nbors = np.concatenate([nbors, extra], axis=-1)
    self.mesh_shape = tuple(int(v) for v in mesh_shape)
    block = [max(int(a), int(b)) for a, b in zip(fx.shape[2:], fy.shape[2:])]
    self.block = block
    self.big = [m + b for m, b in zip(self.mesh_shape, block)]
    flows, nbor_starts, fine, nbr = [], [], [], []
    self.pastes = []  # (tile, (z, y, x)) in the reference's order
    for i in range(nbors.shape[0]):
      for row in nbors[i]:
        nbor_idx = int(row[NeighborInfo.nbor_idx])
        if nbor_idx == -1:
          continue
        mult = 1 if nbor_idx == int(row[NeighborInfo.flow_idx]) else -1
        axis = int(row[NeighborInfo.dim])
        flow = (fx if axis == 0 else fy)[:, int(row[NeighborInfo.flow_idx])]
        pad = []
        for a in (2, 1, 0):  # torch pad order: x, y, z
          pad += [0, block[a] - flow.shape[1 + a]]
        flows.append(torch.nn.functional.pad(mult * flow, pad,
                                             value=float('nan')))
        n_start, own_start = _windows(row, mult, self.mesh_shape)
        nbor_starts.append(n_start)
        fine.append([mult * v for v in _fine_offset(row)])
        nbr.append(nbor_idx)
        self.pastes.append((i, own_start))
    self.n_tiles = nbors.shape[0]
    self.compose = None
    if flows:
      dev = flows[0].device
      self.compose = map_utils.ComposePlan3d(
          torch.stack(flows), nbor_starts, stride, self.mesh_shape,
          [(0, 0, 0)] * len(flows), stride, mode='constant')
      self.fine = torch.tensor(fine, dtype=torch.float32,
                               device=dev).reshape(-1, 3, 1, 1, 1)
      self.nbr = torch.tensor(nbr, dtype=torch.int64, device=dev)

  def __call__(self, x: torch.Tensor) -> torch.Tensor:
    """[2|3, n, (z,) y, x] meshes -> spring targets of the same shape."""
    if self.dim == 2:
      return self._targets(_lift_2d(x))[:2, :, 0]
    return self._targets(x)

  def _targets(self, x: torch.Tensor) -> torch.Tensor:
    tgt = torch.full([3, self.n_tiles] + self.big, float('nan'),
                     dtype=torch.float32, device=x.device)
    if self.compose is not None:
      upd = self.compose.apply(x[:, self.nbr].transpose(0, 1)) + self.fine
      bz, by, bx = self.block
      for p, (i, (z, y, xx)) in enumerate(self.pastes):
        window = tgt[:, i, z:z + bz, y:y + by, xx:xx + bx]
        window.copy_(torch.where(torch.isnan(upd[p]), window, upd[p]))
    gz, gy, gx = self.mesh_shape
    return tgt[:, :, :gz, :gy, :gx]


def compute_target_mesh(nbor_data, x: torch.Tensor, fx: torch.Tensor,
                        fy: torch.Tensor, stride=(20, 20)) -> torch.Tensor:
  """Virtual-spring target positions for one tile mesh.

  A one-tile `TargetMeshPlan`; the solver builds the plan once instead.

  Args:
    nbor_data: [4, 8 or 11] neighbour rows (see NeighborInfo); -1 = none
    x: [2|3, n, (z,) y, x] all tile meshes
    fx/fy: [2|3, m, (z,) y, x] packed horizontal/vertical flows
    stride: [Z]YX mesh stride

  Returns:
    [2|3, (z,) y, x] target mesh, NaN where no neighbour constrains a
    node.
  """
  dim = x.shape[0]
  plan = TargetMeshPlan(np.asarray(nbor_data)[None], fx, fy, stride,
                        x.shape[-dim:])
  return plan(x)[:, 0]
