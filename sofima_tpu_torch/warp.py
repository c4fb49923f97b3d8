"""Warping and montage rendering: the library API.

Twin of sofima_tpu/warp.py:
  * `warp_subvolume`: warp [n, z, y, x] data by an inverse coordinate
    map. The map is densified bilinearly (with linear edge
    extrapolation) and every channel of every section is resampled by
    the K4 gather kernel (ops.cuda_warp.shift_warp, launch counter
    'warp_subvolume'). On the TPU the reference picks a global shift
    lattice (kernel K12, `warp_sections_pallas*`), a tiled one (K4p,
    `pallas_shift_warp_tiled(tile_bounds=...)`) or a gather; all three
    compute this function, which a gather reaches directly, so no branch
    is taken here. Around the resample everything is the reference's:
    NaN map entries give 0 (`nan_to_num`), sections whose map is all NaN
    give 0, integer outputs are rounded and clipped, uint32 data must fit
    in uint16, and uint64 segmentations are relabelled to a dense range,
    warped with 'nearest' and relabelled back;
  * `ndimage_warp`: N-d warp over overlapping work boxes; 2d boxes on K4
    (counter 'ndimage_warp', the reference's K12 `pallas_shift_warp`),
    3d boxes on K13 (ops.cuda_warp.shift_warp_3d) with the reference's
    per-box integer bases and bounds; an injected `map_coordinates`
    runs on the host as in the reference;
  * `render_tiles`: montage rendering with margins, tile masks and CLAHE
    (ops.clahe); `warp_points`; `make_contiguous` / `_restore_labels`;
  * `_densify_box_3d`, which the stitched-volume render
    (pipeline.stitch3d) also uses.
Host arrays go to `device` (default: the CUDA card; pass device='cpu'
without one); results come back as numpy, as the reference returns.
"""

from __future__ import annotations

import collections
from typing import Any, Sequence

import numpy as np
import torch

from sofima_tpu_torch import map_utils
from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import clahe as clahe_ops
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import interp
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.box_generator import BoxGenerator

_INTERP_METHODS = ('nearest', 'linear', 'cubic', 'lanczos')
_ORDER_METHOD = {0: 'nearest', 1: 'linear', 3: 'cubic'}


def _normalize_interp(interpolation: str | None, dtype) -> str:
  if dtype == np.uint64:
    return 'nearest'
  if interpolation is None:
    return 'lanczos'
  if interpolation not in _INTERP_METHODS:
    raise ValueError(f'Unknown interpolation {interpolation!r}; '
                     f'expected one of {_INTERP_METHODS}')
  return interpolation


def make_contiguous(data: np.ndarray) -> tuple[np.ndarray, list]:
  """Maps arbitrary uint64 ids to the dense range [0, n)."""
  orig_ids = np.unique(data)
  low = np.searchsorted(orig_ids, data)
  return low, list(zip(orig_ids.tolist(), range(len(orig_ids))))


def _restore_labels(data: np.ndarray, orig_to_low: list,
                    old_uids: frozenset) -> np.ndarray:
  new_uids = frozenset(np.unique(data.astype(np.uint64)))
  diff = (new_uids - old_uids) - {0}
  assert not diff, f'Unexpected new ids after warp: {diff}'
  orig_ids = np.array([o for o, _ in orig_to_low], dtype=np.uint64)
  return orig_ids[data.astype(np.int64)]


def _plane_to(arr: np.ndarray, dev) -> torch.Tensor:
  """A host plane as a contiguous float32 tensor on `dev` (8-bit and
  signed planes cross as they are and widen there)."""
  arr = np.ascontiguousarray(arr)
  if arr.dtype.kind == 'u' and arr.dtype.itemsize > 1:
    arr = arr.astype(np.float32)
  return torch.as_tensor(arr, device=dev).to(torch.float32).contiguous()


def warp_subvolume(image, image_box: BoundingBox, coord_map,
                   map_box: BoundingBox, stride: float, out_box: BoundingBox,
                   interpolation: str | None = None, offset: float = 0.0,
                   parallelism: int = 1, device=None) -> np.ndarray:
  """Warps [n, z, y, x] data by an inverse coordinate map -> numpy.

  Every map entry ([2, z, my, mx] relative, anchored at `map_box` with
  node spacing `stride`) gives the source coordinate in `image`
  (anchored at `image_box`) to read from; the output covers `out_box`.
  `parallelism` is accepted for API compatibility.
  """
  del parallelism
  image = placement.to_host(image)
  assert image.ndim == 4
  orig_dtype = image.dtype
  orig_to_low = None
  if image.dtype == np.uint64:
    method = 'nearest'
    image, orig_to_low = make_contiguous(image)
    assert image.max() < 2**31
    image = image.astype(np.int32)
    old_uids = frozenset(np.unique(image))
  else:
    method = _normalize_interp(interpolation, image.dtype)
    if image.dtype == np.uint32:
      if image.max() >= 2**16:
        raise ValueError('Image warping supports up to uint16; use uint64 '
                         'for segmentation data.')
      image = image.astype(np.uint16)

  coord_map = placement.to_host(coord_map)
  skipped = np.all(np.isnan(coord_map), axis=(0, 2, 3))
  # Inverse map in absolute, source-image-local pixel coordinates.
  abs_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  abs_map += (map_box.start[:2] * stride - image_box.start[:2]
              + offset).reshape(2, 1, 1, 1).astype(np.float32)
  # Output pixel coordinates in map-node units (a separable grid).
  out_y = (np.arange(int(out_box.size[1]), dtype=np.float32)
           + out_box.start[1] - offset) / stride - map_box.start[1]
  out_x = (np.arange(int(out_box.size[0]), dtype=np.float32)
           + out_box.start[0] - offset) / stride - map_box.start[0]

  dev = placement.resolve(device)
  grid = [torch.as_tensor(out_y.astype(np.float32), device=dev)[:, None],
          torch.as_tensor(out_x.astype(np.float32), device=dev)[None, :]]
  n_c, n_z = image.shape[:2]
  oy, ox = len(out_y), len(out_x)
  warped = np.zeros((n_c, n_z, oy, ox), np.float32)
  for z in range(n_z):
    if skipped[z]:
      continue
    m = torch.as_tensor(abs_map[:, z], device=dev)
    coords = torch.stack([interp.grid_sample_linear(m[1], grid),
                          interp.grid_sample_linear(m[0], grid)])[None]
    coords = coords.contiguous()
    for c in range(n_c):
      warped[c, z] = cuda_warp.shift_warp(
          _plane_to(image[c, z], dev)[None], coords, method,
          counter='warp_subvolume')[0].cpu().numpy()
    del coords
  warped = np.nan_to_num(warped)
  warped[:, skipped] = 0.0
  if orig_to_low is not None:
    return _restore_labels(np.rint(warped).astype(np.int64), orig_to_low,
                           old_uids)
  if np.issubdtype(orig_dtype, np.integer):
    info = np.iinfo(orig_dtype)
    return np.clip(np.rint(warped), info.min, info.max).astype(orig_dtype)
  return warped.astype(orig_dtype)


def _densify_box_3d(src_map_zyx: torch.Tensor, box_start, inv_stride,
                    neg_off, box_shape) -> torch.Tensor:
  """Trilinear map densification for one work box.

  `src_map_zyx`: [3, gz, gy, gx] absolute source coords at map nodes
  (channels z, y, x); output voxel v of the box samples the node grid at
  (box_start + v + neg_off) * inv_stride per axis, with linear
  extrapolation past the last node. Returns [3, *box_shape] per-voxel
  source sampling coords. The query grid is separable, so it is passed
  to the sampler as three broadcastable axis vectors.
  """
  dev = src_map_zyx.device
  coords = []
  for a in range(3):
    view = [1, 1, 1]
    view[a] = int(box_shape[a])
    iota = torch.arange(box_shape[a], dtype=torch.float32, device=dev)
    c = ((float(box_start[a]) + iota + float(neg_off[a]))
         * float(inv_stride[a]))
    coords.append(c.reshape(view))
  return torch.stack([interp.grid_sample_linear(src_map_zyx[a], coords)
                      .expand(*box_shape) for a in range(3)])


def _box_bounds_3d(dense: torch.Tensor, box_start_zyx):
  """The reference's per-box integer bases and bucketed bounds of the
  displacement `dense - (own position + box start)`, per axis; None when
  an axis has no finite displacement."""
  bucket = 4
  bases, bounds = [], []
  for a in range(3):
    view = [1, 1, 1]
    view[a] = dense.shape[a + 1]
    own = torch.arange(dense.shape[a + 1], dtype=torch.float32,
                       device=dense.device).reshape(view)
    disp = dense[a] - (own + float(box_start_zyx[a]))
    fin = disp[torch.isfinite(disp)]
    if fin.numel() == 0:
      return None
    lo, hi = float(fin.min()), float(fin.max())
    base = int(np.rint((lo + hi) / 2.0))
    bases.append(base)
    bounds.append((int(np.floor((lo - base - 1) / bucket) * bucket),
                   int(np.ceil((hi - base + 1) / bucket) * bucket)))
  return bases, bounds


def ndimage_warp(image, coord_map, stride: Sequence[float],
                 work_size: Sequence[int], overlap: Sequence[int],
                 order: int = 1, map_coordinates=None,
                 image_box: BoundingBox | None = None,
                 map_box: BoundingBox | None = None,
                 out_box: BoundingBox | None = None, parallelism: int = 1,
                 out_scale: Sequence[float] = (1.0, 1.0, 1.0),
                 device=None) -> np.ndarray:
  """N-d warp via dense coordinate lookup, tiled into work boxes.

  Args:
    image: [z,] y, x data to warp
    coord_map: [N, [z,] y, x] inverse coordinate map
    stride: [z,] y, x map node spacing in pixels
    work_size: xy[z] work box size
    overlap: xy[z] work box overlap
    order: 0, 1 or 3 (nearest / linear / cubic)
    map_coordinates: optional host sampler with the signature of
      ndimage.map_coordinates (decorators inject custom samplers)
    image_box / map_box / out_box: optional boxes anchoring the data, the
      map and the output in a global coordinate system
    parallelism: accepted for API compatibility
    out_scale: xy[z] output-voxel / source-voxel scale
    device: where the boxes are densified and resampled (default: the
      CUDA card)

  Returns:
    the warped image covering out_box (or the image extent), numpy
  """
  del parallelism
  image = placement.to_host(image)
  coord_map = placement.to_host(coord_map)
  shape = coord_map.shape[1:]
  dim = len(shape)
  assert dim == len(stride) == len(overlap) == len(work_size)
  if dim != image.ndim:
    raise ValueError(f'Dim mismatch: image {image.ndim} vs map {dim}')
  orig_to_low = None
  if image.dtype == np.uint64:
    image, orig_to_low = make_contiguous(image)
    old_uids = frozenset(np.unique(image))
    image = image.astype(np.int32)
    order = 0

  src_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  if map_box is not None:
    if image_box is None:
      raise ValueError('image_box required when map_box is given.')
    src_map += (map_box.start[:dim] * np.asarray(stride)[::-1]
                - image_box.start[:dim] / np.asarray(out_scale)[:dim]
                ).reshape((dim,) + (1,) * dim)
  reshaper = (slice(None),) + (np.newaxis,) * dim
  src_map = src_map * np.asarray(out_scale[:dim])[reshaper]

  sub_dim = 0
  image_size_xyz = image.shape[::-1]
  if dim == 2:
    work_size = list(work_size) + [1]
    overlap = list(overlap) + [0]
    image_size_xyz = list(image_size_xyz) + [1]
    sub_dim = 1
  if out_box is not None:
    warped = np.zeros(shape=tuple(int(s) for s in out_box.size[::-1]),
                      dtype=image.dtype)
  else:
    warped = np.zeros_like(image)
    out_box = BoundingBox(start=(0, 0, 0), size=image_size_xyz)
  gen = BoxGenerator(
      outer_box=BoundingBox(start=(0, 0, 0), size=out_box.size),
      box_size=work_size, box_overlap=overlap, back_shift_small_boxes=True)
  if map_box is not None:
    offset_zyx = (map_box.start * np.asarray(stride)[::-1]
                  - out_box.start)[::-1]
  else:
    offset_zyx = np.zeros(3)
  offs = offset_zyx[sub_dim:][:dim]

  builtin = map_coordinates is None
  if builtin and order not in _ORDER_METHOD:
    raise ValueError(f'order {order} is not one of {sorted(_ORDER_METHOD)}')
  dev = placement.resolve(device)
  if builtin:
    image_t = _plane_to(image, dev)
    maps_t = torch.as_tensor(np.ascontiguousarray(src_map[::-1]),
                             device=dev)  # [z]yx channels

  for i in range(gen.num_boxes):
    _, in_box = gen.generate(i)
    starts = in_box.start[::-1][sub_dim:].astype(np.int64)
    ends = in_box.end[::-1][sub_dim:].astype(np.int64)
    if builtin:
      # Separable box grid in map-node units, densified with linear
      # extrapolation past the last node.
      axes = []
      for a in range(dim):
        view = [1] * dim
        view[a] = int(ends[a] - starts[a])
        c = torch.arange(int(starts[a]), int(ends[a]), dtype=torch.float32,
                         device=dev)
        axes.append(((c - float(offs[a])) / float(stride[a])).reshape(view))
      box_shape = tuple(int(e - s) for s, e in zip(starts, ends))
      dense = torch.stack([interp.grid_sample_linear(m, axes).expand(
          *box_shape) for m in maps_t]).contiguous()
      if dim == 2:
        sub = cuda_warp.shift_warp(image_t[None], dense[None],
                                   _ORDER_METHOD[order],
                                   counter='ndimage_warp')[0]
      else:
        plan = _box_bounds_3d(dense, starts)
        if plan is None:
          sub = torch.zeros(box_shape, device=dev)
        else:
          bases, bounds = plan
          flat = [v for b in bounds for v in b]
          sub = cuda_warp.shift_warp_3d(
              image_t, dense, _ORDER_METHOD[order], *flat,
              *(int(s) + b for s, b in zip(starts, bases)))
      sub_warped = sub.cpu().numpy()
    else:
      sel = [np.s_[int(s):int(e)] for s, e in zip(starts, ends)]
      box_coords = np.mgrid[tuple(sel)].astype(np.float32)
      map_coords = [(c - o) / s for c, s, o in zip(box_coords, stride, offs)]
      dense = [map_coordinates(chan, map_coords, order=1)
               for chan in src_map[::-1]]
      sub_warped = map_coordinates(image, dense, order=order)
    sub_warped = np.nan_to_num(sub_warped)
    if np.issubdtype(image.dtype, np.integer):
      sub_warped = np.rint(sub_warped)
    out_sub = gen.index_to_cropped_box(i)
    rel = out_sub.translate(-in_box.start)
    warped[out_sub.to_slice3d()[sub_dim:]] = sub_warped[
        rel.to_slice3d()[sub_dim:]].astype(warped.dtype)

  if orig_to_low is not None:
    return _restore_labels(warped.astype(np.int64), orig_to_low, old_uids)
  return warped.astype(image.dtype)


def render_tiles(tiles: dict, coord_maps: dict,
                 stride: tuple[int, int] = (20, 20), margin: int = 50,
                 parallelism: int = 1, width: int | None = None,
                 height: int | None = None, use_clahe: bool = False,
                 clahe_kwargs=None, margin_overrides: dict | None = None,
                 return_warped_tiles: bool = False,
                 tile_masks: dict | None = None, device=None):
  """Warps a collection of tiles into one montage image (numpy).

  Per tile: the forward map ([2, 1, my, mx], (x, y) -> map) is inverted
  over its outer box (`map_utils.invert_map`, `fill_missing` with
  extrapolation), the tile (CLAHE-equalized with `use_clahe`) and its
  margin / tile mask are rendered together by `warp_subvolume`, and the
  result is pasted where the rendered mask is set and the image is
  positive. `margin_overrides`: (x, y) -> (top, bottom, left, right).

  Returns:
    (canvas, mask) or, with `return_warped_tiles`, (canvas, mask,
    {(x, y): (x0, y0, warped)}).
  """
  del parallelism
  if stride[0] != stride[1]:
    raise NotImplementedError('Only equal XY strides are supported.')
  any_tile = placement.to_host(next(iter(tiles.values())))
  img_yx = any_tile.shape
  image_box = BoundingBox(start=(0, 0, 0), size=(img_yx[1], img_yx[0], 1))
  map_yx = next(iter(coord_maps.values())).shape[-2:]
  map_box = BoundingBox(start=(0, 0, 0), size=(map_yx[1], map_yx[0], 1))
  if width is None or height is None:
    max_x = max(x for x, _ in tiles)
    max_y = max(y for _, y in tiles)
    height, width = img_yx[0] * (max_y + 1), img_yx[1] * (max_x + 1)
  canvas = np.zeros((height, width), dtype=any_tile.dtype)
  canvas_mask = np.zeros((height, width), dtype=bool)
  warped_map: dict[tuple[int, int], Any] = {}
  clahe_kwargs = clahe_kwargs or {}

  for (tile_x, tile_y), coord_map in coord_maps.items():
    img = tiles.get((tile_x, tile_y))
    if img is None:
      continue
    img = placement.to_host(img)
    coord_map = placement.to_host(coord_map)
    tile_mask = None if tile_masks is None else tile_masks.get(
        (tile_x, tile_y))
    tg_box = map_utils.outer_box(coord_map, map_box, stride[0])
    tg_box = tg_box.adjusted_by(start=(-1, -1, 0), end=(1, 1, 0))
    inv = map_utils.invert_map(coord_map, map_box, tg_box, stride[0],
                               device=device)
    inv = map_utils.fill_missing(inv, extrapolate=True, device=device)

    mask = np.zeros_like(img)
    if margin_overrides is not None and (tile_x, tile_y) in margin_overrides:
      top, bottom, left, right = margin_overrides[tile_x, tile_y]
      mask[top:-(bottom + 1), left:-(right + 1)] = 1
    else:
      mask[margin:-(margin + 1), margin:-(margin + 1)] = 1
    if use_clahe:
      img = (clahe_ops.equalize_adapthist(img, device=device, **clahe_kwargs)
             * np.iinfo(img.dtype).max).astype(img.dtype)
    if tile_mask is not None:
      mask[placement.to_host(tile_mask) == 0] = 0
    stacked = np.concatenate([img[np.newaxis, np.newaxis],
                              mask[np.newaxis, np.newaxis]], axis=0)
    out_box = BoundingBox(
        start=((tg_box.start[0] + 1) * stride[1],
               (tg_box.start[1] + 1) * stride[0], 0),
        size=(int(tg_box.size[0] * stride[1]),
              int(tg_box.size[1] * stride[0]), 1))
    warped = warp_subvolume(stacked, image_box, inv, tg_box, stride[0],
                            out_box=out_box, device=device)
    warped_img = warped[0, 0]
    warped_mask = warped[1, 0].astype(bool)

    y0 = img_yx[0] * tile_y + int(out_box.start[1])
    x0 = img_yx[1] * tile_x + int(out_box.start[0])
    if x0 < 0:
      warped_img, warped_mask, x0 = warped_img[:, -x0:], warped_mask[:, -x0:], 0
    if y0 < 0:
      warped_img, warped_mask, y0 = warped_img[-y0:, :], warped_mask[-y0:, :], 0
    target = canvas[y0:y0 + warped_img.shape[0], x0:x0 + warped_img.shape[1]]
    th, tw = target.shape
    warped_img = warped_img[:th, :tw]
    warped_mask = warped_mask[:th, :tw]
    if return_warped_tiles:
      warped_map[(tile_x, tile_y)] = (x0, y0, warped_img)
    canvas_mask[y0:y0 + th, x0:x0 + tw][warped_mask] = True
    warped_mask = warped_mask & (warped_img > 0)
    target[warped_mask] = warped_img[warped_mask]

  if return_warped_tiles:
    return canvas, canvas_mask, warped_map
  return canvas, canvas_mask


def warp_points(points: np.ndarray, coord_map, map_box: BoundingBox,
                stride: float, device=None) -> np.ndarray:
  """Warps [n, 3] XYZ points through a [2, z, y, x] coordinate map.

  Integer input dtypes are preserved (coordinates rounded).
  """
  points = np.asarray(points)
  assert points.ndim == 2 and points.shape[1] == 3
  coord_map = placement.to_host(coord_map)
  assert coord_map.shape[0] == 2
  abs_map = map_utils.to_absolute(np.asarray(coord_map, np.float32), stride)
  abs_map += (map_box.start[:2] * stride).reshape(2, 1, 1, 1).astype(
      np.float32)
  by_z = collections.defaultdict(list)
  for i, p in enumerate(points):
    by_z[p[2]].append(i)
  ret = points.copy()
  for z, idxs in by_z.items():
    z_rel = int(z - map_box.start[2])
    qy = (points[idxs, 1] / stride) - map_box.start[1]
    qx = (points[idxs, 0] / stride) - map_box.start[0]
    coords = placement.place(np.stack([qy, qx]).astype(np.float32), device)
    dx, dy = (interp.grid_sample_linear(
        placement.place(abs_map[c, z_rel], device), coords).cpu().numpy()
              for c in (0, 1))
    if np.issubdtype(ret.dtype, np.integer):
      dx = np.round(dx).astype(ret.dtype)
      dy = np.round(dy).astype(ret.dtype)
    ret[idxs, 0] = dx
    ret[idxs, 1] = dy
  return ret
