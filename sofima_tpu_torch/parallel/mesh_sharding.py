"""Spatially sharded mesh relaxation and dense flow on torch.distributed.

Twin of sofima_tpu/parallel/mesh_sharding.py. The reference runs one
program on every device of a jax Mesh (`shard_map`), exchanges 1-node
halos with its ring neighbours every step (`ppermute`) and turns FIRE's
global scalars into `psum` / `pmax` collectives. Here the same program
runs SPMD over processes, one rank per mesh position: a `DeviceMesh`
lays the ranks of the default process group out on named axes, the
halos travel point to point (`dist.batch_isend_irecv`, which posts both
directions at once so a ring never deadlocks on blocking sends) and the
scalars are `all_reduce`s. Every rank passes the same global arrays and
gets the same global result back (gathered at the end), as the
reference returns one result to its one controller.

Boundary contract, as the reference's: missing halos at the global
grid edges are NaN, which the spring stencil treats as absent springs
(on a CUDA tensor the shard's force is kernel K8 or K9, whose NaN rule
is the plain stencil's), so the sharded force equals the whole one and
the sharded solve equals `mesh.relax_mesh_fused` up to the order of its
sums. Indivisible extents are padded with NaN nodes and cropped.

Transport, a rule of the group's backend (`dist.get_backend`): the
collectives take every tensor where it is. On gloo a CUDA tensor's halo
rows pass through pinned host buffers, because gloo's point-to-point
calls take CPU tensors only; on NCCL they travel where they are.
Checked on an NVIDIA H100 with torch 2.11.0+cu128, two gloo ranks on
the card: `all_reduce`, `all_gather` and `broadcast` take a CUDA
tensor, and `batch_isend_irecv` of one fails in gloo's TCP transport
("Bad address").

Without an initialized process group the mesh is this one process: a
one-rank mesh whose halos are NaN and whose collectives are the
identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import mesh as mesh_lib
from sofima_tpu_torch import placement


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
  """One axis of a DeviceMesh as this rank sees it.

  `ranks` are the global ranks on the line through this rank along the
  axis, in coordinate order; `index` is this rank's coordinate; `group`
  is the process group over `ranks` (None: the default group, or no
  group when the axis has one rank).
  """
  name: str
  size: int
  index: int
  ranks: tuple[int, ...]
  group: object


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
  """Ranks of the default process group laid out on named axes.

  Answers what the reference reads of a jax Mesh: `axis_names` and
  `shape[axis]`; and what the collectives need: this rank's `coords`,
  the `axes` (one MeshAxis each, with its process group) and `group`
  over every rank of the mesh. `rank` is this process's global rank,
  None when it lies outside the mesh.
  """
  axis_names: tuple[str, ...]
  shape: dict[str, int]
  ranks: np.ndarray
  rank: int | None
  coords: tuple[int, ...] | None
  axes: dict[str, MeshAxis]
  group: object

  @property
  def size(self) -> int:
    return int(self.ranks.size)

  def axis(self, name: str) -> MeshAxis:
    return self.axes[name]


def _world() -> tuple[int, int]:
  """(world size, this rank) of the default group; (1, 0) before
  `dist.init_process_group`."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size(), dist.get_rank()
  return 1, 0


def _build_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> DeviceMesh:
  """The first prod(shape) ranks of the default group, row-major on
  `axis_names`. Every rank of the default group must call it (each
  process group is created by all of them, in one order)."""
  shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
  if len(shape) != len(axis_names):
    raise ValueError(f'mesh shape {shape} does not match the axis names '
                     f'{axis_names}')
  world, rank = _world()
  n = int(np.prod(shape))
  if n < 1 or n > world:
    raise ValueError(f'a mesh of {n} ranks needs 1 to {world} ranks in the '
                     'default process group')
  ranks = np.arange(n).reshape(shape)
  inside = rank < n
  group = None if n in (1, world) else dist.new_group(list(range(n)))
  coords = (tuple(int(c) for c in np.unravel_index(rank, shape)) if inside
            else None)
  axes = {}
  for a, name in enumerate(axis_names):
    mine = None
    if shape[a] > 1:
      # Every line along axis `a`, in row-major order of the other axes.
      lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
      for line in lines:
        members = [int(r) for r in line]
        g = None if len(members) == world else dist.new_group(members)
        if inside and rank in members:
          mine = (tuple(members), g)
    if inside:
      line_ranks, g = mine if mine else ((rank,), None)
      axes[name] = MeshAxis(name, shape[a], coords[a], line_ranks, g)
  return DeviceMesh(axis_names, dict(zip(axis_names, shape)), ranks,
                    rank if inside else None, coords, axes, group)


def _buffer(like: torch.Tensor, stage: bool) -> torch.Tensor:
  """An empty contiguous tensor shaped like `like`, pinned on the host
  when staged."""
  if stage:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
  return torch.empty_like(like, memory_format=torch.contiguous_format)


def _to_wire(t: torch.Tensor, stage: bool) -> torch.Tensor:
  """`t` as it is sent: contiguous, and in a pinned host buffer when
  staged."""
  return _buffer(t, True).copy_(t) if stage else t.contiguous()


def _exchange(axis: MeshAxis, to_prev: torch.Tensor | None,
              to_next: torch.Tensor | None):
  """One SPMD shift along `axis`: every rank sends `to_prev` to the
  previous rank and `to_next` to the next (None: nothing that way), in
  one batch, and receives what its neighbours send it. Returns
  (from_prev, from_next), None at the axis's ends and where nothing is
  sent that way; received tensors lie on the device of what was sent."""
  i, n = axis.index, axis.size
  like = to_prev if to_prev is not None else to_next
  # Through host memory: a CUDA tensor on gloo.
  stage = (n > 1 and like.is_cuda
           and dist.get_backend(axis.group) == 'gloo')
  ops, got = [], [None, None]
  # (neighbour, what goes there, what comes back: the neighbour's
  # opposite send).
  for side, at, out, back in ((0, i - 1, to_prev, to_next),
                              (1, i + 1, to_next, to_prev)):
    if not 0 <= at < n:
      continue
    peer = axis.ranks[at]
    if out is not None:
      ops.append(dist.P2POp(dist.isend, _to_wire(out, stage), peer,
                            axis.group))
    if back is not None:
      got[side] = _buffer(back, stage)
      ops.append(dist.P2POp(dist.irecv, got[side], peer, axis.group))
  if ops:
    for work in dist.batch_isend_irecv(ops):
      work.wait()
  if stage:
    got = [None if g is None else g.to(like.device) for g in got]
  return got[0], got[1]


def _all_reduce(t: torch.Tensor, mesh: DeviceMesh,
                op=None) -> torch.Tensor:
  """`t` reduced over every rank of `mesh` (SUM by default)."""
  if mesh.size == 1:
    return t
  buf = t.clone()
  dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op,
                  group=mesh.group)
  return buf


def _all_gather(t: torch.Tensor, group, size: int) -> list[torch.Tensor]:
  """Every rank's `t` (equal shapes) over `group`, in group-rank order."""
  if size == 1:
    return [t]
  t = t.contiguous()
  out = [torch.empty_like(t) for _ in range(size)]
  dist.all_gather(out, t, group=group)
  return out


def _halo_pad(x_local: torch.Tensor, group_or_axis: MeshAxis,
              spatial_axis: int) -> torch.Tensor:
  """Pads the local block with 1-slice halos from its neighbours.

  `spatial_axis` is the array axis exchanged (negative ok) along the
  mesh axis `group_or_axis`. The ends of the axis receive NaN halos (no
  springs across the global boundary); with one rank on the axis both
  halos are NaN.
  """
  axis = group_or_axis
  ax = spatial_axis % x_local.ndim
  first = x_local.narrow(ax, 0, 1)
  last = x_local.narrow(ax, x_local.shape[ax] - 1, 1)
  if axis.size > 1:
    # My first slice goes back (their trail halo), my last slice forward
    # (their lead halo).
    lead, trail = _exchange(axis, first, last)
  else:
    lead = trail = None
  nan = torch.full_like(first, float('nan'))
  lead = nan if lead is None else lead
  trail = nan if trail is None else trail
  return torch.cat([lead, x_local, trail], dim=ax)


def _crop(f: torch.Tensor, axis: int) -> torch.Tensor:
  return f.narrow(axis, 1, f.shape[axis] - 2)


def _sharded_force_2d(axis: MeshAxis, base_force=None):
  """Wraps an in-plane force with a 1-row halo exchange per evaluation.

  `base_force` defaults to `mesh.inplane_force` (kernel K8 on a CUDA
  shard); any callable of its signature serves, e.g.
  `mesh.inplane_force_plain`.
  """
  if base_force is None:
    base_force = mesh_lib.inplane_force

  def force(x_local, k, stride, prefer_orig_order=False):
    padded = _halo_pad(x_local, axis, -2)
    f = base_force(padded, k, stride, prefer_orig_order)
    return _crop(f, f.ndim - 2)
  return force


def _sharded_force_2d_grid(axis_y: MeshAxis, axis_x: MeshAxis,
                           base_force=None, dim: int = 2):
  """(y, x)-sharded stencil force: the y exchange, then the x exchange on
  the y-padded block, so corner nodes travel two hops and the diagonal
  springs see their corner halos. In-plane (dim=2) or the 26-neighbour
  volumetric force (dim=3, z unsharded)."""
  if base_force is None:
    base_force = (mesh_lib.inplane_force if dim == 2
                  else mesh_lib.elastic_mesh_3d)

  def force(x_local, k, stride, prefer_orig_order=False):
    padded = _halo_pad(x_local, axis_y, -2)
    padded = _halo_pad(padded, axis_x, -1)
    f = base_force(padded, k, stride, prefer_orig_order)
    return _crop(_crop(f, f.ndim - 2), f.ndim - 1)
  return force


def _sharded_force_3d(axis: MeshAxis, base_force=None):
  """The y-sharded 26-neighbour force (kernel K9 on a CUDA shard)."""
  return _sharded_force_2d(axis, base_force or mesh_lib.elastic_mesh_3d)


def make_mesh(n_devices: int | None = None,
              axis_name: str = 'mesh_y') -> DeviceMesh:
  """1d mesh over the first `n_devices` ranks (default: all)."""
  world = _world()[0]
  return _build_mesh((world if n_devices is None else n_devices,),
                     (axis_name,))


def make_mesh_2d(ny: int, nx: int, axis_y: str = 'mesh_y',
                 axis_x: str = 'mesh_x') -> DeviceMesh:
  """2-D mesh (row-major over the first ny * nx ranks) for (y, x)-sharded
  relaxation."""
  return _build_mesh((ny, nx), (axis_y, axis_x))


def _require_member(device_mesh: DeviceMesh) -> None:
  if device_mesh.rank is None:
    raise ValueError('this rank is not in the device mesh')


def _shard(t: torch.Tensor | None, sel: tuple) -> torch.Tensor | None:
  return None if t is None else t[sel].contiguous()


def relax_mesh_sharded(x, prev, config: mesh_lib.IntegrationConfig,
                       device_mesh: DeviceMesh, axis_name: str = 'mesh_y',
                       dim: int = 2, base_force=None, device=None):
  """Relaxes a y- (or y, x-) sharded mesh to convergence.

  Semantics of `mesh.relax_mesh_fused`, with the node grid split over
  `device_mesh` and a 1-node halo exchange per force evaluation. Called
  on every rank of the mesh with the same global arrays; every rank
  returns the same global result. Indivisible extents are padded with
  NaN nodes (absent to the stencil, left out of the drift means) and
  cropped.

  Args:
    x: [2 or 3, z, y, x] initial positions (global; numpy goes to
      `device`, default the CUDA card; a tensor stays where it is)
    prev: optional [2 or 3, z, y, x] zero-length spring targets
    config: integration parameters (FIRE required)
    device_mesh: a 1d mesh (y split over `axis_name`) or a 2d one (y, x)
    axis_name: mesh axis to shard y over (1d meshes)
    dim: 2 for the in-plane force, 3 for the volumetric stencil
    base_force: the per-shard force (default: mesh.inplane_force, or
      mesh.elastic_mesh_3d for dim=3)

  Returns:
    (x_final, e_kin history [max_chunks], steps executed)
  """
  if not config.fire:
    raise NotImplementedError('Sharded relaxation requires FIRE.')
  _require_member(device_mesh)
  two_d = len(device_mesh.axis_names) == 2
  axis_y = device_mesh.axis(device_mesh.axis_names[0] if two_d
                            else axis_name)
  axis_x = device_mesh.axis(device_mesh.axis_names[1]) if two_d else None
  n_y, n_x = axis_y.size, axis_x.size if two_d else 1
  x = placement.place(x, device, torch.float32)
  if prev is not None:
    prev = placement.place(prev, x.device, torch.float32)

  orig_y, orig_x = x.shape[-2:]
  pad_y, pad_x = (-orig_y) % n_y, (-orig_x) % n_x
  if pad_y or pad_x:
    x = torch.nn.functional.pad(x, (0, pad_x, 0, pad_y), value=float('nan'))
    if prev is not None:
      prev = torch.nn.functional.pad(prev, (0, pad_x, 0, pad_y),
                                     value=float('nan'))
  h_loc, w_loc = x.shape[-2] // n_y, x.shape[-1] // n_x
  iy, ix = axis_y.index, axis_x.index if two_d else 0
  sel = (Ellipsis, slice(iy * h_loc, (iy + 1) * h_loc),
         slice(ix * w_loc, (ix + 1) * w_loc))
  x_local, prev_local = _shard(x, sel), _shard(prev, sel)

  if two_d:
    force_fn = _sharded_force_2d_grid(axis_y, axis_x, base_force, dim=dim)
  elif dim == 2:
    force_fn = _sharded_force_2d(axis_y, base_force)
  else:
    force_fn = _sharded_force_3d(axis_y, base_force)

  def psum(v):
    return _all_reduce(v, device_mesh)

  def pmean_keepdims(v, dims):
    # NaN-aware: padded and absent nodes must not poison drift removal.
    finite = torch.isfinite(v)
    local = torch.where(finite, v, torch.zeros_like(v)).sum(
        dim=dims, keepdim=True)
    count = finite.to(torch.float32).sum(dim=dims, keepdim=True)
    total = psum(torch.stack([local, count]))
    return total[0] / torch.clamp(total[1], min=1.0)

  force, _, fire_step = mesh_lib._make_step_fns(
      config, force_fn, None, reduce_fn=psum, mean_fn=pmean_keepdims)

  def v_stats(v):
    v_sq = torch.sum(v * v, dim=0)
    e_kin = psum(torch.sum(v_sq))
    v_max = torch.sqrt(_all_reduce(torch.max(v_sq), device_mesh,
                                   dist.ReduceOp.MAX))
    return e_kin, v_max

  max_chunks = int(math.ceil(config.max_iters / config.num_iters))
  a0 = force(x_local, prev_local, torch.tensor(
      config.start_cap, dtype=torch.float32, device=x.device))
  state = mesh_lib.fire_state0(x_local, a0, config)
  state, e_hist, steps = mesh_lib.run_chunks(state, fire_step, prev_local,
                                             config, max_chunks, v_stats)

  blocks = _all_gather(state[0], device_mesh.group, device_mesh.size)
  rows = [torch.cat(blocks[r * n_x:(r + 1) * n_x], dim=-1)
          for r in range(n_y)]
  out = torch.cat(rows, dim=-2)[..., :orig_y, :orig_x]
  return out, e_hist, steps


def sharded_flow_step(device_mesh: DeviceMesh, axis_name: str = 'mesh_y',
                      device=None):
  """Returns a data-parallel batched xcorr + peaks step.

  run(pre_image, post_image, starts, patch_size) -> peaks [b, 4]: the
  images are replicated, the patch batch `starts` ([b, 2] (y, x)) is
  split over the ranks on `axis_name` (padded by repeating its last row
  when it does not divide) and each rank's share goes through
  `flow_field.batched_xcorr_peaks(..., mean=None)`; the peaks are
  gathered in the input order on every rank.
  """
  _require_member(device_mesh)
  axis = device_mesh.axis(axis_name)

  def run(pre_image, post_image, starts, patch_size):
    pre_image = placement.place(pre_image, device, torch.float32)
    post_image = placement.place(post_image, pre_image.device,
                                 torch.float32)
    starts = placement.place(starts, pre_image.device).to(torch.int64)
    b = starts.shape[0]
    per = -(-b // axis.size)
    starts = torch.cat([starts, starts[-1:].expand(per * axis.size - b, 2)])
    mine = starts[axis.index * per:(axis.index + 1) * per]
    peaks = flow_field.batched_xcorr_peaks(
        pre_image, post_image, None, None, patch_size, mine, mean=None)
    return torch.cat(_all_gather(peaks, axis.group, axis.size))[:b]

  return run


def dense_flow_field_sharded(device_mesh: DeviceMesh, pre_image, post_image,
                             patch_size: tuple[int, int],
                             step: tuple[int, int], batch_size: int = 1024,
                             axis_name: str = 'mesh_y', **flow_kwargs):
  """Spatially sharded dense flow grid over a 2d section pair.

  Each rank on `axis_name` takes a y strip of the images, receives the
  next rank's top (patch - step) rows (the last rank gets zeros, whose
  grid rows are cropped) and computes its strip of the grid with
  `flow_field.dense_flow_field` (kernel K1, or K5 with masks, on a CUDA
  tensor); the strips are gathered along y on every rank. Heights that
  do not split into step-aligned strips are padded (zero image, invalid
  mask) and the grid cropped to the original extent's, so the result
  equals the one-rank `dense_flow_field`.

  Masks (`pre_mask` / `post_mask` in `flow_kwargs`, True where invalid)
  are split and exchanged like the images. `device` in `flow_kwargs`
  places numpy inputs (default: the CUDA card); tensors stay where they
  are.

  Returns [dim+2, gy, gx] on the global grid.
  """
  _require_member(device_mesh)
  axis = device_mesh.axis(axis_name)
  device = flow_kwargs.pop('device', None)
  pre_image = placement.place(pre_image, device, torch.float32)
  post_image = placement.place(post_image, pre_image.device, torch.float32)
  h, w = pre_image.shape
  if post_image.shape != pre_image.shape:
    raise ValueError('sharded mode: equal shapes')
  py, px = int(patch_size[0]), int(patch_size[1])
  sy, sx = int(step[0]), int(step[1])
  # The global grid of the original extent (rows that padding touches
  # are cropped below).
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  unit = axis.size * sy
  h_pad = -(-h // unit) * unit
  masks = {}
  for key in ('pre_mask', 'post_mask'):
    m = flow_kwargs.pop(key, None)
    if m is not None:
      m = placement.place(m, pre_image.device)
      if tuple(m.shape) != (h, w):
        raise ValueError('masks must match the image shape')
      masks[key] = torch.nn.functional.pad(
          (m > 0).to(torch.uint8), (0, 0, 0, h_pad - h), value=1)
  pre_image = torch.nn.functional.pad(pre_image, (0, 0, 0, h_pad - h))
  post_image = torch.nn.functional.pad(post_image, (0, 0, 0, h_pad - h))
  h_loc = h_pad // axis.size
  halo = py - sy
  if halo > h_loc:
    raise ValueError(f'strips of {h_loc} rows cannot carry a halo of '
                     f'{halo} rows: use fewer ranks')

  def strip(img):
    own = img[axis.index * h_loc:(axis.index + 1) * h_loc]
    if halo == 0:
      return own
    _, below = _exchange(axis, own[:halo], None)
    if below is None:  # the last rank: zeros
      below = torch.zeros_like(own[:halo])
    return torch.cat([own, below])

  mask_kw = {k: strip(m) > 0 for k, m in masks.items()}
  local = flow_field.dense_flow_field(
      strip(pre_image), strip(post_image), (py, px), (sy, sx),
      batch_size=batch_size, **mask_kw, **flow_kwargs)
  out = torch.cat(_all_gather(local, axis.group, axis.size), dim=-2)
  return out[:, :gy, :gx]
