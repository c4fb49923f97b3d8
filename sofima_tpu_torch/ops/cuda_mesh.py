"""Kernels K3, K8, K9 and K11: the mesh solvers' CUDA wrappers and plain twins.

Twin of sofima_tpu/ops/pallas_mesh.py:
  * K3 `relax_mesh_fused`: `relax_mesh_fused_pallas` (Pallas body
    `_fused_fire_kernel` with `_roll_force_2d`), the fused 2d FIRE solve;
  * K8 `force_2d`: `inplane_force_pallas` (`_kernel` with `_force_tile`),
    the 8-neighbour in-plane force with the contract of
    mesh.inplane_force; csrc/force2d.cu, a row-streaming stencil that
    evaluates each link once;
  * K9 `force_3d`: `elastic_mesh_3d_pallas` (`_kernel_3d_loop`,
    `_kernel_3d_rolls`) and its slab twin `elastic_mesh_3d_pallas_slab`
    (K10), the force of the 26-neighbour springs (or of a given subset,
    `links`) with the contract of mesh.elastic_mesh_3d; csrc/force3d.cu,
    a z-streaming stencil that evaluates each link once;
  * K11 `relax_mesh_fused_3d`: `relax_mesh_fused_pallas_3d`, the fused
    3d FIRE solve.
K3 and K11 are one cooperative kernel in csrc/fire.cu, templated on the
dimension: one launch runs the whole chunked convergence loop, each block
holding one tile of the mesh in shared memory for the whole solve, with
one grid-wide exchange a step. `fire_plan` (pure Python, tested on the CPU)
sizes the tiles so that every block is resident at once. On an H100 that
holds a 2d mesh of up to ~1M nodes when near square, fewer when
elongated (100 x 4700 at most), and a 3d mesh of up to 262 144 nodes
([8, 128, 256]). A larger mesh takes the second route of the same
library, `grid_fire_kernel` (the state in device memory, a grid-stride
loop over nodes, two grid barriers a step; `fire_route` picks it). Both
routes take every mesh up to the reference's VMEM bound, 786 432 nodes
in 2d and 524 288 in 3d, and the entries raise the reference's
ValueError above it (`within_vmem_bound`); the stack pipeline then takes
the staged solver, by the reference's own rule (`fused_fits`).

Contract of the fused solvers, as the reference's: FIRE required;
returns (x, e_kin history [min(max_chunks, 128)], steps). Nodes outside
the grid or with NaN positions carry no springs. Drift removal is in
neither the kernel nor its plain version: `remove_drift=True` raises
NotImplementedError on every device rather than run another solver (the
stack pipeline then takes the staged mesh.relax_mesh_fused, with K8, as
the reference takes its XLA solver).
The 3d reference's `link_loop`, `symmetric` and `guard` options select
Mosaic workarounds with one result, and have no counterpart here.

Each wrapper launches its kernel for CUDA tensors (and counts the
launch in `_build.launch_counts`) and takes the plain version only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from sofima_tpu_torch import mesh as mesh_lib
from sofima_tpu_torch.ops import _build

MAX_HISTORY = 128


def roll_force_2d(xp: torch.Tensor, k: float, stride,
                  prefer_orig_order: bool) -> torch.Tensor:
  """8-neighbour in-plane force on a NaN-ring-padded [2, Y, X] array.

  Twin of pallas_mesh._roll_force_2d: neighbours come from circular
  rolls, and the NaN guard ring makes the wraparound inert.
  """
  sx, sy = float(stride[0]), float(stride[1])
  acc0 = torch.zeros(xp.shape[1:], dtype=torch.float32, device=xp.device)
  acc1 = torch.zeros_like(acc0)
  for ey in (-1, 0, 1):
    for ex in (-1, 0, 1):
      if ex == 0 and ey == 0:
        continue
      nbor = torch.roll(xp, shifts=(-ey, -ex), dims=(1, 2))
      l0x = float(np.float32(sx * ex))
      l0y = float(np.float32(sy * ey))
      l0 = float(np.hypot(l0x, l0y))
      k_eff = k if (ex == 0 or ey == 0) else k / np.sqrt(2.0)
      d0 = nbor[0] - xp[0] + l0x
      d1 = nbor[1] - xp[1] + l0y
      dd = d0 * d0 + d1 * d1
      inv_l = torch.rsqrt(torch.clamp(dd, min=0.0))
      if prefer_orig_order:
        fac0 = float(ex) * torch.sign(d0) if ex != 0 else 1.0
        fac1 = float(ey) * torch.sign(d1) if ey != 0 else 1.0
        f0 = k_eff * (1.0 - l0 * fac0 * inv_l) * d0
        f1 = k_eff * (1.0 - l0 * fac1 * inv_l) * d1
      else:
        coef = k_eff * (1.0 - l0 * inv_l)
        f0, f1 = coef * d0, coef * d1
      fin = torch.isfinite(dd)
      acc0 = acc0 + torch.where(fin, f0, torch.zeros_like(f0))
      acc1 = acc1 + torch.where(fin, f1, torch.zeros_like(f1))
  return torch.stack([acc0, acc1])


def force_2d(x: torch.Tensor, k: float, stride,
             prefer_orig_order: bool = False) -> torch.Tensor:
  """K8: 8-neighbour in-plane force of [2, ..., y, x] positions (the
  contract of mesh.inplane_force). CPU tensors take the plain version."""
  if x.ndim < 3 or x.shape[0] != 2:
    raise ValueError(f'[2, ..., y, x] positions expected, got '
                     f'{tuple(x.shape)}')
  if len(stride) != 2:
    raise ValueError('stride must be 2D (XY).')
  if x.device.type == 'cpu':
    return mesh_lib.inplane_force_plain(x, k, stride, prefer_orig_order)
  x = x.to(torch.float32).contiguous()
  _build.require_cuda('force_2d', x)
  fn = _build.library().force2d_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
  ny, nx = x.shape[-2:]
  nb = int(np.prod(x.shape[1:-2], dtype=np.int64))
  out = torch.empty_like(x)
  rc = fn(x.data_ptr(), out.data_ptr(), nb, ny, nx, float(k),
          float(k / np.sqrt(2.0)), float(stride[0]), float(stride[1]),
          int(prefer_orig_order), _build.stream_of(x))
  _build.count('force2d')
  _build.check(rc, 'force2d')
  return out


# K9's tiling (csrc/force3d.cu): tiles of kTY rows (one warp each) by 32
# lanes of FORCE3D_NODES_A_LANE columns (kV); kTY is the first of
# FORCE3D_ROWS where that grid gives every SM a block, else the second.
FORCE3D_ROWS = (16, 8)
FORCE3D_NODES_A_LANE = 4


@functools.lru_cache(maxsize=256)
def _fire_link_table(k: float, stride: tuple) -> np.ndarray:
  """K11's per-link (l0x, l0y, l0z, l0, k_eff) float32 [26, 5] in the
  kernel's (ez, ey, ex) loop order, k_eff = k * stride_x / l0; cached
  per (k, stride), read-only."""
  sx, sy, sz = (float(s) for s in stride)
  rows = []
  for ez in (-1, 0, 1):
    for ey in (-1, 0, 1):
      for ex in (-1, 0, 1):
        if ex == 0 and ey == 0 and ez == 0:
          continue
        l0v = np.asarray([sx * ex, sy * ey, sz * ez], np.float32)
        l0 = float(np.linalg.norm(l0v))
        rows.append([*l0v, l0, k * sx / l0])
  table = np.ascontiguousarray(np.asarray(rows, np.float32))
  table.flags.writeable = False
  return table


def _forward(d) -> tuple[int, int, int]:
  """The direction of a link from the end at which it points forward,
  (ez, ey, ex) > 0: a link and its negation are one spring."""
  return d if (d[2], d[1], d[0]) > (0, 0, 0) else tuple(-c for c in d)


@functools.lru_cache(maxsize=256)
def _link_table(k: float, stride, links) -> np.ndarray:
  """K9's table: the springs of `links` (xyz directions in
  {-1, 0, 1}^3, either sign) in forward form, one row each, float32 [n,
  8] (ex, ey, ez, l0x, l0y, l0z, l0, k_eff) with k_eff = k * stride_x /
  l0 as the reference's elastic_mesh_3d; a spring given twice takes the
  sum. Cached per (k, stride, links) as given (hashable), read-only."""
  stride = mesh_lib._stride3(stride)
  k_of = {}
  for d in links:
    if any(c not in (-1, 0, 1) for c in d):
      raise ValueError('Link components must be in {-1, 0, 1}.')
    l0 = float(np.linalg.norm([stride[c] * d[c] for c in range(3)]))
    f = _forward(d)
    k_of[f] = k_of.get(f, 0.0) + k * stride[0] / l0
  rows = []
  for f in sorted(k_of, key=lambda e: (e[2], e[1], e[0])):
    l0v = np.asarray([stride[c] * f[c] for c in range(3)], np.float32)
    rows.append([*f, *l0v, float(np.linalg.norm(l0v)), k_of[f]])
  table = np.ascontiguousarray(np.asarray(rows, np.float32).reshape(-1, 8))
  table.flags.writeable = False
  return table


@functools.lru_cache(maxsize=256)
def _link_args(k: float, stride, links) -> tuple[np.ndarray, int, int]:
  """K9's table with its launch arguments (address, rows), cached as
  _link_table: the table is held here, so its address stays valid."""
  table = _link_table(k, stride, links)
  return table, table.ctypes.data, len(table)


def force_3d(x: torch.Tensor, k: float, stride,
             prefer_orig_order: bool = False,
             links=mesh_lib.MESH_LINK_DIRECTIONS) -> torch.Tensor:
  """K9: force of the springs `links` (default all 26 neighbours) on [3,
  ..., z, y, x] positions (the contract of mesh.elastic_mesh_3d). CPU
  tensors take the plain version."""
  shape = x.shape
  if len(shape) < 4 or shape[0] != 3:
    raise ValueError(f'[3, ..., z, y, x] positions expected, got '
                     f'{tuple(shape)}')
  if x.is_cpu:
    return mesh_lib.elastic_mesh_3d_plain(x, k, stride, prefer_orig_order,
                                          links)
  try:
    _, table, n_links = _link_args(k, stride, links)
  except TypeError:  # lists: the cache key must be hashable
    _, table, n_links = _link_args(k, mesh_lib._stride3(stride),
                                   tuple(map(tuple, links)))
  if x.dtype != torch.float32 or not x.is_contiguous():
    x = x.to(torch.float32).contiguous()
  _build.require_cuda('force_3d', x)
  fn = _build.library().force3d_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  out = torch.empty_like(x)
  rc = fn(x.data_ptr(), out.data_ptr(), math.prod(shape[1:-3]), shape[-3],
          shape[-2], shape[-1], table, n_links, int(prefer_orig_order),
          _build.stream_of(x))
  _build.count('force3d')
  _build.check(rc, 'force3d')
  return out


def _max_chunks(config) -> int:
  return min(int(math.ceil(config.max_iters / config.num_iters)), MAX_HISTORY)


def relax_mesh_fused_plain(x: torch.Tensor, prev: torch.Tensor | None,
                           config: mesh_lib.IntegrationConfig):
  """Plain PyTorch version of the fused solver on [2, gy, gx] state."""
  pad = (1, 1, 1, 1)
  xp = torch.nn.functional.pad(x.to(torch.float32), pad, value=float('nan'))
  pp = None if prev is None else torch.nn.functional.pad(
      prev.to(torch.float32), pad, value=float('nan'))
  force, _, fire_step = mesh_lib._make_step_fns(
      config, lambda xx, k, s, po: roll_force_2d(xx, k, s, po))
  a0 = force(xp, pp, torch.tensor(config.start_cap, dtype=torch.float32,
                                  device=xp.device))
  state = mesh_lib.fire_state0(xp, a0, config)

  def v_stats(v):
    v_sq = v[0] * v[0] + v[1] * v[1]
    return torch.sum(v_sq), torch.sqrt(torch.max(v_sq))

  state, e_hist, steps = mesh_lib.run_chunks(
      state, fire_step, pp, config, _max_chunks(config), v_stats)
  return state[0][:, 1:-1, 1:-1], e_hist, steps


FIRE_THREADS = 256            # threads per block (csrc/fire.cu kThreads)
FIRE_NPT = (1, 2, 4, 8, 16)   # nodes per thread the plan may take
FIRE_MAX_BLOCKS = 512         # barrier slots one thread polls: two each
FIRE_MAX_HALO = 32 * FIRE_THREADS  # halo entries a block polls: 32 each
# Dynamic shared memory a block may take: the H100's 227 KB less the
# kernel's static share.
FIRE_SMEM_MAX = 232448 - 1024


@dataclasses.dataclass(frozen=True)
class FirePlan:
  """K3 / K11's launch plan: one block of FIRE_THREADS threads per tile of
  tz x ty x tx = FIRE_THREADS * npt nodes (ty, tx powers of two), all
  blocks co-resident for the whole solve."""
  npt: int
  tile: tuple[int, int, int]    # (tz, ty, tx) nodes
  tiles: tuple[int, int, int]   # tiles per axis (z, y, x)
  smem_bytes: int               # dynamic shared memory per block

  @property
  def nblocks(self) -> int:
    return int(np.prod(self.tiles))


def fire_smem_bytes(dim: int, tile) -> int:
  """Shared memory of one block: positions of the tile and its halo box
  (one node each side; none in z in 2d), the tile's v and a, and the list
  of halo entries (box index, face word, polled x, v and a)."""
  tz, ty, tx = tile
  box = (tz + (2 if dim == 3 else 0)) * (ty + 2) * (tx + 2)
  tn = tz * ty * tx
  return 4 * (dim * box + 2 * dim * tn + (2 + 3 * dim) * (box - tn))


def fire_pub_words(dim: int, plan: FirePlan) -> int:
  """64-bit words of the published tile faces: two sets (by step parity)
  of each tile's face slots (its x faces, y faces and, in 3d, z faces),
  3 * dim words a slot (x, v, a)."""
  tz, ty, tx = plan.tile
  nf = 2 * (tz * ty + tz * tx) + (2 * ty * tx if dim == 3 else 0)
  return 2 * plan.nblocks * 3 * dim * nf


def _fire_tiles(dim: int, npt: int):
  nodes = FIRE_THREADS * npt
  for sx in range(3, 9):  # tx 8 .. 256
    for sy in range(0, 9):
      tz = nodes >> (sx + sy)
      if tz >= 1 and tz << (sx + sy) == nodes and (dim == 3 or tz == 1):
        yield (tz, 1 << sy, 1 << sx)


def fire_halo_nodes(dim: int, shape, tile) -> int:
  """Halo entries that lie on the mesh, summed over all tiles: each
  block recomputes these positions every step."""
  total = 1
  for axis, (n, t) in enumerate(zip(shape, tile)):
    h = 0 if (axis == 0 and dim == 2) else 1
    total *= sum(min(o + t + h, n) - max(o - h, 0) for o in range(0, n, t))
  return total - int(np.prod(shape))


def fire_plan(dim: int, shape, max_blocks) -> FirePlan:
  """The tiling of a [dim, nz, gy, gx] mesh (shape = (nz, gy, gx), nz = 1
  in 2d). `max_blocks(smem_bytes)`: blocks the card holds at once.

  Takes the smallest nodes-per-thread count of FIRE_NPT whose tiling fits
  the card, and for it the tile that minimises the thread slots plus the
  halo entries recomputed per step. Raises ValueError if none fits.
  """
  for p in FIRE_NPT:
    best = None
    for tile in _fire_tiles(dim, p):
      smem = fire_smem_bytes(dim, tile)
      box = (tile[0] + (2 if dim == 3 else 0)) * (tile[1] + 2) * (tile[2] + 2)
      if smem > FIRE_SMEM_MAX or box - np.prod(tile) > FIRE_MAX_HALO:
        continue
      tiles = tuple(-(-n // t) for n, t in zip(shape, tile))
      cost = (int(np.prod(tiles)) * FIRE_THREADS * p
              + fire_halo_nodes(dim, shape, tile))
      if best is None or (cost, tile) < best[0]:
        best = ((cost, tile), FirePlan(p, tile, tiles, smem))
    if best is not None and best[1].nblocks <= min(
        max_blocks(best[1].smem_bytes), FIRE_MAX_BLOCKS):
      return best[1]
  raise ValueError(
      f'a [{dim}, {", ".join(map(str, shape))}] mesh does not fit the fused '
      'solver: its tiles at the largest nodes-per-thread count exceed the '
      'blocks the card holds at once')


# The reference's bound on the fused solvers (the state of a node in
# VMEM: 16 bytes a channel; sofima_tpu/ops/pallas_mesh.py:937-938 and
# :1178-1179, and its stack pipeline's `fits_vmem`): 786 432 nodes in 2d,
# 524 288 in 3d. Both routes take every mesh up to it and none above.
VMEM_BOUND_BYTES = 24 * 1024 * 1024
VMEM_MESSAGE = 'grid too large for the VMEM-resident solver'


def within_vmem_bound(dim: int, shape) -> bool:
  """Whether a [dim, *shape] mesh is within the reference's VMEM bound."""
  return int(np.prod(shape)) * 16 * dim <= VMEM_BOUND_BYTES


def fire_route(dim: int, shape, max_blocks) -> FirePlan | None:
  """The fused solvers' route for a [dim, nz, gy, gx] mesh (shape = (nz,
  gy, gx)): the tiled plan of fire_plan where one fits the card, else
  None (the grid-stride route). Raises ValueError with the reference's
  message above its VMEM bound."""
  if not within_vmem_bound(dim, shape):
    raise ValueError(VMEM_MESSAGE)
  try:
    return fire_plan(dim, shape, max_blocks)
  except ValueError:
    return None


def _fire_library(lib):
  """The fused solver's C functions, their argtypes set once per library."""
  fn = lib.fused_fire_launch
  if fn.argtypes is None:  # ctypes keeps the object
    lib.fused_fire_max_blocks.argtypes = [ctypes.c_int] * 4
    lib.fused_fire_max_blocks.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 10 + [ctypes.c_float] * 7
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 5
                   + [ctypes.c_int] + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    lib.grid_fire_max_blocks.argtypes = [ctypes.c_int] * 3
    lib.grid_fire_max_blocks.restype = ctypes.c_int
    lib.grid_fire_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + list(fn.argtypes[18:]))
    lib.grid_fire_launch.restype = ctypes.c_int
  return lib


def _max_blocks_on(lib, device: int, dim: int, prefer: bool):
  """The card's co-resident blocks of the tiled kernel, by shared
  memory."""
  blocks = {}

  def max_blocks(smem):
    if smem not in blocks:
      blocks[smem] = lib.fused_fire_max_blocks(device, dim, int(prefer), smem)
      if blocks[smem] <= 0:
        raise RuntimeError('cooperative launch unavailable on this device')
    return blocks[smem]

  return max_blocks


@functools.lru_cache(maxsize=None)
def _fire_route_on(lib, device: int, dim: int, prefer: bool, shape):
  """fire_route with the card's occupancy, per library, device, kernel
  (dimension, prefer_orig_order) and shape."""
  return fire_route(dim, shape, _max_blocks_on(lib, device, dim, prefer))


@functools.lru_cache(maxsize=None)
def _grid_blocks_on(lib, device: int, dim: int, prefer: bool) -> int:
  """The grid-stride route's grid: every block the card holds at once."""
  nblocks = lib.grid_fire_max_blocks(device, dim, int(prefer))
  if nblocks <= 0:
    raise RuntimeError('cooperative launch unavailable on this device')
  return nblocks


def fire_plan_of(x: torch.Tensor,
                 config: mesh_lib.IntegrationConfig) -> FirePlan:
  """The tiled plan a launch on [dim, (1 or z,) y, x] state `x` (on a
  card) takes under `config`; ValueError where it takes the grid-stride
  route."""
  shape = (1,) * (4 - x.ndim) + tuple(x.shape[1:])
  plan = _fire_route_on(_fire_library(_build.library()), _device_index(x),
                        x.shape[0], bool(config.prefer_orig_order), shape)
  if plan is None:
    raise ValueError(f'a {list(x.shape)} mesh takes the grid-stride route')
  return plan


def fused_fits(x: torch.Tensor, config: mesh_lib.IntegrationConfig) -> bool:
  """Whether the fused solvers take [dim, (1 or z,) y, x] state `x` under
  `config`, by the reference's rule (its stack pipeline's `fits_vmem`
  and no drift removal), on every device."""
  return (within_vmem_bound(x.shape[0], x.shape[1:])
          and not config.remove_drift)


def _device_index(x: torch.Tensor) -> int:
  return x.device.index if x.device.index is not None else (
      torch.cuda.current_device())


def _fire_scalars(config) -> tuple:
  """The solver scalars both launchers take, in their order."""
  c = config
  return (c.dt, c.gamma, c.k0, c.k, float(c.k / np.sqrt(2.0)),
          float(c.stride[0]), float(c.stride[1]), c.num_iters,
          _max_chunks(config), c.stop_v_max, c.f_alpha, c.f_inc, c.f_dec,
          c.alpha, c.n_min, float(np.float32(c.dt_max * c.dt)), c.start_cap,
          c.final_cap, c.cap_scale, c.cap_upscale_every,
          int(c.prefer_orig_order))


def _launch(x, prev, config, counter):
  """One cooperative launch of csrc/fire.cu on [dim, (z,) y, x] state: the
  tiled kernel where its tiles fit the card, else the grid-stride one."""
  dim = x.shape[0]
  _build.require_cuda(counter, *([x] if prev is None else [x, prev]))
  lib = _fire_library(_build.library())
  nz, gy, gx = (1,) * (4 - x.ndim) + tuple(x.shape[1:])
  dev = x.device
  prefer = bool(config.prefer_orig_order)
  plan = _fire_route_on(lib, _device_index(x), dim, prefer, (nz, gy, gx))
  table = (_fire_link_table(float(config.k),
                            mesh_lib._stride3(config.stride))
           if dim == 3 else None)
  table_ptr = None if table is None else table.ctypes.data
  max_chunks = _max_chunks(config)
  ehist = torch.full((max_chunks,), float('nan'), dtype=torch.float32,
                     device=dev)
  if plan is None:
    nblocks = _grid_blocks_on(lib, _device_index(x), dim, prefer)
    out = x.clone()  # relaxed in place
    v, a = torch.empty_like(x), torch.empty_like(x)
    part = torch.empty(3 * nblocks, dtype=torch.float64, device=dev)
    steps = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = lib.grid_fire_launch(
        dim, out.data_ptr(), _build.ptr(prev), v.data_ptr(), a.data_ptr(),
        part.data_ptr(), ehist.data_ptr(), steps.data_ptr(), nz, gy, gx,
        nblocks, *_fire_scalars(config), table_ptr, _build.stream_of(x))
    _build.count(counter)
    _build.count('fused_fire_grid')
    _build.check(rc, counter)
    return out, ehist, steps[0]
  out = torch.empty_like(x)
  # One zeroed buffer of 64-bit words: the tile faces' (x, v, a), two
  # sets; the exchange's (two sets of one per block and value, and three
  # totals); the step count.
  n_pub = fire_pub_words(dim, plan)
  words = torch.zeros(n_pub + 2 * (3 * plan.nblocks + 3) + 1,
                      dtype=torch.int64, device=dev)
  base = words.data_ptr()
  tz, ty, tx = plan.tile
  rc = lib.fused_fire_launch(
      dim, x.data_ptr(), out.data_ptr(), _build.ptr(prev), base,
      base + 8 * n_pub, ehist.data_ptr(), base + 8 * (words.numel() - 1),
      nz, gy, gx, tz, ty.bit_length() - 1, tx.bit_length() - 1, *plan.tiles,
      plan.smem_bytes, *_fire_scalars(config), table_ptr,
      _build.stream_of(x))
  _build.count(counter)
  _build.check(rc, counter)
  return out, ehist, words[-1]


def _check_fused(config):
  if not config.fire:
    raise NotImplementedError('the fused solvers require FIRE.')
  if config.remove_drift:
    raise NotImplementedError(
        'drift removal is not in the fused solver (ROADMAP.md Queue 1, '
        'item 8: drift removal inside the fused kernel)')


def relax_mesh_fused(x: torch.Tensor, prev: torch.Tensor | None,
                     config: mesh_lib.IntegrationConfig):
  """K3: fused 2d FIRE relaxation of [2, 1, gy, gx] state ->
  (x, e_kin history, steps). CPU tensors take the plain version."""
  _check_fused(config)
  if x.ndim != 4 or x.shape[:2] != (2, 1):
    raise ValueError('[2, 1, gy, gx] state expected')
  if not within_vmem_bound(2, x.shape[2:]):
    raise ValueError(VMEM_MESSAGE)
  x = x[:, 0].to(torch.float32).contiguous()
  prev = None if prev is None else prev[:, 0].to(torch.float32).contiguous()
  if x.device.type == 'cpu':
    out, ehist, steps = relax_mesh_fused_plain(x, prev, config)
  else:
    out, ehist, steps = _launch(x, prev, config, 'fused_fire')
  return out[:, None], ehist, steps


def relax_mesh_fused_3d_plain(x: torch.Tensor, prev: torch.Tensor | None,
                              config: mesh_lib.IntegrationConfig):
  """Plain PyTorch version of the fused 3d solver on [3, z, y, x] state,
  with the force of mesh.elastic_mesh_3d."""
  x = x.to(torch.float32)
  prev = None if prev is None else prev.to(torch.float32)
  force, _, fire_step = mesh_lib._make_step_fns(
      config, mesh_lib.elastic_mesh_3d_plain)
  a0 = force(x, prev, torch.tensor(config.start_cap, dtype=torch.float32,
                                   device=x.device))
  state = mesh_lib.fire_state0(x, a0, config)

  def v_stats(v):
    v_sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    return torch.sum(v_sq), torch.sqrt(torch.max(v_sq))

  state, e_hist, steps = mesh_lib.run_chunks(
      state, fire_step, prev, config, _max_chunks(config), v_stats)
  return state[0], e_hist, steps


def relax_mesh_fused_3d(x: torch.Tensor, prev: torch.Tensor | None,
                        config: mesh_lib.IntegrationConfig):
  """K11: fused 3d FIRE relaxation of [3, z, y, x] state ->
  (x, e_kin history, steps). CPU tensors take the plain version."""
  _check_fused(config)
  if x.ndim != 4 or x.shape[0] != 3:
    raise ValueError('[3, z, y, x] state expected')
  if len(config.stride) != 3:
    raise ValueError('the 3d solver needs an xyz stride')
  if not within_vmem_bound(3, x.shape[1:]):
    raise ValueError(VMEM_MESSAGE)
  x = x.to(torch.float32).contiguous()
  prev = None if prev is None else prev.to(torch.float32).contiguous()
  if x.device.type == 'cpu':
    return relax_mesh_fused_3d_plain(x, prev, config)
  return _launch(x, prev, config, 'fused_fire_3d')
