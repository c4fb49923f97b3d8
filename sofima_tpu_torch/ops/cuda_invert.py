"""The invert layer's CUDA wrappers: 2d map inversion and hole fill.

No `sofima_tpu` Pallas twin: the reference runs `map_utils._invert_section`
and `ops/fill.fill_invalid` as XLA programs. Their plain PyTorch versions
stay where they are (map_utils.py, ops/fill.py) and take every CPU
tensor; a CUDA tensor with a 2d field comes here, to csrc/invert.cu:
  * `invert_section`: `_invert_section` under its `shift_bound` contract,
    any leading batch of maps, one launch (`invert_kernel`, one thread a
    query node running every iteration in registers);
  * `fill_invalid` (dim 2, with or without `extrapolate`) and
    `nearest_fill`: the multigrid harmonic fill, the span hull and the
    jump-flooding nearest fill in one call of `fill_invalid_launch`,
    which walks the launch table that `fill_plan` lays out here (13
    launches at the stack path's 250^2 nodes, whatever the batch).
Each launch is counted in `_build.launch_counts` ('invert_section',
'fill_invalid').
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from sofima_tpu_torch.ops import _build

# csrc/invert.cu's constants: each table carries the first five, and the
# launch refuses a table laid out with values other than its own.
FILL_TILE = 32            # level_kernel: interior nodes a tile side (kTile)
FILL_HALO = 16            # and its halo: Jacobi sweeps a launch (kHalo)
FILL_COARSE_NODES = 4096  # levels at most this large: coarse_kernel
FILL_DOWN_TILE = 64       # prep_kernel: level-a nodes a tile side
FILL_DOWN_LEVELS = 6      # levels one prep launch builds (log2 of the tile)
FILL_MAX_LEVELS = 32      # kMaxLevels
SMEM_MAX = 232448         # shared memory a block may take on an H100

MODE_FILL, MODE_EXTRAPOLATE, MODE_NEAREST = 0, 1, 2


def fill_levels(shape) -> tuple[tuple[int, int], ...]:
  """The multigrid levels of a 2d field, finest first (ops/fill's
  harmonic_fill: halve, rounding up, while a side exceeds 2)."""
  levels = [tuple(int(n) for n in shape)]
  while max(levels[-1]) > 2:
    levels.append(tuple((n + 1) // 2 for n in levels[-1]))
  return tuple(levels)


def jfa_steps(shape) -> tuple[int, ...]:
  """ops/fill.nearest_fill's jump-flooding steps: from the first power of
  two at least the longer side down to 1."""
  s = 1
  while s < max(shape):
    s *= 2
  return tuple(1 << i for i in range(s.bit_length() - 1, -1, -1))


def _tiles(shape, tile: int) -> int:
  return math.ceil(shape[0] / tile) * math.ceil(shape[1] / tile)


@dataclasses.dataclass(frozen=True)
class FillPlan:
  """The fill's launches on a [g0, g1] field: `launches` rows (kind,
  arguments), kinds 'prep' (a, b: build levels a + 1 .. b from level a,
  with the hull's extents in the first), 'jfa' (step; the last one writes
  the output), 'coarse' and 'level' (k, sweeps, first: upsample from level
  k + 1 or continue the previous chunk)."""
  levels: tuple[tuple[int, int], ...]
  coarse: int                # first level coarse_kernel solves
  steps: tuple[int, ...]     # jump-flooding steps (none without extrapolation)
  launches: tuple[tuple, ...]
  coarse_smem: int           # dynamic shared memory, bytes
  level_smem: int

  def level_tiles(self, k: int) -> int:
    return _tiles(self.levels[k], FILL_TILE)


def coarse_smem_bytes(levels, coarse: int) -> int:
  """coarse_kernel's shared memory: values and weights of every level from
  `coarse` on, and two sweep buffers of level `coarse`."""
  nodes = [h * w for h, w in levels[coarse:]]
  return 4 * (2 * sum(nodes) + 2 * nodes[0])


def level_smem_bytes() -> int:
  """level_kernel's: two sweep buffers and the level's values (floats) and
  keep flags (bytes) over a tile with its halo."""
  region = (FILL_TILE + 2 * FILL_HALO) ** 2
  return 13 * region


@functools.lru_cache(maxsize=64)
def fill_plan(shape, jacobi_iters: int = 16,
              mode: int = MODE_EXTRAPOLATE) -> FillPlan:
  """Lays out the fill of one [g0, g1] field. Raises ValueError where a
  kernel's shared memory would not fit."""
  levels = fill_levels(shape)
  if len(levels) > FILL_MAX_LEVELS:
    raise ValueError(f'{shape}: more than {FILL_MAX_LEVELS} levels')
  steps = jfa_steps(shape) if mode != MODE_FILL else ()
  if mode == MODE_NEAREST:
    launches = [('jfa', s) for s in steps]
    return FillPlan(levels, 0, steps, tuple(launches), 0, 0)
  coarse = next(k for k, (h, w) in enumerate(levels)
                if h * w <= FILL_COARSE_NODES)
  launches = []
  a = 0
  while True:  # the first prep launch also takes the hull's extents
    b = min(a + FILL_DOWN_LEVELS, coarse)
    launches.append(('prep', a, b))
    if b == coarse:
      break
    a = b
  launches += [('jfa', s) for s in steps[:-1]]
  launches.append(('coarse',))
  chunks = max(1, math.ceil(jacobi_iters / FILL_HALO))
  for k in range(coarse - 1, -1, -1):
    for j in range(chunks):
      sweeps = min(FILL_HALO, jacobi_iters - j * FILL_HALO)
      launches.append(('level', k, sweeps, j == 0))
  launches.append(('jfa', steps[-1] if steps else 0))
  plan = FillPlan(levels, coarse, steps, tuple(launches),
                  coarse_smem_bytes(levels, coarse), level_smem_bytes())
  if max(plan.coarse_smem, plan.level_smem) > SMEM_MAX:
    raise ValueError(f'{shape}: a fill kernel needs more than {SMEM_MAX} '
                     'bytes of shared memory')
  return plan


@functools.lru_cache(maxsize=64)
def _fill_table(shape, jacobi_iters: int, mode: int, n_fields: int,
                n_masks: int):
  """fill_invalid_launch's int64 table (csrc/invert.cu) with the scratch
  sizes: (table, address, float scratch, int scratch, launches); the
  table is held here, so its address stays valid."""
  plan = fill_plan(shape, jacobi_iters, mode)
  g0, g1 = plan.levels[0]
  fsz = 0

  def falloc(n):
    nonlocal fsz
    fsz += n
    return fsz - n

  rows = []
  for k, (h, w) in enumerate(plan.levels):
    inner = 0 < k <= plan.coarse and mode != MODE_NEAREST
    v = falloc(n_fields * h * w) if inner else -1
    wt = falloc(n_fields * h * w) if inner else -1
    rows.append([h, w, v, wt, -1])
  if mode != MODE_NEAREST:
    for k in range(plan.coarse + 1):
      rows[k][4] = falloc(n_fields * rows[k][0] * rows[k][1])
  chunks = max(1, math.ceil(jacobi_iters / FILL_HALO))
  tmp = falloc(n_fields * g0 * g1) if chunks > 1 else -1
  ints = [n_masks * g0] * 2 + [n_masks * g1] * 2 + [n_masks]
  offs = list(np.cumsum([0] + ints))
  seeds = (offs[-1], offs[-1] + n_masks * g0 * g1)
  isz = offs[-1] + (2 * n_masks * g0 * g1 if len(plan.steps) > 1 else 0)

  out, seed_in, seed_n = [], -1, 0
  for i, launch in enumerate(plan.launches):
    kind = launch[0]
    if kind == 'prep':
      _, a, b = launch
      n_down = n_fields * _tiles(plan.levels[a], FILL_DOWN_TILE) if b > a else 0
      out.append([0, a, b, n_down, n_masks if a == 0 else 0])
    elif kind == 'jfa':
      dst = -1 if i == len(plan.launches) - 1 else seeds[seed_n % 2]
      out.append([1, launch[1], seed_in, dst, 0])
      seed_in, seed_n = dst, seed_n + 1
    elif kind == 'coarse':
      out.append([2, 0, 0, 0, 0])
    else:  # chunks of a level alternate buffers, the last one its own
      _, k, sweeps, first = launch
      j = 0 if first else j + 1
      dst = rows[k][4] if (chunks - 1 - j) % 2 == 0 else tmp
      out.append([3, k, sweeps, -1 if first else out[-1][4], dst])
  # level_kernel's shared memory is the file's constant, whatever the mode.
  head = [len(plan.levels), plan.coarse, jacobi_iters, mode, len(out),
          plan.coarse_smem, level_smem_bytes()] + offs[:5] + [
              FILL_TILE, FILL_HALO, FILL_COARSE_NODES, FILL_DOWN_TILE,
              FILL_DOWN_LEVELS]
  table = np.ascontiguousarray(np.asarray(
      head + sum(rows, []) + sum(out, []), np.int64))
  table.flags.writeable = False
  return table, table.ctypes.data, fsz, isz, len(out)


def _fill(values: torch.Tensor, valid: torch.Tensor, jacobi_iters: int,
          mode: int) -> torch.Tensor:
  """[..., c, g0, g1] values, [..., g0, g1] masks -> float32 [..., c, g0,
  g1] through fill_invalid_launch."""
  if values.ndim < 3:
    raise ValueError(f'[..., c, y, x] values expected, got '
                     f'{tuple(values.shape)}')
  lead, c, (g0, g1) = values.shape[:-3], values.shape[-3], values.shape[-2:]
  values = values.to(torch.float32).contiguous()
  valid = valid.to(torch.bool).expand(*lead, g0, g1).contiguous()
  if values.numel() == 0:
    return values.clone()
  _build.require_cuda('fill_invalid', values)
  _build.require_cuda('fill_invalid', valid, dtype=torch.bool)
  if valid.device != values.device:
    raise ValueError('fill_invalid: values and masks must be on one device')
  n_masks = math.prod(lead)
  table, addr, fsz, isz, launches = _fill_table(
      (g0, g1), int(jacobi_iters), mode, n_masks * c, n_masks)
  fn = _build.library().fill_invalid_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
  out = torch.empty_like(values)
  fs = torch.empty(max(fsz, 1), dtype=torch.float32, device=values.device)
  iscr = torch.empty(max(isz, 1), dtype=torch.int32, device=values.device)
  rc = fn(values.data_ptr(), valid.data_ptr(), out.data_ptr(), fs.data_ptr(),
          iscr.data_ptr(), addr, n_masks * c, c, n_masks,
          _build.stream_of(values))
  _build.count('fill_invalid', launches)
  _build.check(rc, 'fill_invalid')
  return out


def fill_invalid(values: torch.Tensor, valid: torch.Tensor,
                 extrapolate: bool = False,
                 jacobi_iters: int = 16) -> torch.Tensor:
  """ops/fill.fill_invalid (dim 2) on the card, float32 out."""
  return _fill(values, valid, jacobi_iters,
               MODE_EXTRAPOLATE if extrapolate else MODE_FILL)


def nearest_fill(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
  """ops/fill.nearest_fill (dim 2) on the card, float32 out."""
  return _fill(values, valid, 0, MODE_NEAREST)


def invert_section(abs_map_xy: torch.Tensor, src_start_yx, query_xy,
                   stride_yx, num_iters: int, tol: float, newton_iters: int,
                   shift_bound: int, shift_origin=(0, 0)) -> torch.Tensor:
  """map_utils._invert_section under `shift_bound` on the card: [..., 2,
  g0, g1] maps, [2, oy, ox] or [..., 2, oy, ox] queries, float32 out."""
  lead = abs_map_xy.shape[:-3]
  g0, g1 = abs_map_xy.shape[-2:]
  if newton_iters > 0 and min(g0, g1) < 2:
    raise ValueError('Newton steps sample the Jacobian: the map needs 2 '
                     'nodes or more along each axis')
  abs_map = abs_map_xy.to(torch.float32).contiguous()
  query = query_xy.to(torch.float32)
  oy, ox = query.shape[-2:]
  if query.ndim == 3:
    q_bstride = 0
    query = query.contiguous()
  else:
    query = query.expand(*lead, 2, oy, ox).contiguous()
    q_bstride = 2 * oy * ox
  _build.require_cuda('invert_section', abs_map, query)
  src = [float(v) for v in src_start_yx]
  strd = [float(v) for v in stride_yx]
  max_stride = max(strd)
  fn = _build.library().invert_section_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
  out = torch.empty((*lead, 2, oy, ox), dtype=torch.float32,
                    device=abs_map.device)
  rc = fn(abs_map.data_ptr(), query.data_ptr(), out.data_ptr(), q_bstride,
          math.prod(lead), g0, g1, oy, ox, src[0], src[1], strd[0], strd[1],
          int(num_iters), int(newton_iters), tol * max_stride,
          8.0 * max_stride, float(int(shift_bound) + 1),
          int(shift_origin[0]), int(shift_origin[1]),
          _build.stream_of(abs_map))
  _build.count('invert_section')
  _build.check(rc, 'invert_section')
  return out
