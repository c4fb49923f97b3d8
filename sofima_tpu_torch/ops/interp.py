"""Dense interpolation on small grids.

Twin of sofima_tpu/ops/interp.py: `sample` and `sample_channels` (any
rank) and `map_coordinates` in the reference's four methods (nearest,
linear, cubic with a = -0.75, normalized Lanczos4; `kernel_taps`), with
its NaN contract; `grid_sample_linear` (bilinear or trilinear, with
linear edge extrapolation) and `upsample_map_linear`. Plain PyTorch:
these run on small node grids or are simple streaming passes, with no
kernel of their own. The renders' kernels (K4, K13) evaluate the same
tap weights in csrc/warp_weights.cuh and their own Lanczos code.

`method_taps` / `apply_taps` split `sample` in two, so that a caller
sampling many images at the same coordinates (the stitching solver's
spring targets, every step) computes the taps once, and
`sample_batched` samples a batch of 2d images each at its own
coordinates.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

_KERNEL_TAPS = {
    'nearest': 1,
    'linear': 2,
    'cubic': 4,
    'lanczos': 8,
}


def kernel_taps(method: str) -> int:
  """Taps per axis of an interpolation method."""
  if method not in _KERNEL_TAPS:
    raise ValueError(f'Unknown interpolation method: {method!r}')
  return _KERNEL_TAPS[method]


def float_type(t: torch.Tensor) -> torch.dtype:
  """float64 for float64 tensors, else float32 (the working types)."""
  return torch.float64 if t.dtype == torch.float64 else torch.float32


def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
  """Keys cubic (a = -0.75, OpenCV's convention) weights of taps -1..2."""
  a = -0.75

  def w_near(d):  # |d| <= 1
    return (a + 2.0) * (d * d * d) - (a + 3.0) * (d * d) + 1.0

  def w_far(d):  # 1 < |d| < 2
    return a * (d * d * d) - 5.0 * a * (d * d) + 8.0 * a * d - 4.0 * a

  return [w_far(1.0 + t), w_near(t), w_near(1.0 - t), w_far(2.0 - t)]


def _lanczos_weights(t: torch.Tensor) -> list[torch.Tensor]:
  """Lanczos4 weights of taps -3..4, normalized to sum to 1."""
  ws = []
  for i in range(-3, 5):
    d = t - i
    x = math.pi * d
    # sinc(d) * sinc(d / 4), with the removable singularity at d = 0.
    ws.append(torch.where(torch.abs(d) < 1e-7, torch.ones_like(d),
                          4.0 * torch.sin(x) * torch.sin(x / 4.0) / (x * x)))
  total = sum(ws)
  return [w / total for w in ws]


def _tap_weights(t: torch.Tensor, method: str):
  """(tap offsets from the base index, per-tap weights) of `method`."""
  if method == 'nearest':
    return [0], [torch.ones_like(t)]
  if method == 'linear':
    return [0, 1], [1.0 - t, t]
  if method == 'cubic':
    return [-1, 0, 1, 2], _cubic_weights(t)
  if method == 'lanczos':
    return list(range(-3, 5)), _lanczos_weights(t)
  raise ValueError(f'Unknown interpolation method: {method!r}')


def method_taps(coords: torch.Tensor, spatial: Sequence[int], method: str,
                mode: str, lead: int = 0):
  """The taps of `coords` on a grid of shape `spatial`.

  Args:
    coords: [*lead, dim, *out] sample coordinates in grid index space,
      ordered like the grid axes
    spatial: grid shape (dim entries)
    method: 'nearest' (the base index is the rounded coordinate),
      'linear', 'cubic' or 'lanczos'
    mode: 'constant' (out-of-bounds taps are flagged) or 'nearest'
      (indices clamp to the edge)
    lead: number of leading batch dimensions of `coords`

  Returns:
    (taps, nan_coords): taps is a list of (flat index [*lead, *out],
    weight, out-of-bounds mask or None), in the reference's order (the
    first axis outermost).
  """
  if mode not in ('constant', 'nearest'):
    raise ValueError(f'Unknown mode {mode!r}')
  kernel_taps(method)
  dim = len(spatial)
  coords = coords.to(float_type(coords))
  nan_coords = torch.isnan(coords).any(dim=lead)
  coords = torch.nan_to_num(coords)
  if method == 'nearest':
    base = torch.round(coords)
    frac = torch.zeros_like(coords)
  else:
    base = torch.floor(coords)
    frac = coords - base
  base = base.to(torch.int64).unbind(dim=lead)
  per_axis = [_tap_weights(f, method) for f in frac.unbind(dim=lead)]
  taps = []
  for corner in itertools.product(*[range(len(o)) for o, _ in per_axis]):
    weight, lin, oob = None, None, None
    for a, j in enumerate(corner):
      n = int(spatial[a])
      offsets, weights = per_axis[a]
      raw = base[a] + offsets[j]
      weight = weights[j] if weight is None else weight * weights[j]
      idx = raw.clamp(0, n - 1)
      lin = idx if lin is None else lin * n + idx
      if mode == 'constant':
        bad = (raw < 0) | (raw >= n)
        oob = bad if oob is None else oob | bad
    taps.append((lin, weight, oob))
  return taps, nan_coords


def apply_taps(flat: torch.Tensor, taps, nan_coords: torch.Tensor,
               cval: float = float('nan'), lead: int = 0) -> torch.Tensor:
  """Interpolation from precomputed taps.

  `flat` is [*lead, *channels, N] (the grid flattened; leading dimensions
  match the taps' batch, channels share its coordinates). Zero-weight
  taps never poison the output, and NaN coordinates give NaN.
  """
  out_shape = nan_coords.shape
  chan = flat.shape[lead:-1]
  out = None
  for lin, weight, oob in taps:
    idx = lin.reshape(*lin.shape[:lead], *([1] * len(chan)), -1)
    idx = idx.expand(*flat.shape[:-1], idx.shape[-1])
    g = torch.gather(flat, -1, idx)
    g = g.reshape(*out_shape[:lead], *chan, *out_shape[lead:])
    w = weight.reshape(*out_shape[:lead], *([1] * len(chan)),
                       *out_shape[lead:])
    if oob is not None:
      o = oob.reshape(w.shape)
      g = torch.where(o, torch.full_like(g, cval), g)
    contrib = w * g
    contrib = torch.where(w == 0.0, torch.zeros_like(contrib), contrib)
    out = contrib if out is None else out + contrib
  nan = nan_coords.reshape(*out_shape[:lead], *([1] * len(chan)),
                           *out_shape[lead:])
  return torch.where(nan, torch.full_like(out, float('nan')), out)


def sample(image: torch.Tensor, coords: torch.Tensor, method: str = 'linear',
           mode: str = 'constant', cval: float = float('nan')) -> torch.Tensor:
  """Samples `image` [d0, d1, ...] at fractional `coords` [dim, *out].

  The coordinates are in image index space, ordered like the image axes.
  method 'nearest' | 'linear' | 'cubic' | 'lanczos'; mode 'constant':
  out-of-bounds taps read `cval`; mode 'nearest': indices clamp to the
  edge. Zero-weight taps never poison the output, and NaN coordinates
  always give NaN. float64 inputs are sampled in float64, everything
  else in float32. Returns [*out].
  """
  dim = coords.shape[0]
  if dim != image.ndim:
    raise ValueError(f'coords dim {dim} != image rank {image.ndim}')
  taps, nan_coords = method_taps(coords, image.shape, method, mode)
  flat = image.to(float_type(image)).reshape(-1)
  return apply_taps(flat, taps, nan_coords, cval)


def sample_batched(image: torch.Tensor, coords: torch.Tensor,
                   method: str = 'linear', mode: str = 'constant',
                   cval: float = float('nan')) -> torch.Tensor:
  """Samples 2d images [..., h, w], each at its own (y, x) coords
  [..., 2, *out] (the leading batch dimensions of both match), as the
  reference's `sample` vmapped over them."""
  lead = image.ndim - 2
  if coords.shape[:lead] != image.shape[:lead] or coords.shape[lead] != 2:
    raise ValueError('[..., h, w] images and [..., 2, ...] coords expected')
  taps, nan_coords = method_taps(coords, image.shape[lead:], method, mode,
                                 lead)
  flat = image.to(float_type(image)).reshape(*image.shape[:lead], -1)
  return apply_taps(flat, taps, nan_coords, cval, lead)


def sample_channels(image: torch.Tensor, coords: torch.Tensor,
                    method: str = 'linear', mode: str = 'constant',
                    cval: float = float('nan')) -> torch.Tensor:
  """Samples a [c, *spatial] array at [dim, *out] coords -> [c, *out]."""
  dim = coords.shape[0]
  if image.ndim != dim + 1:
    raise ValueError(f'coords dim {dim} != image rank {image.ndim - 1}')
  taps, nan_coords = method_taps(coords, image.shape[1:], method, mode)
  flat = image.to(float_type(image)).reshape(image.shape[0], -1)
  return apply_taps(flat, taps, nan_coords, cval)


def map_coordinates(image: torch.Tensor, coords, order: int = 1,
                    mode: str = 'constant',
                    cval: float = float('nan')) -> torch.Tensor:
  """scipy.ndimage.map_coordinates-compatible `sample`: order 0
  (nearest), 1 (linear) or 3 (cubic); `coords` a [dim, *out] tensor or a
  sequence of `dim` coordinate tensors."""
  method = {0: 'nearest', 1: 'linear', 3: 'cubic'}.get(order)
  if method is None:
    raise ValueError(f'Unsupported interpolation order: {order}')
  if not isinstance(coords, torch.Tensor):
    coords = torch.stack([torch.as_tensor(c) for c in coords])
  return sample(image, coords, method=method, mode=mode, cval=cval)


def grid_sample_linear(values: torch.Tensor, coords,
                       extrapolate: bool = True) -> torch.Tensor:
  """Bi/trilinear sampling of a grid with linear edge-cell extrapolation.

  Args:
    values: [d0, d1(, d2)] grid values
    coords: [dim, *out] query coordinates in grid index space, or a
      sequence of `dim` tensors broadcastable to one output shape (a
      separable query grid)
    extrapolate: if False, out-of-range queries clamp to the edge value

  Returns:
    [*out] sampled values
  """
  values = values.to(torch.float32)
  dim = values.ndim
  coords = [c.to(torch.float32) for c in coords]
  if len(coords) != dim:
    raise ValueError(f'{dim}-d grid needs {dim} coordinate planes')
  shape = values.shape
  if not extrapolate:
    coords = [torch.clamp(coords[a], 0.0, shape[a] - 1.0)
              for a in range(dim)]
  base = [torch.clamp(torch.floor(coords[a]).to(torch.int64), 0,
                      shape[a] - 2) for a in range(dim)]
  frac = [coords[a] - base[a].to(torch.float32) for a in range(dim)]
  out = None
  for corner in range(2 ** dim):
    idx = []
    wgt = None
    for axis in range(dim):
      hi = bool(corner & (1 << axis))
      idx.append(base[axis] + 1 if hi else base[axis])
      w = frac[axis] if hi else 1.0 - frac[axis]
      wgt = w if wgt is None else wgt * w
    term = wgt * values[tuple(idx)]
    out = term if out is None else out + term
  return out


def upsample_map_linear(values: torch.Tensor, scale: int,
                        phase: tuple[int, int],
                        out_shape: tuple[int, int]) -> torch.Tensor:
  """Dense bilinear upsampling of a regular grid by an integer factor.

  Output pixel p samples grid coordinate (p + phase) / scale, with linear
  extrapolation past the last node (same as `grid_sample_linear`).

  Args:
    values: [c, my, mx] grid values
    scale: grid spacing in output pixels
    phase: (py, px) non-negative integer offsets
    out_shape: (oy, ox)

  Returns:
    [c, oy, ox] densified field
  """
  oy, ox = out_shape
  py, px = phase
  if py < 0 or px < 0:
    raise ValueError('phases must be non-negative (shift the output box)')
  values = values.to(torch.float32)

  def extend(v, axis, needed):
    n = v.shape[axis]
    hi = needed - n + 1  # +1: the interpolation uses base and base+1
    if hi <= 0:
      return v
    last = v.narrow(axis, n - 1, 1)
    grad = last - v.narrow(axis, n - 2, 1)
    return torch.cat([v] + [last + (k + 1) * grad for k in range(hi)],
                     dim=axis)

  v = extend(values, 1, (oy - 1 + py) // scale + 1)
  v = extend(v, 2, (ox - 1 + px) // scale + 1)
  dev = values.device
  r0 = torch.repeat_interleave(v, scale, dim=1)[:, py:py + oy]
  r1 = torch.repeat_interleave(v[:, 1:], scale, dim=1)[:, py:py + oy]
  fy = ((torch.arange(oy, dtype=torch.float32, device=dev) + py) % scale
        / scale)[None, :, None]
  a = (1.0 - fy) * r0 + fy * r1
  c0 = torch.repeat_interleave(a, scale, dim=2)[:, :, px:px + ox]
  c1 = torch.repeat_interleave(a[:, :, 1:], scale, dim=2)[:, :, px:px + ox]
  fx = ((torch.arange(ox, dtype=torch.float32, device=dev) + px) % scale
        / scale)[None, None, :]
  return (1.0 - fx) * c0 + fx * c1
