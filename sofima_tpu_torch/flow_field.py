"""Dense flow estimation on the alignment and stitching paths.

Twin of sofima_tpu/flow_field.py. Ported:
  * the peak contract of `_batched_peaks`, 2d and 3d
    (ops.cuda_flow.batched_peaks);
  * `dense_flow_field`, every branch:
      - circular, 2d square patches: kernel K1
        (ops.cuda_flow.dense_flow_peaks) and, with masks, K5
        (ops.cuda_flow.masked_dense_flow_peaks, masked Padfield NCC);
      - circular, 2d rectangular patches: the strip path
        `_dense_flow_strips` (stride divides the patch) on kernel K6
        (ops.cuda_flow.flow_peaks) or, with masks, the batch-rule
        Padfield twin `_masked_xcorr_circular`;
      - circular, 3d: the strip path `_dense_flow_strips_3d`
        (patch-periodic FFT correlation, torch.fft as the reference
        leaves it to XLA's FFT, the masked Padfield twin
        `_masked_xcorr_circular_fft`, then the peaks);
      - circular, any other geometry (2d or 3d): the start list of the
        whole grid (`_dense_flow_starts`), each batch through the same
        correlations;
      - `circular=False` (the default): the start list with the linear
        Padfield NCC of `batched_xcorr_peaks`, pre patches centred on
        the post patches (`post_patch_size`), as the reference pads them;
  * `coarse_to_fine_flow`: the coarse pass (K1, or K5 with masks) or a
    warm-start `prior`, the robustified prior, and then
      - unmasked, the targeted fine pass: `rint(-coarse)` window offsets
        clipped to `max_displacement` (the `overflow` flag), the fine
        crop and K2 with `peak_crop`;
      - masked, the integer-shift transport of `post` and its mask (K4 in
        'nearest' mode), the fine masked pass (K5) and the add-back of
        the rounded shift (`overflow` from the transport's plan);
  * `JAXMaskedXCorrWithStatsCalculator`: its dense branch (circular
    modes, no targeting fields) and, in 2d and 3d, its padfield mode
    (`batched_xcorr_peaks`: the linear Padfield NCC of `masked_xcorr` on
    torch.fft, as the reference computes it outside any Pallas kernel,
    with its batch rules, targeting fields, the pre-patch clamp and its
    compensation, `post_patch_size` and `progress_fn` streaming);
  * `masked_xcorr` (the full linear Padfield NCC on torch.fft, padded to
    `next_fast_len`, batch or per-item thresholds).
"""

from __future__ import annotations

import collections.abc

import numpy as np
import torch

from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import cuda_flow
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import interp as interp_ops
from sofima_tpu_torch.ops import shift_warp
from sofima_tpu_torch.utils import geom

Radius = cuda_flow.Radius

_batched_peaks = cuda_flow.batched_peaks


def next_fast_len(n: int) -> int:
  """Smallest 5-smooth (2^a 3^b 5^c) integer >= n."""
  if n <= 2:
    return max(n, 1)
  best = 1 << (n - 1).bit_length()  # power of two upper bound
  p5 = 1
  while p5 < best:
    p35 = p5
    while p35 < best:
      # Smallest power of two lifting p35 above n.
      q = -(-n // p35)
      p2 = 1 << max(q - 1, 0).bit_length()
      best = min(best, p2 * p35)
      p35 *= 3
    p5 *= 5
  return best


def masked_xcorr(prev, curr, prev_mask=None, curr_mask=None,
                 use_jax: bool = True, dim: int = 2,
                 per_item: bool = False) -> torch.Tensor:
  """Normalized cross-correlation of two (optionally masked) images.

  Twin of flow_field.masked_xcorr, with its parameters: the full linear
  correlation over the last `dim` axes (leading axes are batch), FFTs
  padded to `next_fast_len` (torch.fft, as the reference leaves them to
  XLA). `use_jax` is accepted for the reference's calls and unused: the
  result is always a tensor.
  Masks mark INVALID pixels (True = ignore); with masks the result is
  the Padfield masked NCC in [-1, 1], zeroed where the denominator is
  below 1e3 eps x its maximum or the valid overlap below 0.3 x its
  maximum. Those maxima are taken over the whole batch, or per item with
  `per_item=True` (then a batched call equals a sequence of batch-of-1
  calls). Inputs may be numpy or tensors; the result is a tensor on
  `prev`'s device.
  """
  prev = torch.as_tensor(prev).to(torch.float32)
  curr = torch.as_tensor(curr, device=prev.device).to(torch.float32)
  axes = tuple(range(-dim, 0))
  full_shape = tuple(int(a + b - 1) for a, b in
                     zip(prev.shape[-dim:], curr.shape[-dim:]))
  fft_shape = tuple(next_fast_len(n) for n in full_shape)
  out = (Ellipsis,) + tuple(slice(0, n) for n in full_shape)

  def as_mask(m):
    return None if m is None else torch.as_tensor(m, device=prev.device).to(
        torch.bool)

  prev_mask, curr_mask = as_mask(prev_mask), as_mask(curr_mask)
  if prev_mask is not None:
    prev = torch.where(prev_mask, torch.zeros_like(prev), prev)
  if curr_mask is not None:
    curr = torch.where(curr_mask, torch.zeros_like(curr), curr)
  curr = torch.flip(curr, axes)

  def fft(v):
    return torch.fft.rfftn(v.to(torch.float32), s=fft_shape, dim=axes)

  def ifft(v):
    return torch.fft.irfftn(v, s=fft_shape, dim=axes)

  f_prev, f_curr = fft(prev), fft(curr)
  xcorr = ifft(f_prev * f_curr)
  if prev_mask is None and curr_mask is None:
    return xcorr[out]

  valid_prev = (torch.ones_like(prev, dtype=torch.bool) if prev_mask is None
                else ~prev_mask)
  valid_curr = (torch.ones_like(curr, dtype=torch.bool) if curr_mask is None
                else torch.flip(~curr_mask, axes))
  f_vp, f_vc = fft(valid_prev), fft(valid_curr)
  eps = float(np.finfo(np.float32).eps)
  overlap = torch.clamp(torch.round(ifft(f_vc * f_vp)), min=eps)
  inv_overlap = 1.0 / overlap
  # Local (masked-region) sums of each image under the other's mask.
  sum_prev = ifft(f_vc * f_prev)
  sum_curr = ifft(f_vp * f_curr)
  numerator = xcorr - sum_prev * sum_curr * inv_overlap
  var_prev = torch.clamp(ifft(f_vc * fft(prev * prev))
                         - sum_prev * sum_prev * inv_overlap, min=0.0)
  var_curr = torch.clamp(ifft(f_vp * fft(curr * curr))
                         - sum_curr * sum_curr * inv_overlap, min=0.0)
  denom = torch.sqrt(var_prev * var_curr)[out]
  numerator = numerator[out]
  overlap = overlap[out]

  def amax(v):
    if per_item:
      return torch.amax(v, dim=axes, keepdim=True)
    return torch.amax(v)

  tol = 1e3 * eps * amax(torch.abs(denom))
  ok = denom > tol
  res = torch.where(ok, numerator / torch.where(ok, denom,
                                                torch.ones_like(denom)),
                    torch.zeros_like(denom))
  res = torch.clamp(res, -1.0, 1.0)
  res = torch.where(overlap < 0.3 * amax(overlap), torch.zeros_like(res), res)
  return res


def _valid_mean(batch: torch.Tensor, valid, axes) -> torch.Tensor:
  """Per-patch mean over the valid pixels (all of them for None)."""
  if valid is None:
    return batch.mean(dim=axes, keepdim=True)
  count = torch.clamp(valid.sum(dim=axes, keepdim=True), min=1)
  return (torch.where(valid, batch, torch.zeros_like(batch))
          .sum(dim=axes, keepdim=True) / count)


def _strip_patches_3d(slab: torch.Tensor, grid_y: int, grid_x: int,
                      patch, step) -> torch.Tensor:
  """[pz, strip_h, strip_w] slab -> [gy * gx, pz, py, px] patch batch.

  The slab's depth is the patch depth (one grid z-row); patches are
  row-major over (gy, gx), as the reference's gather-free assembly
  orders them.
  """
  _, py, px = patch
  _, sy, sx = step
  p = slab.unfold(1, py, sy).unfold(2, px, sx)  # [pz, gy, gx, py, px]
  assert p.shape[1:3] == (grid_y, grid_x)
  return p.permute(1, 2, 0, 3, 4).reshape(grid_y * grid_x, *patch)


def _masked_xcorr_circular_fft(pre_b: torch.Tensor, post_b: torch.Tensor,
                               pre_valid: torch.Tensor,
                               post_valid: torch.Tensor,
                               patch_size) -> torch.Tensor:
  """Dim-generic circular masked NCC (Padfield) via FFTs.

  Twin of flow_field._masked_xcorr_circular_fft: the six Padfield terms as
  circular correlations on the patch-periodic torus (torch.fft), with the
  reference's batch rules: the denominator tolerance and the 0.3 x max
  overlap cut are taken over the whole batch (one grid z-row).
  """
  axes = tuple(range(-len(patch_size), 0))
  return cuda_flow.padfield_ncc(
      torch.where(pre_valid, pre_b, torch.zeros_like(pre_b)),
      torch.where(post_valid, post_b, torch.zeros_like(post_b)),
      pre_valid, post_valid, lambda x: torch.fft.rfftn(x, dim=axes),
      lambda a, b: torch.fft.irfftn(a * torch.conj(b), s=tuple(patch_size),
                                    dim=axes),
      per_patch=False)


def _circular_peaks_fft(a: torch.Tensor, b: torch.Tensor, va, vb,
                        mean: float | None, min_distance: Radius,
                        threshold_rel: float,
                        peak_radius: Radius) -> torch.Tensor:
  """Peak rows of one batch of patch pairs on the patch-periodic torus.

  Dim-generic (torch.fft): the mean over valid voxels (or `mean`)
  removed, the circular cross-correlation irfftn(F(pre) conj(F(post))),
  or with masks (`va` / `vb` True where valid, None: all valid) the
  batch-rule Padfield NCC `_masked_xcorr_circular_fft`, the zero shift
  rolled to the patch centre, and the peak statistics.
  """
  patch_size = tuple(a.shape[1:])
  axes = tuple(range(-len(patch_size), 0))
  if mean is None:
    a = a - _valid_mean(a, va, axes)
    b = b - _valid_mean(b, vb, axes)
  else:
    a, b = a - mean, b - mean
  if va is not None or vb is not None:
    va = torch.ones_like(a, dtype=torch.bool) if va is None else va
    vb = torch.ones_like(b, dtype=torch.bool) if vb is None else vb
    corr = _masked_xcorr_circular_fft(a, b, va, vb, patch_size)
  else:
    fa = torch.fft.rfftn(a, dim=axes)
    fb = torch.fft.rfftn(b, dim=axes)
    corr = torch.fft.irfftn(fa * torch.conj(fb), s=patch_size, dim=axes)
  center = tuple(p // 2 for p in patch_size)
  corr = torch.roll(corr, center, dims=axes)
  return _batched_peaks(corr, center, min_distance, threshold_rel,
                        peak_radius)


def _dense_flow_strips_3d(pre_image: torch.Tensor, post_image: torch.Tensor,
                          patch_size, step, mean: float | None,
                          min_distance: Radius, threshold_rel: float,
                          peak_radius: Radius, pre_mask=None,
                          post_mask=None) -> torch.Tensor:
  """Dense circular 3d flow over grid z-rows -> [5, gz, gy, gx].

  Per z-row: one [pz, strip_h, strip_w] slab of each image, its patches
  and their peaks (`_circular_peaks_fft`; masks True / > 0 where
  invalid).
  """
  pz, py, px = patch_size
  sz, sy, sx = step
  d, h, w = pre_image.shape
  gz = (d - (pz - sz)) // sz
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  strip_h = (gy - 1) * sy + py
  strip_w = (gx - 1) * sx + px
  pre_image = pre_image.to(torch.float32)
  post_image = post_image.to(torch.float32)
  rows = []
  for iz in range(gz):
    z0 = iz * sz

    def patches(img):
      return _strip_patches_3d(img[z0:z0 + pz, :strip_h, :strip_w], gy, gx,
                               patch_size, step)

    rows.append(_circular_peaks_fft(
        patches(pre_image), patches(post_image),
        _valid_patches(pre_mask, patches), _valid_patches(post_mask, patches),
        mean, min_distance, threshold_rel, peak_radius))
  out = torch.stack(rows).reshape(gz, gy, gx, 5)
  return out.permute(3, 0, 1, 2).contiguous()


def _strip_patches(strip: torch.Tensor, rows: int, grid_x: int, patch,
                   step) -> torch.Tensor:
  """[strip_h, strip_w] strip -> [rows * grid_x, py, px] patch batch,
  row-major over (row, gx), as the reference's gather-free assembly
  orders it."""
  py, px = patch
  sy, sx = step
  p = strip.unfold(0, py, sy).unfold(1, px, sx)  # [rows, gx, py, px]
  assert p.shape[:2] == (rows, grid_x)
  return p.reshape(rows * grid_x, py, px)


def _masked_xcorr_circular(pre_b: torch.Tensor, post_b: torch.Tensor,
                           pre_valid: torch.Tensor,
                           post_valid: torch.Tensor) -> torch.Tensor:
  """Circular masked NCC (Padfield) of 2d [b, p1, p2] batches.

  Twin of flow_field._masked_xcorr_circular: the six Padfield terms on
  DFT matmuls, with the reference's batch rules (the denominator
  tolerance and the 0.3 x max overlap cut over the whole batch).
  """
  p1, p2 = pre_b.shape[-2:]
  zero = torch.zeros_like(pre_b)
  return cuda_flow.padfield_ncc(
      torch.where(pre_valid, pre_b, zero),
      torch.where(post_valid, post_b, zero), pre_valid, post_valid,
      cuda_flow._rdft2,
      lambda a, b: cuda_flow._irdft2_of_product(a, b, p1, p2),
      per_patch=False)


def _circular_peaks(pre_b: torch.Tensor, post_b: torch.Tensor, pre_valid,
                    post_valid, mean, min_distance: Radius,
                    threshold_rel: float, peak_radius: Radius) -> torch.Tensor:
  """Peak rows [b, dim + 2] of one dispatch batch of patch pairs.

  2d unmasked: kernel K6 (mean removal, circular correlation, peaks).
  2d masked (`*_valid` True where a pixel is valid, None: all valid):
  the mean over valid pixels, the batch-rule Padfield NCC
  `_masked_xcorr_circular`, and the peak chain. 3d:
  `_circular_peaks_fft`.
  """
  if pre_b.ndim == 4:
    return _circular_peaks_fft(pre_b, post_b, pre_valid, post_valid, mean,
                               min_distance, threshold_rel, peak_radius)
  if pre_valid is None and post_valid is None:
    return cuda_flow.flow_peaks(pre_b, post_b, mean, min_distance,
                                threshold_rel, peak_radius)
  axes = (-2, -1)
  if mean is None:
    pre_b = pre_b - _valid_mean(pre_b, pre_valid, axes)
    post_b = post_b - _valid_mean(post_b, post_valid, axes)
  else:
    pre_b, post_b = pre_b - mean, post_b - mean
  ones = torch.ones_like(pre_b, dtype=torch.bool)
  corr = _masked_xcorr_circular(
      pre_b, post_b, ones if pre_valid is None else pre_valid,
      ones if post_valid is None else post_valid)
  p1, p2 = pre_b.shape[-2:]
  corr = torch.roll(corr, (p1 // 2, p2 // 2), dims=axes)
  return _batched_peaks(corr, (p1 // 2, p2 // 2), min_distance,
                        threshold_rel, peak_radius)


def _valid_patches(mask, cut):
  """Valid-pixel patches (True = valid) of a mask (True / > 0 = invalid)."""
  return None if mask is None else ~(cut(mask.to(torch.float32)) > 0)


def _dense_flow_strips(pre_image: torch.Tensor, post_image: torch.Tensor,
                       patch_size, step, mean: float | None,
                       min_distance: Radius, threshold_rel: float,
                       peak_radius: Radius, rows_per_step: int = 2,
                       pre_mask=None, post_mask=None) -> torch.Tensor:
  """Dense circular 2d flow over strips of grid rows -> [4, gy, gx].

  Twin of flow_field._dense_flow_strips (the stride divides the patch):
  each step cuts one strip of `rows_per_step` grid rows from both images
  (the last strip clamped to the image, its repeated rows overwritten
  by it), assembles its patches (`_strip_patches`) and measures their
  peaks (`_circular_peaks`: K6, or the masked Padfield NCC with the
  strip as the dispatch batch).
  """
  py, px = patch_size
  sy, sx = step
  gy = (pre_image.shape[0] - (py - sy)) // sy
  gx = (pre_image.shape[1] - (px - sx)) // sx
  strip_h = (rows_per_step - 1) * sy + py
  strip_w = (gx - 1) * sx + px
  pre_image = pre_image.to(torch.float32)
  post_image = post_image.to(torch.float32)
  out = torch.empty((gy, gx, 4), dtype=torch.float32,
                    device=pre_image.device)
  for step_i in range(-(-gy // rows_per_step)):
    r0 = min(step_i * rows_per_step, gy - rows_per_step)
    y0 = r0 * sy

    def patches(img):
      return _strip_patches(img[y0:y0 + strip_h, :strip_w], rows_per_step,
                            gx, patch_size, step)

    peaks = _circular_peaks(
        patches(pre_image), patches(post_image),
        _valid_patches(pre_mask, patches), _valid_patches(post_mask, patches),
        mean, min_distance, threshold_rel, peak_radius)
    out[r0:r0 + rows_per_step] = peaks.reshape(rows_per_step, gx, 4)
  return out.permute(2, 0, 1).contiguous()


def _dense_flow_starts(pre_image: torch.Tensor, post_image: torch.Tensor,
                       patch_size, post_patch_size, step, mean: float | None,
                       min_distance: Radius, threshold_rel: float,
                       peak_radius: Radius, batch_size: int, circular: bool,
                       pre_mask=None, post_mask=None) -> torch.Tensor:
  """Dense flow from the grid's start list -> [dim + 2, *grid].

  Twin of the start-list branch of flow_field.dense_flow_field (2d or
  3d; the geometries no strip path takes, and every `circular=False`
  run): post patches at the starts of the `post_patch_size` grid,
  row-major, pre patches at max(start - (patch - post_patch) // 2, 0)
  (no upper clamp and no compensation; the gather clamps each patch
  into its image as lax.dynamic_slice does), in dispatch batches of
  `batch_size` padded by repeating the last start. Each batch goes
  through `_circular_peaks` (equal patch sizes, masks allowed) or the
  linear Padfield chain of `batched_xcorr_peaks`.
  """
  grid = tuple((post_image.shape[a] - (p - s)) // s
               for a, (p, s) in enumerate(zip(post_patch_size, step)))
  n = int(np.prod(grid))
  batch_size = min(batch_size, n)
  padded = -(-n // batch_size) * batch_size
  dev = pre_image.device
  axes = [torch.arange(g, device=dev) * s for g, s in zip(grid, step)]
  starts = torch.stack(torch.meshgrid(*axes, indexing='ij'),
                       dim=-1).reshape(n, len(grid))
  starts = torch.cat([starts, starts[-1:].expand(padded - n, len(grid))])
  offset = torch.tensor([(p - q) // 2 for p, q in
                         zip(patch_size, post_patch_size)], device=dev)
  pre_starts = torch.clamp(starts - offset[None], min=0)
  pre_image = pre_image.to(torch.float32)
  post_image = post_image.to(torch.float32)
  kw = dict(min_distance=min_distance, threshold_rel=threshold_rel,
            peak_radius=peak_radius)
  rows = []
  for b0 in range(0, padded, batch_size):
    ps, qs = pre_starts[b0:b0 + batch_size], starts[b0:b0 + batch_size]
    if not circular:
      rows.append(batched_xcorr_peaks(
          pre_image, post_image, None, None, patch_size, ps, mean,
          post_patch_size=post_patch_size, post_starts=qs, **kw))
      continue

    def cut(img, sel):
      return _gather_patches(img, sel, patch_size)

    rows.append(_circular_peaks(
        cut(pre_image, ps), cut(post_image, qs),
        _valid_patches(pre_mask, lambda m: cut(m, ps)),
        _valid_patches(post_mask, lambda m: cut(m, qs)), mean, **kw))
  peaks = torch.cat(rows)[:n]
  return peaks.reshape(grid + (peaks.shape[-1],)).movedim(-1, 0).contiguous()


def dense_flow_field(pre_image: torch.Tensor, post_image: torch.Tensor,
                     patch_size, step, batch_size: int = 1024,
                     mean: float | None = None, min_distance: Radius = 2,
                     threshold_rel: float = 0.5, peak_radius: Radius = 5,
                     post_patch_size=None, circular: bool = False,
                     dft_matmul: bool = False, bf16: bool = False,
                     pre_mask=None, post_mask=None) -> torch.Tensor:
  """Flow over the full dense patch grid.

  The reference's parameters, order and defaults. `dft_matmul` and
  `bf16` pick the TPU's DFT-matmul transform and its bfloat16 inputs;
  they are accepted and ignored (the port correlates in float32).

  2d: [4, gy, gx] (x, y, sharpness, ratio); 3d: [5, gz, gy, gx] (x, y,
  z, sharpness, ratio), on the grid of `post_patch_size` (default
  `patch_size`) at `step` over `post_image`. With `circular=True`
  (equal patch sizes): square 2d patches on kernel K1, or K5 when a mask
  is given; rectangular 2d patches on the strip path (`batch_size` / gx
  grid rows per strip, as the reference) when the stride divides the
  patch, 3d likewise on the 3d strip path; other geometries on the
  start list in batches of `batch_size`. With `circular=False` (the
  default): the linear Padfield correlation over the start list.
  Masks (True or > 0 where a pixel is invalid) need `circular=True`;
  both ValueErrors are the reference's.
  """
  del dft_matmul, bf16
  ndim = pre_image.ndim
  if ndim not in (2, 3):
    raise ValueError('2d or 3d images expected')
  patch_size, step = tuple(patch_size), tuple(step)
  post_patch_size = (patch_size if post_patch_size is None
                     else tuple(post_patch_size))
  kw = dict(mean=mean, min_distance=min_distance,
            threshold_rel=threshold_rel, peak_radius=peak_radius)
  masked = pre_mask is not None or post_mask is not None
  divides = all(p % s == 0 for p, s in zip(patch_size, step))
  if (circular and post_patch_size == patch_size
      and tuple(pre_image.shape) == tuple(post_image.shape)):
    if ndim == 3 and divides:
      return _dense_flow_strips_3d(pre_image, post_image, patch_size, step,
                                   pre_mask=pre_mask, post_mask=post_mask,
                                   **kw)
    if ndim == 2 and patch_size[0] == patch_size[1]:
      if masked:
        valid = [None if m is None else ~(m > 0)
                 for m in (pre_mask, post_mask)]
        return cuda_flow.masked_dense_flow_peaks(
            pre_image, post_image, valid[0], valid[1], patch_size, step, **kw)
      return cuda_flow.dense_flow_peaks(pre_image, post_image, patch_size,
                                        step, **kw)
    if ndim == 2 and divides:
      gy = (pre_image.shape[0] - (patch_size[0] - step[0])) // step[0]
      gx = (pre_image.shape[1] - (patch_size[1] - step[1])) // step[1]
      rows = max(1, min(gy, int(round(batch_size / max(gx, 1))) or 1))
      return _dense_flow_strips(pre_image, post_image, patch_size, step,
                                rows_per_step=rows, pre_mask=pre_mask,
                                post_mask=post_mask, **kw)
  if circular and post_patch_size != patch_size:
    raise ValueError('circular mode requires equal pre/post patch sizes')
  if masked and not circular:
    raise ValueError('dense masked mode requires circular=True')
  return _dense_flow_starts(pre_image, post_image, patch_size,
                            post_patch_size, step, batch_size=batch_size,
                            circular=circular, pre_mask=pre_mask,
                            post_mask=post_mask, **kw)


def _nanmedian(c: torch.Tensor) -> torch.Tensor:
  """jnp.nanmedian: linear interpolation between the middle values."""
  vals = c[~torch.isnan(c)]
  n = vals.numel()
  if n == 0:
    return torch.tensor(float('nan'), device=c.device)
  srt = torch.sort(vals).values
  q = 0.5 * (n - 1)
  lo, hi = int(q // 1), int(-(-q // 1))
  hw = q - lo
  return srt[lo] * (1.0 - hw) + srt[hi] * hw


def coarse_to_fine_flow(pre_image: torch.Tensor, post_image: torch.Tensor,
                        patch_size=(160, 160), step=(40, 40),
                        coarse_step=None, fine_patch=None,
                        batch_size: int = 256, bf16: bool = True,
                        max_displacement: int = 96, residual: int = 8,
                        pre_mask=None, post_mask=None, min_distance: Radius = 2,
                        threshold_rel: float = 0.5, peak_radius: Radius = 5,
                        return_overflow: bool = False,
                        peak_crop: int | None = None, prior=None,
                        prior_step=None, prior_origin=None):
  """Coarse-to-fine dense flow on the `dense_flow_field(patch_size, step)`
  grid -> [4, gy, gx] (and the overflow flag with `return_overflow`).

  1. COARSE: full patches on a `coarse_step` grid (K1; K5 with masks),
     or a warm-start `prior` in its place;
  2. the coarse field is NaN-filled with its median, 3x3-median filtered
     and clipped to +-max_displacement;
  3. unmasked, the TARGETED fine pass: `fine_patch` patches at `step` on
     the image cropped so their centers land on the target grid; each
     rows x group block of patches correlates a post window shifted by
     rint(-coarse) at the block center (K2; `peak_crop` restricts the
     peak search); flow = fine peak - window shift. `overflow` flags a
     coarse prior beyond `max_displacement`;
  4. masked (masks True where a pixel is invalid), the integer-shift
     transport: `post` and its mask move by the rounded dense prior (K4,
     'nearest', an exact gather), the fine masked pass (K5) measures the
     residual on the cropped pair, and the same rounded shift is added
     back at the node centers. `overflow` flags the transport's
     residual-lattice envelope (`residual`, reference's static plan).

  `prior`: [2+, ny, nx] (dx, dy) flow on a grid of spacing `prior_step`
  (default `coarse_step`) whose node (0, 0) sits at pixel
  `prior_origin` (default: the patch center). On the masked path the
  origin must not exceed the step (ValueError).

  `batch_size` and `bf16` take the reference's places and defaults and
  are unused: the kernels size their own launches, and the port
  correlates in float32 (as `StackAlignConfig.bf16`).
  """
  py, px = patch_size
  sy, sx = step
  if coarse_step is None:
    coarse_step = tuple(patch_size)
  if fine_patch is None:
    fine_patch = (py // 2, px // 2)
  csy, csx = coarse_step
  fy, fx = fine_patch
  if csy != csx:
    raise ValueError('coarse_step must be isotropic')
  if fy > py or fx > px:
    raise ValueError('fine_patch must not exceed patch_size')
  crop_y = (py // 2 - fy // 2) % sy
  crop_x = (px // 2 - fx // 2) % sx
  h, w = pre_image.shape
  pre_image = pre_image.to(torch.float32)
  post_image = post_image.to(torch.float32)

  if prior is not None:
    cx, cy = prior[0], prior[1]
    csy, csx = prior_step if prior_step is not None else coarse_step
    if csy != csx:
      raise ValueError('prior_step must be isotropic')
  else:
    coarse = dense_flow_field(pre_image, post_image, patch_size, coarse_step,
                              min_distance=min_distance,
                              threshold_rel=threshold_rel,
                              peak_radius=peak_radius, circular=True,
                              pre_mask=pre_mask, post_mask=post_mask)
    cx, cy = coarse[0], coarse[1]

  def robustify(c):
    med = torch.nan_to_num(_nanmedian(c))
    c = torch.where(torch.isfinite(c), c, med)
    n0, n1 = c.shape
    yi = torch.arange(n0, device=c.device)
    xi = torch.arange(n1, device=c.device)
    stacked = torch.stack([
        c[(yi + i - 1).clamp(0, n0 - 1)][:, (xi + j - 1).clamp(0, n1 - 1)]
        for i in range(3) for j in range(3)])
    c = torch.sort(stacked, dim=0).values[4]
    return torch.clamp(c, -max_displacement, max_displacement)

  cx = robustify(cx.to(torch.float32))
  cy = robustify(cy.to(torch.float32))
  if prior is not None and prior_origin is not None:
    cy0, cx0 = prior_origin
  else:
    cy0, cx0 = py // 2, px // 2  # first node center

  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  k0y = (py // 2 - fy // 2 - crop_y) // sy
  k0x = (px // 2 - fx // 2 - crop_x) // sx
  hc, wc = h - crop_y, w - crop_x

  def fine_crop(img):
    if img is None or not (crop_y or crop_x):
      return img
    return img[crop_y:, crop_x:]

  def result(flow, overflow):
    return (flow, overflow) if return_overflow else flow

  if pre_mask is None and post_mask is None:
    gy_f = (hc - (fine_patch[0] - sy)) // sy
    rows_f = 4 if ((3 * sy + fine_patch[0]) % 8 == 0 and gy_f >= 4) else None
    geo = cuda_flow.targeted_geometry((hc, wc), fine_patch, step,
                                      rows=rows_f)
    dev = pre_image.device
    ctr_y = ((torch.arange(geo['nrsteps'], dtype=torch.float32, device=dev)
              * (geo['rows'] * sy) + geo['win_r'] / 2.0 + crop_y - cy0) / csy)
    ctr_x = ((torch.arange(geo['ngroups'], dtype=torch.float32, device=dev)
              * (geo['group'] * sx) + geo['win_c'] / 2.0 + crop_x - cx0)
             / csx)
    nr, ng = geo['nrsteps'], geo['ngroups']
    mesh2 = torch.stack([ctr_y[:, None].expand(nr, ng),
                         ctr_x[None, :].expand(nr, ng)])
    fx_c = interp_ops.grid_sample_linear(cx, mesh2)
    fy_c = interp_ops.grid_sample_linear(cy, mesh2)
    offs_raw = torch.stack([torch.round(-fy_c), torch.round(-fx_c)], dim=-1)
    offs = torch.clamp(offs_raw, -max_displacement,
                       max_displacement).to(torch.int32)
    overflow = torch.any(torch.abs(offs_raw) > max_displacement)
    fine = cuda_flow.dense_flow_peaks_targeted(
        fine_crop(pre_image), fine_crop(post_image), offs, tuple(fine_patch),
        tuple(step), max_offset=max_displacement, min_distance=min_distance,
        threshold_rel=threshold_rel, peak_radius=peak_radius,
        peak_crop=peak_crop, rows=rows_f)
    off = torch.repeat_interleave(offs.to(torch.float32), geo['rows'], dim=0)
    off = torch.repeat_interleave(off, geo['group'], dim=1)
    off = off[:geo['gy'], :geo['gx']]
    total = torch.stack([fine[0] - off[..., 1], fine[1] - off[..., 0],
                         fine[2], fine[3]])
    return result(total[:, k0y:k0y + gy, k0x:k0x + gx], overflow)

  # MASKED: transport post toward pre (post_w(q) = post(q - f)) by the
  # rounded dense prior, then the fine masked pass on the resampled pair.
  if cy0 > csy or cx0 > csx:
    # The one-node extrapolation below covers a phase deficit of at most
    # one prior cell; an earlier origin would need a negative phase.
    raise ValueError('masked coarse_to_fine requires the coarse/prior '
                     'grid origin to be <= its step '
                     f'(origin ({cy0}, {cx0}), step ({csy}, {csx}))')
  g = torch.stack([-cy, -cx])  # (y, x) displacement at the prior's nodes

  def prepend(v, axis):
    first, second = v.narrow(axis, 0, 1), v.narrow(axis, 1, 1)
    return torch.cat([2.0 * first - second, v], dim=axis)

  # Integer shifts: the nearest gather below copies whole pixels, and the
  # add-back reads the same rounded field, so rounding cancels exactly.
  dense_g = torch.round(interp_ops.upsample_map_linear(
      prepend(prepend(g, 1), 2), csy, (csy - cy0, csx - cx0), (h, w)))
  dev = pre_image.device
  yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
  xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
  coords = torch.stack([yy + dense_g[0], xx + dense_g[1]])[None].contiguous()
  node_y = cy0 + np.arange(cy.shape[0], dtype=np.float64) * csy
  node_x = cx0 + np.arange(cx.shape[1], dtype=np.float64) * csx
  md = -(-max_displacement // 64) * 64
  plan = shift_warp.tiled_plan_device(
      g[0][None], g[1][None], node_y, node_x, (h, w),
      (-residual, residual, -residual, residual), (-md, md, -md, md))

  def warp_nearest(plane):
    return cuda_warp.shift_warp(plane.to(torch.float32)[None].contiguous(),
                                coords, 'nearest')[0]

  post_w = warp_nearest(post_image)
  # Pixels pulled from outside the image read 0 (valid).
  post_mask_w = None if post_mask is None else warp_nearest(post_mask) > 0.5
  fine = dense_flow_field(
      fine_crop(pre_image), fine_crop(post_w), fine_patch, step,
      min_distance=min_distance, threshold_rel=threshold_rel,
      peak_radius=peak_radius, circular=True, pre_mask=fine_crop(pre_mask),
      post_mask=fine_crop(post_mask_w))
  fine_c = fine[:, k0y:k0y + gy, k0x:k0x + gx]
  # The applied (rounded) shift at each node center (py//2 + i sy, ...).
  gi_c = dense_g[:, py // 2::sy, px // 2::sx][:, :gy, :gx]
  total = torch.stack([fine_c[0] - gi_c[1], fine_c[1] - gi_c[0], fine_c[2],
                       fine_c[3]])
  return result(total, plan['overflow'])


def _tuple(v, ndim: int):
  if v is None:
    return None
  if isinstance(v, collections.abc.Sequence):
    return tuple(int(i) for i in v)
  return (int(v),) * ndim


def _gather_patches(image: torch.Tensor, starts: torch.Tensor,
                    size) -> torch.Tensor:
  """[b, *size] patches of an image at [b, dim] starts, each start
  clamped into the image as lax.dynamic_slice clamps it."""
  dim = len(size)
  idx = []
  for a, n in enumerate(size):
    s0 = starts[:, a].clamp(0, max(image.shape[a] - n, 0))
    ar = torch.arange(n, device=image.device)
    idx.append(s0.reshape((-1,) + (1,) * dim)
               + ar.reshape((1,) * (a + 1) + (n,) + (1,) * (dim - a - 1)))
  return image[tuple(idx)]


def batched_xcorr_peaks(pre_image: torch.Tensor, post_image: torch.Tensor,
                        pre_mask, post_mask, patch_size, starts: torch.Tensor,
                        mean: float | None, min_distance: Radius = 2,
                        threshold_rel: float = 0.5, peak_radius: Radius = 5,
                        post_patch_size=None,
                        post_starts: torch.Tensor | None = None
                        ) -> torch.Tensor:
  """Gather -> linear (Padfield) xcorr -> peak rows [b, dim + 2], one batch.

  Twin of flow_field.batched_xcorr_peaks, 2d or 3d: pre patches of
  `patch_size` at `starts` and post patches of `post_patch_size` at
  `post_starts` ([b, dim] ([z,] y, x)), the mean over each patch's
  unmasked pixels (or the constant `mean`) removed, `masked_xcorr` over
  the batch (masks True where invalid; with masks its thresholds are the
  batch's), and the peaks around the linear correlation's zero shift
  (patch + post_patch) // 2 - 1.
  """
  patch_size = tuple(patch_size)
  post_patch_size = (patch_size if post_patch_size is None
                     else tuple(post_patch_size))
  if post_starts is None:
    post_starts = starts
  dim = len(patch_size)
  pre_b = _gather_patches(pre_image, starts, patch_size)
  post_b = _gather_patches(post_image, post_starts, post_patch_size)
  pre_m = None if pre_mask is None else _gather_patches(
      pre_mask, starts, patch_size).to(torch.bool)
  post_m = None if post_mask is None else _gather_patches(
      post_mask, post_starts, post_patch_size).to(torch.bool)

  if mean is None:
    axes = tuple(range(-dim, 0))
    pre_b = pre_b - _valid_mean(pre_b, None if pre_m is None else ~pre_m,
                                axes)
    post_b = post_b - _valid_mean(post_b, None if post_m is None else ~post_m,
                                  axes)
  else:
    pre_b, post_b = pre_b - mean, post_b - mean
  center = tuple((np.array(patch_size) + np.array(post_patch_size)) // 2 - 1)
  xc = masked_xcorr(pre_b, post_b, pre_m, post_m, dim=dim)
  return _batched_peaks(xc, center, min_distance, threshold_rel, peak_radius)


def _silent_fn(x):
  """The calculator's default `progress_fn`: the batches, unreported."""
  yield from x


# The reference calculator's modes: 'padfield' (the linear Padfield NCC,
# `batched_xcorr_peaks`) and the circular ones. Here each circular mode
# correlates in float32 (K1, K5 or K6): 'circular_dft' picks the TPU's
# DFT matmuls over FFTs and 'circular_dft_bf16' also rounds their inputs
# to bfloat16, choices for the TPU's matrix unit that the port does not
# copy. Integer peaks agree with 'circular_dft' on textured data.
CIRCULAR_MODES = ('circular', 'circular_dft', 'circular_dft_bf16')
FLOW_MODES = ('padfield',) + CIRCULAR_MODES


def check_flow_mode(mode: str) -> None:
  """Raises ValueError unless `mode` is one of FLOW_MODES."""
  if mode not in FLOW_MODES:
    raise ValueError(f'unknown flow mode {mode!r}')


def _selected_nodes(post_shape, patch, post_patch, step, pre_mask, post_mask,
                    selection_mask, max_masked: float) -> np.ndarray:
  """The calculator's grid nodes that it estimates ([*grid] bool, host).

  A node is kept where `selection_mask` (if given) is True and fewer than
  `max_masked` of each of its pre / post patch's pixels are masked (the
  occupancy from integral images, as the reference computes it; a
  tensor mask's on its own device).
  """
  out_shape = (np.asarray(tuple(post_shape)) - (np.asarray(post_patch)
                                         - np.asarray(step))) // step
  out_sel = tuple(np.s_[:n] for n in out_shape)
  keep = np.ones(out_shape, dtype=bool)
  if selection_mask is not None:
    keep &= np.array(placement.to_host(selection_mask)[out_sel], dtype=bool)
  for mask, size in ((pre_mask, patch), (post_mask, post_patch)):
    if mask is not None:
      occ = geom.query_integral_image(geom.integral_image(mask), size, step)
      keep &= ~(occ / np.prod(size) >= max_masked)[out_sel]
  return keep


class JAXMaskedXCorrWithStatsCalculator:
  """Grid-driven flow-field estimator; the port keeps the reference's name.

  Twin of flow_field.JAXMaskedXCorrWithStatsCalculator:
    * its dense branch (a circular `mode`, no targeting fields): the
      whole grid in one `dense_flow_field` call (K1, K5 with pixel masks,
      K6 for rectangular patches), then host-side deselection (NaN) of
      nodes whose patches are at least `max_masked` masked or that
      `selection_mask` drops;
    * its padfield mode (the default, and any run with targeting
      fields, or with masks or a selection in 3d), 2d or 3d: the same
      deselection, then the selected nodes in dispatch batches of
      `batch_size` through `batched_xcorr_peaks`.
      With masks the batch decides the Padfield thresholds, so the
      batches and the padding of the last one (its last start repeated)
      are the reference's.
  Images go to `device` (default: the CUDA card; tensors stay where they
  are). The result is numpy, as the reference returns. Every circular
  mode correlates in float32 (`check_flow_mode`).
  """

  non_spatial_flow_channels = 2  # peak sharpness, peak ratio

  def __init__(self, mean: float | None = None, peak_min_distance: float = 2,
               peak_radius: float = 5, device=None):
    self._mean = mean
    self._min_distance = peak_min_distance
    self._peak_radius = peak_radius
    self._device = device

  def flow_field(self, pre_image, post_image, patch_size, step, pre_mask=None,
                 post_mask=None, mask_only_for_patch_selection: bool = False,
                 selection_mask=None, max_masked: float = 0.75,
                 batch_size: int = 1024, post_patch_size=None,
                 pre_targeting_field=None, pre_targeting_step=None,
                 post_targeting_field=None, post_targeting_step=None,
                 progress_fn=_silent_fn,
                 mode: str = 'padfield') -> np.ndarray:
    """Flow from `post` to `pre` -> [dim+2, *grid] numpy, NaN where no
    estimate was made (see the reference for the conventions).

    `progress_fn(list_of_batch_indices)` (padfield mode) yields the
    batches to run; any other function than the default `_silent_fn`
    has each batch fetched as it completes.
    """
    ndim = pre_image.ndim
    check_flow_mode(mode)
    dense_ok = (mode != 'padfield' and pre_targeting_field is None
                and post_targeting_field is None
                and (ndim == 2 or (pre_mask is None and post_mask is None
                                   and selection_mask is None)))
    if dense_ok:
      return self._dense(pre_image, post_image, patch_size, step, pre_mask,
                         post_mask, mask_only_for_patch_selection,
                         selection_mask, max_masked, batch_size,
                         post_patch_size)
    return self._padfield(
        pre_image, post_image, patch_size, step, pre_mask, post_mask,
        mask_only_for_patch_selection, selection_mask, max_masked,
        batch_size, post_patch_size, pre_targeting_field, pre_targeting_step,
        post_targeting_field, post_targeting_step, progress_fn)

  def _dense(self, pre_image, post_image, patch_size, step, pre_mask,
             post_mask, mask_only_for_patch_selection, selection_mask,
             max_masked, batch_size, post_patch_size) -> np.ndarray:
    ndim = pre_image.ndim
    patch_t = _tuple(patch_size, ndim)
    step_t = _tuple(step, ndim)
    post_patch_t = _tuple(post_patch_size, ndim)
    if post_patch_t is not None and post_patch_t != patch_t:
      raise ValueError('circular mode requires equal pre/post patch sizes')

    keep = _selected_nodes(post_image.shape, patch_t, patch_t, step_t,
                           pre_mask, post_mask, selection_mask, max_masked)
    pixel_masks = not mask_only_for_patch_selection
    dev = self._device
    masks = [placement.place(m, dev) if pixel_masks and m is not None
             else None for m in (pre_mask, post_mask)]
    out = dense_flow_field(
        placement.place(pre_image, dev, torch.float32),
        placement.place(post_image, dev, torch.float32), patch_t, step_t,
        mean=self._mean, min_distance=self._min_distance,
        peak_radius=self._peak_radius, circular=True,
        pre_mask=masks[0], post_mask=masks[1], batch_size=batch_size)
    result = out.cpu().numpy().copy()
    result[:, ~keep] = np.nan
    return result

  def _padfield(self, pre_image, post_image, patch_size, step, pre_mask,
                post_mask, mask_only_for_patch_selection, selection_mask,
                max_masked, batch_size, post_patch_size, pre_targeting_field,
                pre_targeting_step, post_targeting_field,
                post_targeting_step, progress_fn) -> np.ndarray:
    ndim = pre_image.ndim
    patch_size = _tuple(patch_size, ndim)
    post_patch_size = _tuple(post_patch_size, ndim) or patch_size
    step = _tuple(step, ndim)
    pre_targeting_step = _tuple(pre_targeting_step, ndim)
    post_targeting_step = _tuple(post_targeting_step, ndim)
    pre_shape = np.asarray(tuple(pre_image.shape))
    post_shape = np.asarray(tuple(post_image.shape))

    selection = _selected_nodes(post_shape, patch_size, post_patch_size,
                                step, pre_mask, post_mask, selection_mask,
                                max_masked)
    output = np.full((self.non_spatial_flow_channels + ndim,)
                     + selection.shape, np.nan, dtype=np.float32)
    if mask_only_for_patch_selection:
      pre_mask = post_mask = None

    coords = np.argwhere(selection)  # [n, dim] grid coords ([z]yx)
    n = coords.shape[0]
    if n == 0:
      return output

    # Host-side integer geometry for all patches at once.
    post_starts = coords * np.asarray(step)[None, :]
    patch_offset = ((np.array(patch_size) - post_patch_size) // 2)[None, :]
    # Pre patches stay in bounds; the shift this introduces is compensated
    # in the returned flow below, as the reference does.
    pre_unclamped = post_starts - patch_offset
    pre_starts = np.clip(pre_unclamped, 0,
                         pre_shape[None, :] - np.asarray(patch_size)[None, :])
    pre_clamp_delta = pre_starts - pre_unclamped

    def targeting_offsets(field, tstep, starts, psize, img_shape):
      """In-bounds-clamped targeting offsets ([n, dim], [z]yx order)."""
      field = placement.to_host(field)
      center = (np.array(psize) // 2)[None, :]
      query = np.round((starts + center) / np.asarray(tstep)[None, :])
      query = query.astype(int)
      gather_idx = tuple(np.clip(query[:, i], 0, field.shape[i + 1] - 1)
                         for i in range(ndim))
      offs = np.nan_to_num(field[(slice(None),) + gather_idx].T)
      offs = offs.astype(int)[:, ::-1]  # channels xy[z] -> [z]yx
      new_starts = starts + offs
      offs = offs - np.minimum(new_starts, 0)
      ends = new_starts + np.asarray(psize)[None, :]
      offs = offs - np.maximum(ends - np.asarray(img_shape)[None, :], 0)
      return offs

    tg_offsets = None
    if pre_targeting_field is not None and pre_targeting_step is not None:
      tg_offsets = targeting_offsets(pre_targeting_field, pre_targeting_step,
                                     pre_starts, patch_size, pre_shape)
      pre_starts = pre_starts + tg_offsets
    post_offsets = None
    if post_targeting_field is not None and post_targeting_step is not None:
      post_offsets = targeting_offsets(post_targeting_field,
                                       post_targeting_step, post_starts,
                                       post_patch_size, post_shape)
      post_starts = post_starts + post_offsets
    pre_starts = np.clip(pre_starts, 0, None)
    post_starts = np.clip(post_starts, 0, None)

    # Dispatch batches; the last one repeats its last start.
    batch_size = int(min(batch_size, max(n, 1)))
    num_batches = -(-n // batch_size)
    padded = num_batches * batch_size
    if padded > n:
      pad = ((0, padded - n), (0, 0))
      pre_starts = np.pad(pre_starts, pad, mode='edge')
      post_starts = np.pad(post_starts, pad, mode='edge')

    dev = self._device
    pre_t = placement.place(pre_image, dev, torch.float32)
    post_t = placement.place(post_image, dev, torch.float32)
    pre_m = None if pre_mask is None else placement.place(pre_mask, dev)
    post_m = None if post_mask is None else placement.place(post_mask, dev)
    ps = torch.as_tensor(pre_starts.reshape(num_batches, batch_size, ndim),
                         device=pre_t.device)
    qs = torch.as_tensor(post_starts.reshape(num_batches, batch_size, ndim),
                         device=pre_t.device)

    def one_batch(i):
      return batched_xcorr_peaks(
          pre_t, post_t, pre_m, post_m, patch_size, ps[i], self._mean,
          min_distance=self._min_distance, threshold_rel=0.5,
          peak_radius=self._peak_radius,
          post_patch_size=post_patch_size, post_starts=qs[i])

    if progress_fn is _silent_fn:
      peaks = torch.cat([one_batch(i) for i in range(num_batches)])
      peaks = peaks.cpu().numpy()
    else:
      # Streaming: each batch is fetched as it completes.
      peaks = np.concatenate([one_batch(i).cpu().numpy()
                              for i in progress_fn(list(range(num_batches)))])
    peaks = peaks.reshape(padded, ndim + 2)[:n].copy()

    # Targeting / clamp corrections and the scatter.
    if np.any(pre_clamp_delta):
      peaks[:, :ndim] += pre_clamp_delta[:, ::-1]
    if tg_offsets is not None:
      peaks[:, :ndim] += tg_offsets[:, ::-1]
    if post_offsets is not None:
      peaks[:, :ndim] -= post_offsets[:, ::-1]
    output[(slice(None),) + tuple(coords.T)] = peaks.T
    return output
