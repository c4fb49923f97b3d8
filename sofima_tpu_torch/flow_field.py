"""Dense flow estimation on the alignment and stitching paths (subset).

Twin of sofima_tpu/flow_field.py. Ported:
  * the peak contract of `_batched_peaks`, 2d and 3d
    (ops.cuda_flow.batched_peaks);
  * the circular, unmasked dense-grid branch of `dense_flow_field`: 2d
    backed by kernel K1 (ops.cuda_flow.dense_flow_peaks), 3d by the
    strip path `_dense_flow_strips_3d` (patch-periodic FFT correlation,
    torch.fft as the reference leaves it to XLA's FFT, then the peaks);
  * the targeted branch of `coarse_to_fine_flow`: coarse pass (K1),
    robustified prior, `rint(-coarse)` window offsets clipped to
    `max_displacement` (the `overflow` flag), the fine crop, and the fine
    pass (K2) with `peak_crop`.
Masks, the masked coarse-to-fine fallback and warm-start priors are
still to be ported (ROADMAP.md, Queue 1 "Slice 1b") and raise
NotImplementedError.
"""

from __future__ import annotations

import torch

from sofima_tpu_torch.ops import cuda_flow
from sofima_tpu_torch.ops import interp as interp_ops

_batched_peaks = cuda_flow.batched_peaks

_TODO_MASKS = ('masked flow is not ported yet (ROADMAP.md Queue 1, '
               'Slice 1b: masked coarse-to-fine path)')


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


def _dense_flow_strips_3d(pre_image: torch.Tensor, post_image: torch.Tensor,
                          patch_size, step, mean: float | None,
                          min_distance: int, threshold_rel: float,
                          peak_radius: int) -> torch.Tensor:
  """Dense circular 3d flow over grid z-rows -> [5, gz, gy, gx].

  Per z-row: one [pz, strip_h, strip_w] slab of each image, its patches,
  mean removal, the patch-periodic cross-correlation
  irfftn(F(pre) conj(F(post))) with the zero shift rolled to the patch
  centre, and the peak statistics (x, y, z, sharpness, ratio).
  """
  pz, py, px = patch_size
  sz, sy, sx = step
  d, h, w = pre_image.shape
  gz = (d - (pz - sz)) // sz
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  strip_h = (gy - 1) * sy + py
  strip_w = (gx - 1) * sx + px
  center = (pz // 2, py // 2, px // 2)
  axes = (-3, -2, -1)
  pre_image = pre_image.to(torch.float32)
  post_image = post_image.to(torch.float32)
  rows = []
  for iz in range(gz):
    z0 = iz * sz

    def patches(img):
      return _strip_patches_3d(img[z0:z0 + pz, :strip_h, :strip_w], gy, gx,
                               patch_size, step)

    a, b = patches(pre_image), patches(post_image)
    if mean is None:
      a = a - a.mean(dim=axes, keepdim=True)
      b = b - b.mean(dim=axes, keepdim=True)
    else:
      a, b = a - mean, b - mean
    fa = torch.fft.rfftn(a, dim=axes)
    fb = torch.fft.rfftn(b, dim=axes)
    corr = torch.fft.irfftn(fa * torch.conj(fb), s=tuple(patch_size),
                            dim=axes)
    corr = torch.roll(corr, center, dims=axes)
    rows.append(_batched_peaks(corr, center, min_distance, threshold_rel,
                               peak_radius))
  out = torch.stack(rows).reshape(gz, gy, gx, 5)
  return out.permute(3, 0, 1, 2).contiguous()


def dense_flow_field(pre_image: torch.Tensor, post_image: torch.Tensor,
                     patch_size, step, mean: float | None = None,
                     min_distance: int = 2, threshold_rel: float = 0.5,
                     peak_radius: int = 5, circular: bool = True,
                     pre_mask=None, post_mask=None) -> torch.Tensor:
  """Flow over the full dense patch grid.

  2d: [4, gy, gx] (x, y, sharpness, ratio), via kernel K1 (float32
  correlation). 3d: [5, gz, gy, gx] (x, y, z, sharpness, ratio), via the
  strip path (stride must divide the patch size). Only the circular,
  unmasked branches are ported.
  """
  if pre_mask is not None or post_mask is not None:
    raise NotImplementedError(_TODO_MASKS)
  if not circular:
    raise NotImplementedError('only circular dense flow is ported')
  if tuple(pre_image.shape) != tuple(post_image.shape):
    raise ValueError('pre and post images must share a shape')
  if pre_image.ndim == 3:
    if any(p % s for p, s in zip(patch_size, step)):
      raise NotImplementedError('3d dense flow needs the stride to divide '
                                'the patch size (the strip path)')
    return _dense_flow_strips_3d(pre_image, post_image, tuple(patch_size),
                                 tuple(step), mean, min_distance,
                                 threshold_rel, peak_radius)
  if pre_image.ndim != 2:
    raise ValueError('2d or 3d images expected')
  return cuda_flow.dense_flow_peaks(
      pre_image, post_image, tuple(patch_size), tuple(step), mean=mean,
      min_distance=min_distance, threshold_rel=threshold_rel,
      peak_radius=peak_radius)


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
                        max_displacement: int = 96, pre_mask=None,
                        post_mask=None, min_distance: int = 2,
                        threshold_rel: float = 0.5, peak_radius: int = 5,
                        return_overflow: bool = False,
                        peak_crop: int | None = None, prior=None):
  """Coarse-to-fine dense flow on the `dense_flow_field(patch_size, step)`
  grid -> [4, gy, gx] (and the overflow flag with `return_overflow`).

  1. COARSE: full patches on a `coarse_step` grid (K1);
  2. the coarse field is NaN-filled with its median, 3x3-median filtered
     and clipped to +-max_displacement;
  3. FINE: `fine_patch` patches at `step` on the image cropped so their
     centers land on the target grid; each rows x group block of patches
     correlates a post window shifted by rint(-coarse) at the block
     center (K2; `peak_crop` restricts the peak search);
  4. flow = fine peak - window shift.

  `overflow` flags a coarse prior beyond `max_displacement` (the window
  was targeted at the clipped offset).
  """
  if pre_mask is not None or post_mask is not None:
    raise NotImplementedError(_TODO_MASKS)
  if prior is not None:
    raise NotImplementedError(
        'warm-start priors are not ported yet (ROADMAP.md Queue 1, '
        'Slice 1b: warm_start with its stale-prior refresh)')
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

  coarse = dense_flow_field(pre_image, post_image, patch_size, coarse_step,
                            min_distance=min_distance,
                            threshold_rel=threshold_rel,
                            peak_radius=peak_radius)

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

  cx = robustify(coarse[0])
  cy = robustify(coarse[1])
  cy0, cx0 = py // 2, px // 2  # first coarse node center

  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  k0y = (py // 2 - fy // 2 - crop_y) // sy
  k0x = (px // 2 - fx // 2 - crop_x) // sx
  hc, wc = h - crop_y, w - crop_x

  gy_f = (hc - (fine_patch[0] - sy)) // sy
  rows_f = 4 if ((3 * sy + fine_patch[0]) % 8 == 0 and gy_f >= 4) else None
  geo = cuda_flow.targeted_geometry((hc, wc), fine_patch, step, rows=rows_f)
  dev = pre_image.device
  ctr_y = ((torch.arange(geo['nrsteps'], dtype=torch.float32, device=dev)
            * (geo['rows'] * sy) + geo['win_r'] / 2.0 + crop_y - cy0) / csy)
  ctr_x = ((torch.arange(geo['ngroups'], dtype=torch.float32, device=dev)
            * (geo['group'] * sx) + geo['win_c'] / 2.0 + crop_x - cx0) / csx)
  nr, ng = geo['nrsteps'], geo['ngroups']
  mesh2 = torch.stack([ctr_y[:, None].expand(nr, ng),
                       ctr_x[None, :].expand(nr, ng)])
  fx_c = interp_ops.grid_sample_linear(cx, mesh2)
  fy_c = interp_ops.grid_sample_linear(cy, mesh2)
  offs_raw = torch.stack([torch.round(-fy_c), torch.round(-fx_c)], dim=-1)
  offs = torch.clamp(offs_raw, -max_displacement,
                     max_displacement).to(torch.int32)
  overflow = torch.any(torch.abs(offs_raw) > max_displacement)

  def fine_crop(img):
    return img[crop_y:, crop_x:] if (crop_y or crop_x) else img

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
  total = total[:, k0y:k0y + gy, k0x:k0x + gx]
  return (total, overflow) if return_overflow else total
