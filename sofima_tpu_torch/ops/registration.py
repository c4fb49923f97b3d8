"""Global registration primitives on the device: phase correlation + ECC.

Twin of sofima_tpu/ops/registration.py, in plain PyTorch on `device`
(default: the CUDA card), as the reference computes both outside any
Pallas kernel:

* `phase_cross_correlation` — the peak of the cross-power spectrum
  (torch.fft.rfftn / irfftn); returns the shift to apply to the moving
  image to align it to the reference, skimage's contract.
* `optim_transform` — Gauss-Newton maximization of the enhanced
  correlation coefficient over 2d affine (or translation / euclidean
  restricted) warps: per iteration a bilinear warp, the image gradient,
  the 6x6 normal equations and their solve. The iterations are a Python
  loop that never reads the device back; the normal equations are
  accumulated as image moments (float64), so the [n, 6] Jacobian is
  never built.

Both take the reference's signatures; `device=` is read from their
trailing keyword arguments (the reference ignores unknown ones).
"""

from __future__ import annotations

import numpy as np
import torch

from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import interp


def _phase_corr(reference: torch.Tensor, moving: torch.Tensor,
                normalization: str | None = 'phase'
                ) -> tuple[torch.Tensor, torch.Tensor]:
  shape = reference.shape
  cross = torch.fft.rfftn(reference) * torch.conj(torch.fft.rfftn(moving))
  if normalization == 'phase':
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
  corr = torch.fft.irfftn(cross, s=shape)
  idx = torch.argmax(corr)  # the first maximal index, as jnp.argmax
  peak = corr.reshape(-1)[idx]
  shifts = torch.stack(torch.unravel_index(idx, shape)).to(torch.float32)
  dims = torch.tensor(shape, dtype=torch.float32, device=shifts.device)
  # Wrap shifts beyond the Nyquist point to negative offsets.
  shifts = torch.where(shifts > dims // 2, shifts - dims, shifts)
  return shifts, peak


def phase_cross_correlation(reference_image, moving_image,
                            normalization: str | None = 'phase',
                            upsample_factor: int = 1, **unused_kwargs):
  """skimage-compatible: returns (shift, error, phasediff).

  `shift` (per axis, image order, float32 numpy) is the translation to
  apply to `moving_image` so it aligns with `reference_image`; `error` is
  1 - the correlation peak. `device=` (in the keyword arguments) places
  host images (default: the CUDA card).
  """
  del upsample_factor
  device = unused_kwargs.get('device')
  shifts, peak = _phase_corr(
      placement.place(reference_image, device, torch.float32),
      placement.place(moving_image, device, torch.float32), normalization)
  return shifts.cpu().numpy(), float(1.0 - peak), 0.0


_MOTION_PARAMS = {'translation': 2, 'euclidean': 3, 'affine': 6}

def _moments(weight: torch.Tensor, pow_y: torch.Tensor,
             pow_x: torch.Tensor) -> torch.Tensor:
  """[3, 3] float64: M[b, a] = sum over pixels of weight * y^b * x^a."""
  return pow_y.T @ (weight.to(torch.float64) @ pow_x)


def _normal_equations(gx, gy, r, pow_y, pow_x):
  """J^T J [6, 6] and J^T r [6] (float64) of the Jacobian whose columns
  are (gx u, gy u), u = (x, y, 1), from image moments (basic indexing
  only: nothing crosses from the host)."""

  def block(m):  # sum of w u u^T
    return torch.stack([torch.stack([m[0, 2], m[1, 1], m[0, 1]]),
                        torch.stack([m[1, 1], m[2, 0], m[1, 0]]),
                        torch.stack([m[0, 1], m[1, 0], m[0, 0]])])

  def vec(m):  # sum of w u
    return torch.stack([m[0, 1], m[1, 0], m[0, 0]])

  m_xy = block(_moments(gx * gy, pow_y, pow_x))
  jtj = torch.cat([
      torch.cat([block(_moments(gx * gx, pow_y, pow_x)), m_xy], 1),
      torch.cat([m_xy, block(_moments(gy * gy, pow_y, pow_x))], 1)], 0)
  jtr = torch.cat([vec(_moments(gx * r, pow_y, pow_x)),
                   vec(_moments(gy * r, pow_y, pow_x))])
  return jtj, jtr


def _nearest_orthogonal(a, b, c, d):
  """The polar factor U V^T of [[a, b], [c, d]] (what an SVD gives), in
  closed form: a rotation where the determinant is positive, else a
  reflection."""
  rot = torch.atan2(c - b, a + d)
  ref = torch.atan2(b + c, a - d)
  flip = a * d - b * c < 0
  cr, sr, cf, sf = torch.cos(rot), torch.sin(rot), torch.cos(ref), torch.sin(
      ref)
  return (torch.where(flip, cf, cr), torch.where(flip, sf, -sr),
          torch.where(flip, sf, sr), torch.where(flip, -cf, cr))


def _ecc_core(fixed: torch.Tensor, moving: torch.Tensor,
              init_matrix: torch.Tensor, num_iters: int,
              motion: str) -> torch.Tensor:
  """Gauss-Newton ECC; returns the [2, 3] warp matrix (xy convention,
  float64 on the device).

  The matrix maps fixed-image coords to moving-image coords: sampling
  the moving image at W(fixed grid) reconstructs `fixed`.
  """
  h, w = fixed.shape
  dev = fixed.device
  ys = torch.arange(h, dtype=torch.float32, device=dev)
  xs = torch.arange(w, dtype=torch.float32, device=dev)
  yy, xx = ys[:, None].expand(h, w), xs[None, :].expand(h, w)
  pow_y = torch.stack([ys.double() ** k for k in range(3)], 1)  # [h, 3]
  pow_x = torch.stack([xs.double() ** k for k in range(3)], 1)  # [w, 3]

  def normalize(img):
    return (img - torch.mean(img)) / (torch.std(img, correction=0) + 1e-8)

  f = normalize(fixed)
  mov_n = normalize(moving)
  # The parameters that move (filled on the device: a host tensor's copy
  # would wait for the card).
  mask = torch.ones(6, dtype=torch.float64, device=dev)
  if motion == 'translation':
    mask[:2] = 0
    mask[3:5] = 0
  eye = 1e-6 * torch.eye(6, dtype=torch.float64, device=dev)

  params = init_matrix.to(torch.float64).reshape(6)
  for _ in range(num_iters):
    # params: (a, b, tx, c, d, ty), xy convention:
    # x' = a x + b y + tx ;  y' = c x + d y + ty
    p32 = params.to(torch.float32)
    sx = p32[0] * xx + p32[1] * yy + p32[2]
    sy = p32[3] * xx + p32[4] * yy + p32[5]
    warped = interp.sample(mov_n, torch.stack([sy, sx]), method='linear',
                           mode='nearest')
    gy, gx = torch.gradient(warped)  # jnp.gradient's edge rule
    jtj, jtr = _normal_equations(gx, gy, f - warped, pow_y, pow_x)
    jtj = mask[:, None] * jtj * mask[None, :] + eye
    # Forward-additive Gauss-Newton: warped(p + δ) ≈ warped + Jδ, so the
    # normal-equation step is added to the parameters. solve_ex checks
    # nothing on the host, so the loop never waits for the device.
    delta = torch.linalg.solve_ex(jtj, mask * jtr)[0]
    params = params + delta
    if motion == 'euclidean':
      # Project back onto the nearest orthogonal 2x2.
      a, b, c, d = _nearest_orthogonal(params[0], params[1], params[3],
                                       params[4])
      params = torch.stack([a, b, params[2], c, d, params[5]])
  return params.reshape(2, 3)


def optim_transform(fix, mov, transform_initial=None, num_iters: int = 100,
                    motion: str = 'affine', **unused_kwargs
                    ) -> tuple[float, np.ndarray]:
  """ECC alignment of 2d images (xy convention, like opencv_utils).

  Args:
    fix: fixed image ([x, y] axis order, following the OpenCV-style
      convention of the reference decorator layer)
    mov: moving image
    transform_initial: optional 2x3 init (identity otherwise)
    num_iters: Gauss-Newton iterations
    motion: 'translation' | 'euclidean' | 'affine'
    **unused_kwargs: `device=` places host images (default: the CUDA
      card); anything else is ignored, as in the reference

  Returns:
    (final correlation coefficient, [2, 3] float64 transform) such that
    warping `mov` by the inverse transform aligns it to `fix`.
  """
  if motion not in _MOTION_PARAMS:
    raise ValueError(f'unknown motion model {motion!r}')
  device = unused_kwargs.get('device')
  # Work in [y, x] internally; the xy convention transposes the images.
  fix_t = placement.place(fix, device, torch.float32).T
  mov_t = placement.place(mov, fix_t.device, torch.float32).T
  if transform_initial is None:
    transform_initial = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
  init = placement.place(transform_initial, fix_t.device, torch.float32)
  matrix = _ecc_core(fix_t, mov_t, init, num_iters, motion)

  # Final quality: correlation coefficient of the aligned pair.
  h, w = fix_t.shape
  yy, xx = torch.meshgrid(
      torch.arange(h, dtype=torch.float32, device=fix_t.device),
      torch.arange(w, dtype=torch.float32, device=fix_t.device),
      indexing='ij')
  m = matrix.to(torch.float32)
  sx = m[0, 0] * xx + m[0, 1] * yy + m[0, 2]
  sy = m[1, 0] * xx + m[1, 1] * yy + m[1, 2]
  warped = interp.sample(mov_t, torch.stack([sy, sx]), method='linear',
                         mode='nearest')
  fz = fix_t - fix_t.mean()
  wz = warped - warped.mean()
  cc = float((fz * wz).sum() / (torch.linalg.vector_norm(fz)
                                * torch.linalg.vector_norm(wz) + 1e-8))
  return cc, matrix.cpu().numpy()
