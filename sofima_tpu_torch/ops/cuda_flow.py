"""Kernels K1, K2, K5, K6 and K7, flow peaks: CUDA wrappers and plain twins.

Twin of sofima_tpu/ops/pallas_flow.py: `dense_flow_peaks_pallas` (K1,
Pallas body `_grid_kernel`, unmasked), `dense_flow_peaks_targeted`
(K2, `_grid_kernel_targeted`) and `dense_flow_peaks_pallas` with valid
planes (K5, `_grid_kernel_masked`), plus `targeted_geometry`, ported only
as the rule for the granularity of the fine-pass window offsets. K1 and
K2 launch csrc/flow_peaks.cu: K1 with no offsets, K2 with per-patch
post-window offsets expanded from the per-block [nrsteps, ngroups, 2]
offsets and an optional centered `peak_crop`. Both run on K7's
shared-memory FFT (the FFT route) where the packed pair fits in shared
memory and the core in the block's registers (p <= 168, crop <= 160),
else on the dense-DFT route. K5
(`masked_dense_flow_peaks`, csrc/masked_flow.cu) computes the circular
Padfield NCC of each patch pair under its valid masks and shares the
peak chain (csrc/flow_peaks.cuh); its denominator tolerance is per patch
(see `padfield_ncc` and the kernel's source note). It splits the grid
into dead, pure and impure lists: the pure pairs run the closed-form NCC
on K7's shared-memory FFT, the impure ones the dense-DFT Padfield chain.

K6 (`flow_peaks`, Pallas `flow_peaks_pallas` / `_corr_peaks_kernel`)
and K7 (`corr_patches`, `corr_patches_pallas` / `_corr_kernel`) take
pre-cut [n, p1, p2] patch batches, rectangular allowed. K6
(csrc/patch_corr.cu) writes the [n, 4] peak rows (the 2d strip path's
and the start-list path's correlation): on the shared-memory FFT where
the pair fits (`patch_fft_kernel`, K7's rectangular plan and tables,
then the peak chain), else on a dense DFT; K7 (csrc/corr_fft.cu) writes
the [n, p1, p2] centred surfaces from the shared-memory mixed-radix FFT
of csrc/fft_smem.cuh, whose plan and tables `_fft_axis_np` builds here.

For every patch pair on the grid (pre at (i*sy, j*sx), post at the same
position plus its offset, zeros outside the image) the kernel removes
each patch's mean, computes the circular cross-correlation with the zero
shift at p//2, and extracts the top-2 peak statistics of
flow_field._batched_peaks. Output [4, gy, gx] = (x, y, sharpness,
ratio), NaN rows where no peak passes the threshold.

Precision: the correlation runs in float32 on both the kernel and the
plain version, including when callers ask for `bf16=True` (the reference
feeds bf16 operands to the TPU's matrix unit; on the H100 the
transforms, FFT or DFT, run in f32 outside the tensor cores).
"""

from __future__ import annotations

import collections.abc
import ctypes
import functools

import numpy as np
import torch

from sofima_tpu_torch.ops import _build

# A peak window's radius: one int, or one per surface axis ([z,] y, x).
Radius = int | collections.abc.Sequence[int]

# Patches per chunk in the plain version (bounds its memory).
_PLAIN_CHUNK = 512
# Largest per-block working set the kernels keep in dynamic shared memory
# (of the H100's 227 KB, less the static reduction arrays); above it each
# block works in global scratch instead.
_MAX_SMEM_BYTES = 226 * 1024
# K7's global scratch (complex [pairs, p1, p2]) per launch, at most.
_K7_SCRATCH_BYTES = 1 << 30


def targeted_geometry(shape, patch_size, step, group=None, rows=None):
  """Grid and offset-block geometry of the targeted fine pass.

  The fine pass shifts every `rows x group` block of patches by one
  offset, and parity with the reference needs its blocks: `group` and
  `rows` follow the reference's TPU alignment rule
  (pallas_flow.pick_grid_geometry), and the coarse prior is sampled at
  the centre of its block window, whose column extent is rounded up to
  the TPU's 128 lanes.
  """
  py, px = patch_size
  sy, sx = step
  h, w = shape
  gy = (h - (py - sy)) // sy
  gx = (w - (px - sx)) // sx
  if group is None:
    unit = 128 // int(np.gcd(int(sx), 128))
    group = max(unit, ((8 + unit - 1) // unit) * unit)
  if rows is None:
    rows = 2 if (sy + py) % 8 == 0 and gy >= 2 else 1
  win_c = -(-((group - 1) * sx + px) // 128) * 128
  return dict(gy=gy, gx=gx, group=group, rows=rows,
              ngroups=-(-gx // group), nrsteps=-(-gy // rows),
              win_r=(rows - 1) * sy + py, win_c=win_c)


@functools.lru_cache(maxsize=8)
def _dft_tables_np(p: int):
  """cos/sin(2 pi jk / p) as float32 [p, p] (reduced modulo p first)."""
  jk = np.outer(np.arange(p), np.arange(p)) % p
  ang = 2.0 * np.pi * jk / p
  return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# Longest axis K7's FFT takes (csrc/fft_smem.cuh kMaxLength).
_FFT_MAX_LENGTH = 2048


def _fft_radices(n: int) -> list[int]:
  """K7's factorization of n in DIF order: 8s, then a 4 or 2, then 5s, 3s
  and the other primes (each a generic stage in the kernel)."""
  rs, e2 = [], 0
  while n % 2 == 0:
    n //= 2
    e2 += 1
  rs += [8] * (e2 // 3) + {0: [], 1: [2], 2: [4]}[e2 % 3]
  p = 5
  while n > 1:
    while n % p == 0:
      rs.append(p)
      n //= p
    p = 3 if p == 5 else (7 if p == 3 else p + 2)
  return rs


@functools.lru_cache(maxsize=16)
def _fft_axis_np(n: int):
  """Plan and tables of one axis of K7's FFT (csrc/fft_smem.cuh).

  Returns (radices, tw, root, inv, src, outpos): DIF stage s of radix r
  and stride m = L / r on sub-transforms of length L has twiddles
  tw[off + (t - 1) m + j] = w_L^{jt} (w_L = e^{-2 pi i / L}; float64
  rounded to float32; padded to n entries); root[e] = w_n^e; after the
  DIF stages position q holds frequency rev[q] (the digits of q read in
  reverse radix order), and `inv` is rev's inverse; src[c] =
  inv[(c - n//2) mod n] and outpos[q] = (rev[q] + n//2) mod n fold the
  centring roll into the surface store.
  """
  rs = _fft_radices(n)
  tw = np.ones(n, np.complex128)
  rev = np.zeros(n, np.int64)
  ell, off, mult = n, 0, 1
  q = np.arange(n)
  for r in rs:
    m = ell // r
    t, j = np.meshgrid(np.arange(1, r), np.arange(m), indexing='ij')
    tw[off:off + (r - 1) * m] = np.exp(-2j * np.pi * (j * t) / ell).ravel()
    rev += ((q // m) % r) * mult
    off += (r - 1) * m
    mult *= r
    ell = m
  root = np.exp(-2j * np.pi * np.arange(n) / n)
  inv = np.argsort(rev)
  src = inv[(np.arange(n) - n // 2) % n]
  outpos = (rev + n // 2) % n

  def f32(c):
    return np.stack([c.real, c.imag], -1).astype(np.float32)

  return (rs, f32(tw), f32(root), inv.astype(np.int32), src.astype(np.int32),
          outpos.astype(np.int32))


@functools.lru_cache(maxsize=8)
def _fft_tables(p1: int, p2: int, device: str):
  """K7's launch tables for p1 x p2 pairs: the radices (host int32: nst1,
  r..., nst2, r...), the twiddles tw1 | root1 | tw2 | root2 and the
  indices inv1 | src1 | outpos1 | inv2 | src2 | outpos2 on `device`."""
  a1, a2 = _fft_axis_np(p1), _fft_axis_np(p2)
  radices = np.array([len(a1[0]), *a1[0], len(a2[0]), *a2[0]], np.int32)
  tabs = np.concatenate([a1[1], a1[2], a2[1], a2[2]])
  idx = np.concatenate([a1[3], a1[4], a1[5], a2[3], a2[4], a2[5]])
  return (radices, torch.from_numpy(tabs).to(device),
          torch.from_numpy(idx).to(device))


@functools.lru_cache(maxsize=8)
def _rdft_mats_np(n: int):
  """Half-spectrum DFT matrices, as flow_field._rdft_mats builds them."""
  h = n // 2 + 1
  ang = -2.0 * np.pi * np.outer(np.arange(n), np.arange(h)) / n
  fr = np.cos(ang).astype(np.float32)
  fi = np.sin(ang).astype(np.float32)
  alpha = np.full(h, 2.0, np.float32)
  alpha[0] = 1.0
  if n % 2 == 0:
    alpha[-1] = 1.0
  br = (np.cos(-ang) * alpha[None]).astype(np.float32).T
  bi = (-np.sin(-ang) * alpha[None]).astype(np.float32).T
  return fr, fi, br, bi


@functools.lru_cache(maxsize=8)
def _dft_mats_np(n: int):
  ang = -2.0 * np.pi * np.outer(np.arange(n), np.arange(n)) / n
  return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _rdft2(img: torch.Tensor):
  """Half-spectrum 2d DFT of [b, n1, n2] via DFT matmuls -> (re, im).

  Plain-version transcription of flow_field._rdft2 (f32).
  """
  n1, n2 = img.shape[-2:]
  dev = img.device
  wr1, wi1 = (torch.as_tensor(m, device=dev) for m in _dft_mats_np(n1))
  fr2, fi2 = (torch.as_tensor(m, device=dev) for m in _rdft_mats_np(n2)[:2])
  ar = torch.einsum('bnm,mh->bnh', img, fr2)
  ai = torch.einsum('bnm,mh->bnh', img, fi2)
  return (torch.einsum('kn,bnh->bkh', wr1, ar)
          - torch.einsum('kn,bnh->bkh', wi1, ai),
          torch.einsum('kn,bnh->bkh', wr1, ai)
          + torch.einsum('kn,bnh->bkh', wi1, ar))


def _irdft2_of_product(a, b, n1: int, n2: int) -> torch.Tensor:
  """real(iDFT2(A conj(B))) of half spectra (re, im); flow_field's twin."""
  dev = a[0].device
  wr1, wi1 = (torch.as_tensor(m, device=dev) for m in _dft_mats_np(n1))
  br2, bi2 = (torch.as_tensor(m, device=dev) for m in _rdft_mats_np(n2)[2:])
  (ar, ai), (br, bi) = a, b
  cr = ar * br + ai * bi
  ci = ai * br - ar * bi
  gr = (torch.einsum('kn,bnh->bkh', wr1, cr)
        + torch.einsum('kn,bnh->bkh', wi1, ci)) / n1
  gi = (torch.einsum('kn,bnh->bkh', wr1, ci)
        - torch.einsum('kn,bnh->bkh', wi1, cr)) / n1
  return (torch.einsum('bkh,hm->bkm', gr, br2)
          + torch.einsum('bkh,hm->bkm', gi, bi2)) / n2


def circular_xcorr(pre_b: torch.Tensor, post_b: torch.Tensor) -> torch.Tensor:
  """irfft2(F(pre) conj(F(post))) of [b, n1, n2] batches via DFT matmuls.

  Plain-version transcription of flow_field._circular_xcorr_matmul (f32).
  """
  n1, n2 = pre_b.shape[-2:]
  return _irdft2_of_product(_rdft2(pre_b), _rdft2(post_b), n1, n2)


def padfield_ncc(pre_z: torch.Tensor, post_z: torch.Tensor,
                 pre_valid: torch.Tensor, post_valid: torch.Tensor,
                 rfft, icorr, per_patch: bool) -> torch.Tensor:
  """Circular masked NCC (Padfield) of [b, *patch] batches.

  Twin of flow_field._masked_xcorr_circular (2d, DFT matmuls) and
  `_masked_xcorr_circular_fft` (any rank, FFTs): `pre_z` / `post_z` are
  the mean-removed patches, zero where invalid; `rfft(x)` gives a
  spectrum and `icorr(a, b)` the real surface of a * conj(b). The
  denominator tolerance 1e3 eps max|denom| and the low-overlap cut are
  taken per patch (`per_patch`: the cut at 0.3 x the patch area, K5's
  rule) or over the whole batch (the cut at 0.3 x the batch's largest
  overlap, the reference's strip paths).
  """
  eps = float(np.finfo(np.float32).eps)
  f_p, f_c = rfft(pre_z), rfft(post_z)
  f_mp, f_mc = rfft(pre_valid.to(torch.float32)), rfft(
      post_valid.to(torch.float32))
  f_p2, f_c2 = rfft(pre_z * pre_z), rfft(post_z * post_z)
  xcorr = icorr(f_p, f_c)
  overlap = torch.clamp(torch.round(icorr(f_mp, f_mc)), min=eps)
  inv_overlap = 1.0 / overlap
  sum_p = icorr(f_p, f_mc)
  sum_c = icorr(f_mp, f_c)
  numerator = xcorr - sum_p * sum_c * inv_overlap
  var_p = torch.clamp(icorr(f_p2, f_mc) - sum_p * sum_p * inv_overlap,
                      min=0.0)
  var_c = torch.clamp(icorr(f_mp, f_c2) - sum_c * sum_c * inv_overlap,
                      min=0.0)
  denom = torch.sqrt(var_p * var_c)
  dims = tuple(range(1, denom.ndim)) if per_patch else tuple(
      range(denom.ndim))
  tol = 1e3 * eps * torch.amax(torch.abs(denom), dim=dims, keepdim=True)
  out = torch.where(denom > tol,
                    numerator / torch.where(denom > tol, denom,
                                            torch.ones_like(denom)),
                    torch.zeros_like(denom))
  out = torch.clamp(out, -1.0, 1.0)
  if per_patch:
    cut = _overlap_cut(int(np.prod(pre_z.shape[1:])))
  else:
    cut = 0.3 * torch.amax(overlap)
  return torch.where(overlap < cut, torch.zeros_like(out), out)


def _overlap_cut(area: int) -> float:
  """0.3 x the patch area, rounded once to float32 (as the reference's
  Python-float threshold meets its float32 overlap)."""
  return float(np.float32(0.3 * area))


def per_axis(value, dim: int) -> tuple[int, ...]:
  """An int or a per-axis sequence -> `dim` ints, one per surface axis
  ([z,] y, x), as flow_field._batched_peaks reads `min_distance` and
  `peak_radius`."""
  if isinstance(value, collections.abc.Sequence):
    if len(value) != dim:
      raise ValueError(f'{dim} per-axis values expected, got {value!r}')
    return tuple(int(v) for v in value)
  return (int(value),) * dim


def batched_peaks(img: torch.Tensor, center,
                  min_distance: Radius = 2,
                  threshold_rel: float = 0.5,
                  peak_radius: Radius = 5) -> torch.Tensor:
  """Top-2 local maxima + stats of [b, n1, n2(, n3)] surfaces.

  Twin of flow_field._batched_peaks (2d or 3d): rows [b, dim + 2] of
  (x, y[, z] offset from `center`, sharpness, peak ratio), ratio 0 with
  one peak, NaN rows with none. `min_distance` and `peak_radius` are an
  int or one radius per surface axis.
  """
  b = img.shape[0]
  spatial = img.shape[1:]
  dim = len(spatial)
  pool = {2: torch.nn.functional.max_pool2d,
          3: torch.nn.functional.max_pool3d}[dim]
  md = per_axis(min_distance, dim)
  img_max = pool(img[:, None], tuple(2 * m + 1 for m in md), stride=1,
                 padding=md)[:, 0]
  axes = tuple(range(1, dim + 1))
  thr = threshold_rel * img.amax(dim=axes, keepdim=True)
  mask = (img == img_max) & (img > thr)
  flat = torch.where(mask, img, torch.full_like(img, float('-inf')))
  flat = flat.reshape(b, -1)
  idx1 = torch.argmax(flat, dim=-1)
  val1 = torch.gather(flat, 1, idx1[:, None])[:, 0]
  cols = torch.arange(flat.shape[-1], device=img.device)[None]
  flat2 = torch.where(cols == idx1[:, None],
                      torch.full_like(flat, float('-inf')), flat)
  val2 = flat2.amax(dim=-1)

  rad = per_axis(peak_radius, dim)
  wsize = tuple(2 * r + 1 for r in rad)
  minf = -pool(-img[:, None], wsize, stride=1)[:, 0]
  inds, rem = [], idx1
  for n in reversed(spatial):  # unravel, last axis first
    inds.insert(0, rem % n)
    rem = rem // n
  starts = [torch.clamp(i - r, 0, n - w)
            for i, r, w, n in zip(inds, rad, wsize, spatial)]
  wmin = minf[(torch.arange(b, device=img.device), *starts)]
  sharp = val1 / wmin
  ratio = torch.where(torch.isinf(val2), torch.zeros_like(val1), val1 / val2)
  centered = [i.to(torch.float32) - c for i, c in zip(inds, center)]
  rows = torch.stack(centered[::-1] + [sharp, ratio], dim=-1)
  return torch.where(torch.isinf(val1)[:, None],
                     torch.full_like(rows, float('nan')), rows)


# The peak chain's window arguments in the kernels' C signatures:
# min_y, min_x, threshold_rel, rad_y, rad_x (csrc/flow_peaks.cuh).
_WINDOW_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                    ctypes.c_int]


def _window_args(min_distance, threshold_rel, peak_radius) -> tuple:
  """(min_y, min_x, threshold_rel, rad_y, rad_x) of 2d surfaces."""
  return (*per_axis(min_distance, 2), float(threshold_rel),
          *per_axis(peak_radius, 2))


def _patches(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             p: int) -> torch.Tensor:
  """[b, p, p] patches at (y0, x0) with zeros outside the image."""
  h, w = img.shape
  ar = torch.arange(p, device=img.device)
  yy = y0[:, None, None] + ar[None, :, None]
  xx = x0[:, None, None] + ar[None, None, :]
  inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
  lin = torch.where(inb, yy * w + xx, torch.zeros_like(yy))
  vals = img.reshape(-1)[lin]
  return torch.where(inb, vals, torch.zeros_like(vals))


def flow_surfaces_plain(pre: torch.Tensor, post: torch.Tensor,
                        offsets: torch.Tensor | None, grid: tuple[int, int],
                        patch: int, step: tuple[int, int], crop: int,
                        mean: float | None,
                        pairs: slice = slice(None)) -> torch.Tensor:
  """The centred [crop, crop] correlation cores of the flow-peaks grid's
  pairs `pairs` (grid indices gi * gx + gj) -> [n, crop, crop]."""
  gy, gx = grid
  sy, sx = step
  ii = torch.arange(gy * gx, device=pre.device)[pairs]
  y0 = (ii // gx) * sy
  x0 = (ii % gx) * sx
  qy0, qx0 = y0, x0
  if offsets is not None:
    off = offsets.reshape(gy * gx, 2).to(torch.int64)[pairs]
    qy0, qx0 = y0 + off[:, 0], x0 + off[:, 1]
  a = _patches(pre, y0, x0, patch)
  b = _patches(post, qy0, qx0, patch)
  if mean is None:
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
  else:
    a, b = a - mean, b - mean
  corr = torch.roll(circular_xcorr(a, b), (patch // 2, patch // 2),
                    dims=(1, 2))
  lo = patch // 2 - crop // 2
  return corr[:, lo:lo + crop, lo:lo + crop]


def flow_peaks_plain(pre: torch.Tensor, post: torch.Tensor,
                     offsets: torch.Tensor | None, grid: tuple[int, int],
                     patch: int, step: tuple[int, int], crop: int,
                     mean: float | None, min_distance: Radius,
                     threshold_rel: float, peak_radius: Radius) -> torch.Tensor:
  """Plain PyTorch version of the flow-peaks kernel -> [4, gy, gx]."""
  gy, gx = grid
  n = gy * gx
  out = []
  for c0 in range(0, n, _PLAIN_CHUNK):
    corr = flow_surfaces_plain(pre, post, offsets, grid, patch, step, crop,
                               mean, slice(c0, min(n, c0 + _PLAIN_CHUNK)))
    out.append(batched_peaks(corr, (crop // 2, crop // 2), min_distance,
                             threshold_rel, peak_radius))
  return torch.cat(out).reshape(gy, gx, 4).permute(2, 0, 1).contiguous()


def masked_patch_classes(pre_valid: torch.Tensor, post_valid: torch.Tensor,
                         patch: int, step) -> torch.Tensor:
  """K5's branch of each dense-grid patch pair -> int [gy, gx].

  0 impure, 1 pure (both patches fully valid), 2 dead (either patch
  without a valid pixel); exact integer counts of `valid > 0` pixels
  from integral images.
  """
  sy, sx = step
  h, w = pre_valid.shape
  gy, gx = (h - (patch - sy)) // sy, (w - (patch - sx)) // sx
  dev = pre_valid.device
  ys = torch.arange(gy, device=dev) * sy
  xs = torch.arange(gx, device=dev) * sx

  def counts(valid):
    ii = torch.nn.functional.pad(
        (valid > 0).to(torch.int64).cumsum(0).cumsum(1), (1, 0, 1, 0))
    y1, x1 = ys + patch, xs + patch
    return (ii[y1][:, x1] - ii[ys][:, x1] - ii[y1][:, xs] + ii[ys][:, xs])

  ca, cb = counts(pre_valid), counts(post_valid)
  area = patch * patch
  dead = (ca == 0) | (cb == 0)
  pure = (ca == area) & (cb == area)
  return torch.where(dead, 2, pure.to(torch.int64))


def masked_flow_peaks_plain(pre: torch.Tensor, post: torch.Tensor,
                            pre_valid: torch.Tensor, post_valid: torch.Tensor,
                            grid: tuple[int, int], patch: int,
                            step: tuple[int, int], mean: float | None,
                            min_distance: Radius, threshold_rel: float,
                            peak_radius: Radius,
                            pairs: torch.Tensor | None = None) -> torch.Tensor:
  """Plain PyTorch version of K5 -> [4, gy, gx].

  Per patch pair, the branch of `masked_patch_classes`: dead pairs give
  NaN rows; pure pairs the closed-form NCC of the plain cross-correlation
  and the patch moments; impure pairs the Padfield chain of
  flow_field._masked_xcorr_circular (`padfield_ncc`, per-patch
  tolerance). Then the peak chain of `batched_peaks`. `pairs`: grid
  indices gi * gx + gj of the only pairs to compute, whose rows come
  back as [4, len(pairs)].
  """
  gy, gx = grid
  sy, sx = step
  dev = pre.device
  ii = (torch.arange(gy * gx, device=dev) if pairs is None
        else pairs.to(device=dev, dtype=torch.int64))
  n = ii.numel()
  y0 = (ii // gx) * sy
  x0 = (ii % gx) * sx
  classes = masked_patch_classes(pre_valid, post_valid, patch,
                                 step).reshape(-1)[ii]
  area = float(patch * patch)
  eps = float(np.finfo(np.float32).eps)
  icorr = functools.partial(_irdft2_of_product, n1=patch, n2=patch)
  out = []
  for c0 in range(0, n, _PLAIN_CHUNK):
    sl = slice(c0, min(n, c0 + _PLAIN_CHUNK))
    a = _patches(pre, y0[sl], x0[sl], patch)
    b = _patches(post, y0[sl], x0[sl], patch)
    va = _patches(pre_valid, y0[sl], x0[sl], patch) > 0
    vb = _patches(post_valid, y0[sl], x0[sl], patch) > 0
    zero = torch.zeros_like(a)
    if mean is None:
      ma = (torch.where(va, a, zero).sum(dim=(1, 2), keepdim=True)
            / torch.clamp(va.sum(dim=(1, 2), keepdim=True), min=1))
      mb = (torch.where(vb, b, zero).sum(dim=(1, 2), keepdim=True)
            / torch.clamp(vb.sum(dim=(1, 2), keepdim=True), min=1))
    else:
      ma = mb = mean
    pz = torch.where(va, a - ma, zero)
    cz = torch.where(vb, b - mb, zero)
    cls = classes[sl]
    corr = torch.zeros_like(a)
    pure = cls == 1
    if bool(pure.any()):
      p_, c_ = pz[pure], cz[pure]
      s1, s3 = p_.sum(dim=(1, 2)), c_.sum(dim=(1, 2))
      var_p = torch.clamp((p_ * p_).sum(dim=(1, 2)) - s1 * s1 / area, min=0.0)
      var_c = torch.clamp((c_ * c_).sum(dim=(1, 2)) - s3 * s3 / area, min=0.0)
      denom = torch.sqrt(var_p * var_c)[:, None, None]
      tol = 1e3 * eps * denom
      numc = (s1 * s3 / area)[:, None, None]
      xc = circular_xcorr(p_, c_)
      corr[pure] = torch.where(
          denom > tol,
          torch.clamp((xc - numc) / torch.where(denom > tol, denom,
                                                torch.ones_like(denom)),
                      -1.0, 1.0),
          torch.zeros_like(xc))
    impure = cls == 0
    if bool(impure.any()):
      corr[impure] = padfield_ncc(pz[impure], cz[impure], va[impure],
                                  vb[impure], _rdft2, icorr, per_patch=True)
    corr = torch.roll(corr, (patch // 2, patch // 2), dims=(1, 2))
    rows = batched_peaks(corr, (patch // 2, patch // 2), min_distance,
                         threshold_rel, peak_radius)
    out.append(torch.where((cls == 2)[:, None],
                           torch.full_like(rows, float('nan')), rows))
  rows = torch.cat(out) if out else pre.new_empty((0, 4))
  if pairs is not None:
    return rows.T
  return rows.reshape(gy, gx, 4).permute(2, 0, 1).contiguous()


def _flow_fft_fits(lib, p: int, crop: int) -> bool:
  """Does K1/K2's FFT route (shared-memory FFT) serve p x p pairs with a
  crop x crop core?"""
  if lib.flow_fft_smem_bytes.argtypes is None:
    lib.flow_fft_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flow_fft_smem_bytes.restype = ctypes.c_int64
  return 0 <= int(lib.flow_fft_smem_bytes(p, crop)) <= _MAX_SMEM_BYTES


def flow_fft_config(patch: int, crop: int) -> tuple[int, int]:
  """(threads per block, resident blocks per SM) of K1/K2's FFT route on
  the current card for patch x patch pairs and a crop x crop core."""
  lib = _build.library()
  fn = lib.flow_fft_config
  if fn.argtypes is None:
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
  threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
  _build.check(fn(patch, crop, ctypes.byref(threads), ctypes.byref(blocks)),
               'flow_fft_config')
  return threads.value, blocks.value


def _launch_flow_fft(lib, pre, post, offsets, grid, patch, step, crop, mean,
                     min_distance, threshold_rel, peak_radius, out):
  fn = lib.flow_fft_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + _WINDOW_ARGTYPES + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
  radices, tabs, idx = _fft_tables(patch, patch, str(pre.device))
  h, w = pre.shape
  return fn(pre.data_ptr(), post.data_ptr(), h, w, _build.ptr(offsets),
            grid[0], grid[1], patch, step[0], step[1], radices.ctypes.data,
            tabs.data_ptr(), idx.data_ptr(), crop, int(mean is None),
            float(mean or 0.0),
            *_window_args(min_distance, threshold_rel, peak_radius),
            out.data_ptr(), _build.stream_of(pre))


def _launch_flow_dft(lib, pre, post, offsets, grid, patch, step, crop, mean,
                     min_distance, threshold_rel, peak_radius, out):
  fn = lib.flow_peaks_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the objects
    lib.flow_peaks_per_block.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flow_peaks_per_block.restype = ctypes.c_int64
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + _WINDOW_ARGTYPES
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
  gy, gx = grid
  dev = pre.device
  ctab, stab = (torch.as_tensor(t, device=dev)
                for t in _dft_tables_np(patch))
  per_block = int(lib.flow_peaks_per_block(patch, crop))
  npatch = gy * gx
  scratch = None
  if per_block * 4 <= _MAX_SMEM_BYTES:
    nblocks = npatch
  else:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(npatch, 4 * sms)
    scratch = torch.empty((nblocks, per_block), dtype=torch.float32,
                          device=dev)
  h, w = pre.shape
  rc = fn(pre.data_ptr(), post.data_ptr(), h, w, _build.ptr(offsets), gy, gx,
          patch, step[0], step[1], ctab.data_ptr(), stab.data_ptr(), crop,
          int(mean is None), float(mean or 0.0),
          *_window_args(min_distance, threshold_rel, peak_radius),
          _build.ptr(scratch), nblocks, out.data_ptr(), _build.stream_of(pre))
  _build.count('flow_peaks_dft')
  return rc


def _launch(pre, post, offsets, grid, patch, step, crop, mean, min_distance,
            threshold_rel, peak_radius, counter):
  """K1 / K2 on the card: the FFT route where it serves (patch, crop),
  else the dense-DFT route. `counter` counts every launch, whatever the
  route; the dense route also counts under 'flow_peaks_dft'."""
  _build.require_cuda('flow_peaks', pre, post)
  if offsets is not None:
    _build.require_cuda('flow_peaks offsets', offsets, dtype=torch.int32)
  lib = _build.library()
  gy, gx = grid
  out = torch.empty((4, gy, gx), dtype=torch.float32, device=pre.device)
  if gy * gx == 0:
    return out
  route = (_launch_flow_fft if _flow_fft_fits(lib, patch, crop)
           else _launch_flow_dft)
  rc = route(lib, pre, post, offsets, grid, patch, step, crop, mean,
             min_distance, threshold_rel, peak_radius, out)
  _build.count(counter)
  _build.check(rc, 'flow_peaks')
  return out


def _check_square(patch_size):
  if patch_size[0] != patch_size[1]:
    raise NotImplementedError('square patches only')
  return int(patch_size[0])


def dense_flow_peaks(pre_image: torch.Tensor, post_image: torch.Tensor,
                     patch_size=(160, 160), step=(40, 40),
                     mean: float | None = None, min_distance: Radius = 2,
                     threshold_rel: float = 0.5,
                     peak_radius: Radius = 5) -> torch.Tensor:
  """K1: flow peaks over the full dense grid -> [4, gy, gx]."""
  p = _check_square(patch_size)
  sy, sx = step
  h, w = pre_image.shape
  grid = ((h - (p - sy)) // sy, (w - (p - sx)) // sx)
  pre = pre_image.to(torch.float32).contiguous()
  post = post_image.to(torch.float32).contiguous()
  if pre.device.type == 'cpu':
    return flow_peaks_plain(pre, post, None, grid, p, (sy, sx), p, mean,
                            min_distance, threshold_rel, peak_radius)
  return _launch(pre, post, None, grid, p, (sy, sx), p, mean, min_distance,
                 threshold_rel, peak_radius, 'dense_flow_peaks')


def dense_flow_peaks_targeted(pre_image: torch.Tensor,
                              post_image: torch.Tensor,
                              post_offsets: torch.Tensor,
                              patch_size=(160, 160), step=(40, 40),
                              max_offset: int = 96, mean: float | None = None,
                              group: int | None = None, rows: int | None = None,
                              min_distance: Radius = 2,
                              threshold_rel: float = 0.5,
                              peak_radius: Radius = 5,
                              peak_crop: int | None = None) -> torch.Tensor:
  """K2: dense grid flow with per-block integer post-window offsets.

  `post_offsets`: int [nrsteps, ngroups, 2] (dy, dx) shifts of each
  `rows x group` block of patches (see `targeted_geometry`), clipped to
  +-max_offset. Returns [4, gy, gx] with x/y peaks RELATIVE to the
  shifted windows; `peak_crop` (even) restricts the peak search to the
  centered [peak_crop, peak_crop] core of each surface.
  """
  p = _check_square(patch_size)
  sy, sx = step
  h, w = pre_image.shape
  geo = targeted_geometry((h, w), patch_size, step, group, rows)
  gy, gx = geo['gy'], geo['gx']
  if tuple(post_offsets.shape) != (geo['nrsteps'], geo['ngroups'], 2):
    raise ValueError(f'post_offsets shape {tuple(post_offsets.shape)}')
  crop = p
  if peak_crop is not None:
    crop = int(peak_crop)
    if not (0 < crop <= p and crop % 2 == 0):
      raise ValueError('peak_crop must be even and <= patch size')
  md = int(max_offset)
  offs = torch.clamp(post_offsets.to(torch.int32), -md, md)
  offs = torch.repeat_interleave(offs, geo['rows'], dim=0)
  offs = torch.repeat_interleave(offs, geo['group'], dim=1)
  offs = offs[:gy, :gx].contiguous()
  pre = pre_image.to(torch.float32).contiguous()
  post = post_image.to(torch.float32).contiguous()
  if pre.device.type == 'cpu':
    return flow_peaks_plain(pre, post, offs, (gy, gx), p, (sy, sx), crop,
                            mean, min_distance, threshold_rel, peak_radius)
  return _launch(pre, post, offs, (gy, gx), p, (sy, sx), crop, mean,
                 min_distance, threshold_rel, peak_radius,
                 'targeted_flow_peaks')


def _valid_plane(valid, like: torch.Tensor) -> torch.Tensor:
  """float32 valid-pixel plane (> 0 = valid); None is all valid."""
  if valid is None:
    return torch.ones_like(like, dtype=torch.float32)
  if tuple(valid.shape) != tuple(like.shape):
    raise ValueError(f'valid plane shape {tuple(valid.shape)} != image '
                     f'shape {tuple(like.shape)}')
  return valid.to(torch.float32).contiguous()


def _masked_pure_fits(lib, p: int) -> bool:
  """Does K5's pure route (shared-memory FFT) serve p x p pairs?"""
  if lib.masked_pure_smem_bytes.argtypes is None:
    lib.masked_pure_smem_bytes.argtypes = [ctypes.c_int]
    lib.masked_pure_smem_bytes.restype = ctypes.c_int64
  return 0 <= int(lib.masked_pure_smem_bytes(p)) <= _MAX_SMEM_BYTES


def _launch_masked_pure(lib, pre, post, pairs, gx, p, step, mean,
                        min_distance, threshold_rel, peak_radius, out):
  fn = lib.masked_pure_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_float] + _WINDOW_ARGTYPES
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
  radices, tabs, idx = _fft_tables(p, p, str(pre.device))
  rc = fn(pre.data_ptr(), post.data_ptr(), pre.shape[1], pairs.data_ptr(),
          pairs.numel(), gx, p, step[0], step[1], radices.ctypes.data,
          tabs.data_ptr(), idx.data_ptr(), int(mean is None),
          float(mean or 0.0),
          *_window_args(min_distance, threshold_rel, peak_radius),
          out[0].numel(), out.data_ptr(), _build.stream_of(pre))
  _build.count('masked_flow_pure')
  _build.check(rc, 'masked_flow_peaks (pure route)')


def _launch_masked_dense(lib, pre, post, va, vb, pairs, gx, p, step, mean,
                         min_distance, threshold_rel, peak_radius, out):
  fn = lib.masked_flow_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the objects
    lib.masked_flow_per_block.argtypes = [ctypes.c_int]
    lib.masked_flow_per_block.restype = ctypes.c_int64
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_float]
                   + _WINDOW_ARGTYPES
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
  dev = pre.device
  n = pairs.numel()
  ctab, stab = (torch.as_tensor(t, device=dev) for t in _dft_tables_np(p))
  per_block = int(lib.masked_flow_per_block(p))
  scratch = None
  if per_block * 4 <= _MAX_SMEM_BYTES:
    nblocks = n
  else:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(n, 4 * sms)
    scratch = torch.empty((nblocks, per_block), dtype=torch.float32,
                          device=dev)
  rc = fn(pre.data_ptr(), post.data_ptr(), va.data_ptr(), vb.data_ptr(),
          pre.shape[1], pairs.data_ptr(), n, gx, p, step[0], step[1],
          ctab.data_ptr(), stab.data_ptr(), int(mean is None),
          float(mean or 0.0), _overlap_cut(p * p),
          *_window_args(min_distance, threshold_rel, peak_radius),
          _build.ptr(scratch), nblocks, out[0].numel(), out.data_ptr(),
          _build.stream_of(pre))
  _build.count('masked_flow_peaks')
  _build.check(rc, 'masked_flow_peaks (dense route)')


def masked_dense_flow_peaks(pre_image: torch.Tensor, post_image: torch.Tensor,
                            pre_valid: torch.Tensor | None,
                            post_valid: torch.Tensor | None,
                            patch_size=(160, 160), step=(40, 40),
                            mean: float | None = None, min_distance: Radius = 2,
                            threshold_rel: float = 0.5,
                            peak_radius: Radius = 5) -> torch.Tensor:
  """K5: masked flow peaks over the full dense grid -> [4, gy, gx].

  `pre_valid` / `post_valid`: planes of the images' shape, > 0 where a
  pixel is valid (None: all valid). Circular Padfield NCC per patch pair
  with a per-patch denominator tolerance, then the peak statistics of
  K1. The grid is classified on the device (`masked_patch_classes`) into
  three lists: dead pairs keep the NaN rows the output starts with; pure
  pairs (both patches fully valid) take the pure route, the closed-form
  NCC on the shared-memory FFT (csrc/masked_flow.cu `masked_pure_kernel`,
  p <= 160); impure pairs (and pure ones where the pure route does not
  serve p) the dense-DFT kernel (`masked_flow_kernel`: the Padfield
  chain, or the closed form for a pure pair). On CPU tensors each list
  runs through `masked_flow_peaks_plain`. The dense kernel's launches
  count under 'masked_flow_peaks', the pure route's under
  'masked_flow_pure'.
  """
  p = _check_square(patch_size)
  sy, sx = step
  h, w = pre_image.shape
  grid = ((h - (p - sy)) // sy, (w - (p - sx)) // sx)
  pre = pre_image.to(torch.float32).contiguous()
  post = post_image.to(torch.float32).contiguous()
  va = _valid_plane(pre_valid, pre)
  vb = _valid_plane(post_valid, post)
  on_cpu = pre.device.type == 'cpu'
  if not on_cpu:
    _build.require_cuda('masked_flow_peaks', pre, post, va, vb)
  gy, gx = grid
  out = torch.full((4, gy * gx), float('nan'), dtype=torch.float32,
                   device=pre.device)
  if gy * gx == 0:
    return out.reshape(4, gy, gx)
  classes = masked_patch_classes(va, vb, p, (sy, sx)).reshape(-1)
  pure, impure = (torch.nonzero(classes == c).flatten().to(torch.int32)
                  for c in (1, 0))
  args = (min_distance, threshold_rel, peak_radius)
  if on_cpu:
    for pairs in (pure, impure):
      if pairs.numel():
        out[:, pairs.long()] = masked_flow_peaks_plain(
            pre, post, va, vb, grid, p, (sy, sx), mean, *args, pairs=pairs)
    return out.reshape(4, gy, gx)
  if pure.numel() + impure.numel() == 0:
    return out.reshape(4, gy, gx)
  lib = _build.library()
  if pure.numel() and not _masked_pure_fits(lib, p):
    pure, impure = pure[:0], torch.cat([pure, impure])
  if pure.numel():
    _launch_masked_pure(lib, pre, post, pure, gx, p, (sy, sx), mean, *args,
                        out)
  if impure.numel():
    _launch_masked_dense(lib, pre, post, va, vb, impure, gx, p, (sy, sx),
                         mean, *args, out)
  return out.reshape(4, gy, gx)


def _patch_batches(pre_b, post_b):
  pre = pre_b.to(torch.float32).contiguous()
  post = post_b.to(torch.float32).contiguous()
  if pre.ndim != 3 or tuple(pre.shape) != tuple(post.shape):
    raise ValueError(f'equal [n, p1, p2] batches expected, got '
                     f'{tuple(pre.shape)} and {tuple(post.shape)}')
  return pre, post


def _centred_corr(a: torch.Tensor, b: torch.Tensor, mean) -> torch.Tensor:
  """Mean-removed circular xcorr of [b, p1, p2], zero shift at the centre."""
  if mean is None:
    a = a - a.mean(dim=(1, 2), keepdim=True)
    b = b - b.mean(dim=(1, 2), keepdim=True)
  else:
    a, b = a - mean, b - mean
  p1, p2 = a.shape[1:]
  return torch.roll(circular_xcorr(a, b), (p1 // 2, p2 // 2), dims=(1, 2))


def corr_patches_plain(pre_b: torch.Tensor, post_b: torch.Tensor,
                       mean: float | None = None) -> torch.Tensor:
  """Plain PyTorch version of K7 -> [n, p1, p2]."""
  pre, post = _patch_batches(pre_b, post_b)
  parts = [_centred_corr(pre[c:c + _PLAIN_CHUNK], post[c:c + _PLAIN_CHUNK],
                         mean) for c in range(0, pre.shape[0], _PLAIN_CHUNK)]
  return torch.cat(parts) if parts else torch.empty_like(pre)


def patch_flow_peaks_plain(pre_b: torch.Tensor, post_b: torch.Tensor,
                           mean: float | None = None, min_distance: Radius = 2,
                           threshold_rel: float = 0.5,
                           peak_radius: Radius = 5) -> torch.Tensor:
  """Plain PyTorch version of K6 -> [n, 4]."""
  pre, post = _patch_batches(pre_b, post_b)
  p1, p2 = pre.shape[1:]
  parts = [batched_peaks(
      _centred_corr(pre[c:c + _PLAIN_CHUNK], post[c:c + _PLAIN_CHUNK], mean),
      (p1 // 2, p2 // 2), min_distance, threshold_rel, peak_radius)
      for c in range(0, pre.shape[0], _PLAIN_CHUNK)]
  return torch.cat(parts) if parts else torch.empty(
      (0, 4), dtype=torch.float32, device=pre.device)


def _patch_fft_fits(lib, p1: int, p2: int) -> bool:
  """Does K6's FFT route (shared-memory FFT) serve p1 x p2 pairs?"""
  if lib.patch_fft_smem_bytes.argtypes is None:
    lib.patch_fft_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.patch_fft_smem_bytes.restype = ctypes.c_int64
  return 0 <= int(lib.patch_fft_smem_bytes(p1, p2)) <= _MAX_SMEM_BYTES


def patch_fft_config(p1: int, p2: int) -> tuple[int, int]:
  """(threads per block, resident blocks per SM) of K6's FFT route on the
  current card for p1 x p2 pairs."""
  fn = _build.library().patch_fft_config
  if fn.argtypes is None:
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
  threads, blocks = ctypes.c_int(0), ctypes.c_int(0)
  _build.check(fn(p1, p2, ctypes.byref(threads), ctypes.byref(blocks)),
               'patch_fft_config')
  return threads.value, blocks.value


def _launch_patch_fft(lib, pre, post, mean, min_distance, threshold_rel,
                      peak_radius, out):
  fn = lib.patch_fft_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the object
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_float] + _WINDOW_ARGTYPES
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
  n, p1, p2 = pre.shape
  radices, tabs, idx = _fft_tables(p1, p2, str(pre.device))
  rc = fn(pre.data_ptr(), post.data_ptr(), n, p1, p2, radices.ctypes.data,
          tabs.data_ptr(), idx.data_ptr(), int(mean is None),
          float(mean or 0.0),
          *_window_args(min_distance, threshold_rel, peak_radius),
          out.data_ptr(), _build.stream_of(pre))
  _build.count('patch_flow_peaks')
  _build.check(rc, 'patch_flow_peaks (FFT route)')


def _launch_patch_dft(lib, pre, post, mean, min_distance, threshold_rel,
                      peak_radius, out):
  fn = lib.patch_corr_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the objects
    lib.patch_corr_per_block.argtypes = [ctypes.c_int] * 2
    lib.patch_corr_per_block.restype = ctypes.c_int64
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4
                   + [ctypes.c_int, ctypes.c_float] + _WINDOW_ARGTYPES
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
  n, p1, p2 = pre.shape
  dev = pre.device
  t1c, t1s = (torch.as_tensor(t, device=dev) for t in _dft_tables_np(p1))
  t2c, t2s = (torch.as_tensor(t, device=dev) for t in _dft_tables_np(p2))
  per_block = int(lib.patch_corr_per_block(p1, p2))
  scratch = None
  if per_block * 4 <= _MAX_SMEM_BYTES:
    nblocks = n
  else:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblocks = min(n, 4 * sms)
    scratch = torch.empty((nblocks, per_block), dtype=torch.float32,
                          device=dev)
  rc = fn(pre.data_ptr(), post.data_ptr(), n, p1, p2, t1c.data_ptr(),
          t1s.data_ptr(), t2c.data_ptr(), t2s.data_ptr(),
          int(mean is None), float(mean or 0.0),
          *_window_args(min_distance, threshold_rel, peak_radius),
          _build.ptr(scratch), nblocks, out.data_ptr(), _build.stream_of(pre))
  _build.count('patch_flow_peaks_dft')
  _build.check(rc, 'patch_flow_peaks (dense route)')


def _launch_patch_peaks(pre, post, mean, min_distance, threshold_rel,
                        peak_radius):
  """K6 on the card: the FFT route where it serves (p1, p2), else the
  dense-DFT route; each route counts its own launches."""
  _build.require_cuda('patch_flow_peaks', pre, post)
  lib = _build.library()
  n, p1, p2 = pre.shape
  out = torch.empty((4, n), dtype=torch.float32, device=pre.device)
  if n == 0:
    return out.T
  route = (_launch_patch_fft if _patch_fft_fits(lib, p1, p2)
           else _launch_patch_dft)
  route(lib, pre, post, mean, min_distance, threshold_rel, peak_radius, out)
  return out.T


def flow_peaks(pre_b: torch.Tensor, post_b: torch.Tensor,
               mean: float | None = None, min_distance: Radius = 2,
               threshold_rel: float = 0.5,
               peak_radius: Radius = 5) -> torch.Tensor:
  """K6: peak statistics of pre-cut patch pairs -> [n, 4].

  `pre_b` / `post_b`: [n, p1, p2] batches (rectangular allowed). Per
  pair: mean removal (or the constant `mean`), circular correlation with
  the zero shift at (p1//2, p2//2), and the rows (x, y, sharpness,
  ratio) of flow_field._batched_peaks, NaN rows without a peak. On the
  card: the FFT route where the packed pair fits in shared memory and
  the surface in the block's registers (`patch_fft_smem_bytes` <= 226
  KB, p1 p2 <= 25 600, e.g. 160 x 80 and 160^2), counted under
  'patch_flow_peaks'; else the dense-DFT route, counted under
  'patch_flow_peaks_dft'.
  """
  pre, post = _patch_batches(pre_b, post_b)
  if pre.device.type == 'cpu':
    return patch_flow_peaks_plain(pre, post, mean, min_distance,
                                  threshold_rel, peak_radius)
  return _launch_patch_peaks(pre, post, mean, min_distance, threshold_rel,
                             peak_radius)


def corr_patches(pre_b: torch.Tensor, post_b: torch.Tensor,
                 mean: float | None = None) -> torch.Tensor:
  """K7: centred circular xcorr surfaces of pre-cut patch pairs.

  [n, p1, p2] batches in (p1, p2 <= 2048), [n, p1, p2] float32 out, the
  zero shift at (p1//2, p2//2), each patch's mean (or the constant
  `mean`) removed. On the card: one launch with each pair's working set
  in shared memory where it fits (`corr_fft_smem_bytes` <= 226 KB, e.g.
  160^2), else three launches through a global scratch buffer, in
  chunks of pairs of at most _K7_SCRATCH_BYTES.
  """
  pre, post = _patch_batches(pre_b, post_b)
  if pre.device.type == 'cpu':
    return corr_patches_plain(pre, post, mean)
  _build.require_cuda('corr_patches', pre, post)
  n, p1, p2 = pre.shape
  if max(p1, p2) > _FFT_MAX_LENGTH:
    raise ValueError(f'corr_patches: patch axes up to {_FFT_MAX_LENGTH}, '
                     f'got {p1} x {p2}')
  lib = _build.library()
  fn = lib.corr_fft_launch
  if fn.argtypes is None:  # once per library: ctypes keeps the objects
    lib.corr_fft_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.corr_fft_smem_bytes.restype = ctypes.c_int64
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
  radices, tabs, idx = _fft_tables(p1, p2, str(pre.device))
  out = torch.empty((n, p1, p2), dtype=torch.float32, device=pre.device)
  if n == 0:
    return out
  chunk, scratch = n, None
  if int(lib.corr_fft_smem_bytes(p1, p2)) > _MAX_SMEM_BYTES:
    chunk = max(1, min(n, _K7_SCRATCH_BYTES // (8 * p1 * p2)))
    scratch = torch.empty((chunk, p1, p2, 2), dtype=torch.float32,
                          device=pre.device)
  for c in range(0, n, chunk):
    m = min(chunk, n - c)
    rc = fn(pre[c].data_ptr(), post[c].data_ptr(), m, p1, p2,
            radices.ctypes.data, tabs.data_ptr(), idx.data_ptr(),
            int(mean is None), float(mean or 0.0), _build.ptr(scratch),
            out[c].data_ptr(), _build.stream_of(pre))
    _build.count('corr_patches')
    _build.check(rc, 'corr_patches')
  return out
