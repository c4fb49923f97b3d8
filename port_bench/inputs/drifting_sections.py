"""Seeded serial sections: the inputs of a traffic mix whose `inputs` is
`drifting_sections`.

One band-limited texture (white noise low-passed by a Gaussian of
`texture_sigma` cycles a pixel, scaled to [0, 255]) is made on the
device from the seed. Section z of block b is that texture moved by a
drift of `drift_px` (dy, dx) a section plus a `wobble_px` sinusoid of
period `wobble_period_px` (dy varies along x, dx along y; their phases
advance by `wobble_rate` a section and start from a phase drawn from
the seed for each block), plus, where the mix sets `jump_every`, a stage
jump of `jump_px` (dy, dx) every `jump_every` sections (cumulative),
sampled bilinearly (zero outside) and rounded to uint8. Plain torch
only: the program under test makes none of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS = 512  # rows sampled at a time


def texture(n: int, seed: int, sigma: float, device) -> torch.Tensor:
  """[n, n] float32 texture in [0, 255] from `seed`."""
  gen = torch.Generator(device=device)
  gen.manual_seed(int(seed) % (1 << 63))
  noise = torch.rand((n, n), generator=gen, device=device,
                     dtype=torch.float32)
  spec = torch.fft.rfft2(noise.double())
  del noise
  fy = torch.fft.fftfreq(n, device=device, dtype=torch.float64)[:, None]
  fx = torch.fft.rfftfreq(n, device=device, dtype=torch.float64)[None, :]
  spec *= torch.exp(-(fx ** 2 + fy ** 2) / (2 * sigma ** 2))
  tex = torch.fft.irfft2(spec, s=(n, n)).float()
  del spec
  lo, hi = tex.min(), tex.max()
  return (tex - lo) / (hi - lo) * 255.0


def _sample_bilinear(img: torch.Tensor, yy: torch.Tensor,
                     xx: torch.Tensor) -> torch.Tensor:
  """img at (yy, xx), bilinear, zero outside the image."""
  h, w = img.shape
  flat = img.reshape(-1)
  y0, x0 = torch.floor(yy), torch.floor(xx)
  fy, fx = yy - y0, xx - x0
  y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
  out = torch.zeros_like(yy)
  for oy, wy in ((0, 1.0 - fy), (1, fy)):
    for ox, wx in ((0, 1.0 - fx), (1, fx)):
      yi, xi = y0 + oy, x0 + ox
      inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
      lin = torch.where(inb, yi * w + xi, torch.zeros_like(yi))
      out += torch.where(inb, wy * wx * flat[lin], torch.zeros_like(yy))
  return out


def section(base: torch.Tensor, z: int, phase: tuple[float, float],
            mix: dict) -> torch.Tensor:
  """Section z of a block whose wobble starts at `phase` -> uint8 [n, n]."""
  n = base.shape[-1]
  dev = base.device
  ar = torch.arange(n, dtype=torch.float32, device=dev)
  (ddy, ddx), amp = mix['drift_px'], mix['wobble_px']
  (ry, rx), period = mix['wobble_rate'], mix['wobble_period_px']
  two_pi = 2 * math.pi
  every = mix.get('jump_every')
  jumps = z // every if every else 0
  jy, jx = mix.get('jump_px', (0.0, 0.0))
  dy_x = ddy * z + jy * jumps + amp * torch.sin(
      two_pi * ar / period + ry * z + phase[0])
  dx_y = ddx * z + jx * jumps + amp * torch.cos(
      two_pi * ar / period + rx * z + phase[1])
  out = torch.empty((n, n), dtype=torch.uint8, device=dev)
  for r0 in range(0, n, ROWS):
    r1 = min(n, r0 + ROWS)
    yy = ar[r0:r1, None] + dy_x[None, :]
    xx = ar[None, :] + dx_y[r0:r1, None]
    out[r0:r1] = torch.clamp(_sample_bilinear(base, yy, xx) + 0.5, 0,
                             255).to(torch.uint8)
  return out


def make(mix: dict, cfg: dict, seed: int, device) -> torch.Tensor:
  """uint8 [blocks, sections_per_block, n, n] for one traffic mix, n the
  configuration's `section_px`."""
  n = int(cfg['section_px'])
  rng = np.random.default_rng(int(seed))
  phases = rng.uniform(0.0, 2 * math.pi, size=(mix['blocks'], 2))
  base = texture(n, seed, mix['texture_sigma'], device)
  out = torch.empty((mix['blocks'], mix['sections_per_block'], n, n),
                    dtype=torch.uint8, device=device)
  for b in range(mix['blocks']):
    for z in range(mix['sections_per_block']):
      out[b, z] = section(base, z, tuple(phases[b]), mix)
  return out
