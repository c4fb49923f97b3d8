"""Work of the flow layer's correlation kernels (K1, the coarse pass;
K2, the targeted fine pass), counted from the shapes alone.

A patch pair's circular cross-correlation of N = p^2 points takes three
real 2d FFTs (2.5 N log2 N operations each, half a complex FFT's
5 N log2 N), the spectrum product and the peak search (~8 a point):
the same count whichever route (shared-memory FFT or dense DFT) runs the
pair. A pass reads both float32 images once and writes 16 bytes of peak
statistics a patch (K2 also reads its 8-byte block moves).
"""

from __future__ import annotations

import math

from port_bench.work import peaks


def xcorr_flops(p: int) -> float:
  n = p * p
  return 3 * 2.5 * n * math.log2(n) + 8 * n


def pass_seconds(n: int, patch: int, step: int, extra_bytes: float = 0.0
                 ) -> float:
  """Least time of one pass over an n x n pair: patches of `patch` at
  `step`."""
  g = (n - (patch - step)) // step
  nbytes = 2 * n * n * 4 + 16 * g * g + extra_bytes
  return peaks.least_seconds(nbytes, g * g * xcorr_flops(patch))


def pair_seconds(n: int, patch: int, stride: int) -> float:
  """Least time of K1 (patch at step patch) plus K2 (patch // 2 at the
  stride, with its block moves) on one section pair."""
  fine = patch // 2
  g_f = (n - (fine - stride)) // stride
  blocks = -(-g_f // 4) * -(-g_f // 16)
  return (pass_seconds(n, patch, patch)
          + pass_seconds(n, fine, stride, extra_bytes=8 * blocks))
