"""Work of the render kernel (K4, the gather), counted from the shapes
alone: each output pixel reads its float32 source once (4 bytes), its
(y, x) float32 position (8) and writes its float32 value (4), and takes
a number of operations set by the method: Lanczos4 ~350 (16 weights of
~12, 64 taps of 2, the row sums and the norm), nearest ~12 (two offsets,
their floors and fractions, the compares, the index)."""

from __future__ import annotations

from port_bench.work import peaks

FLOPS_PX = {'lanczos': 350, 'nearest': 12}
LANCZOS_FLOPS_PX = FLOPS_PX['lanczos']
BYTES_PX = 16


def section_seconds(n: int, method: str = 'lanczos') -> float:
  return peaks.least_seconds(BYTES_PX * n * n, FLOPS_PX[method] * n * n)
