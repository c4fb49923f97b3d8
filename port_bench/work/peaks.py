"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates at
the full 700 W power limit), and the least time a piece of work takes.

The least time is the larger of the bytes it must move over the HBM
bandwidth and the float32 operations it must do over the float32 rate
outside the tensor cores (the port's kernels correlate, solve and
render in float32 on the CUDA cores).
"""

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
  return max(nbytes / HBM_BYTES_S, flops / F32_FLOP_S)
