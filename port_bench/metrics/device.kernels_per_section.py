"""Kernels the device ran in the traced window per moving section (copies
and fills not counted)."""

LAYER = 'device'
UNIT = 'kernels/section'
SOURCE = 'device_trace'
MOVES = 'mpix_per_s'


def read(ctx):
  return len(ctx.trace.kernels) / ctx.sections if ctx.sections else None
