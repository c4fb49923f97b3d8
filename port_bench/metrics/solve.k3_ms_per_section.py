"""Device time of the fused FIRE solve (K3, either route) per moving
section, from the trace."""

LAYER = 'solve'
UNIT = 'ms'
SOURCE = 'device_trace'
MOVES = 'mpix_per_s'
KERNELS = ('fused_fire_kernel', 'grid_fire_kernel')


def read(ctx):
  if not ctx.sections or ctx.kernel_count(KERNELS) != ctx.sections:
    return None
  return 1e3 * ctx.kernel_seconds(KERNELS) / ctx.sections
