"""Share of its roofline that the render kernel (K4, the gather, in the
configuration's `method`) reaches: the least time of one section's
render counted from the shapes (port_bench/work/render.py) times the
launches, over their device time in the trace."""

from port_bench.work import render as work

LAYER = 'render'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'mpix_per_s'
KERNELS = ('warp_gather_kernel',)


def read(ctx):
  launches = ctx.kernel_count(KERNELS)
  seconds = ctx.kernel_seconds(KERNELS)
  if not ctx.sections or launches != ctx.sections or seconds <= 0:
    return None
  bound = launches * work.section_seconds(ctx.n, ctx.cfg['method'])
  return 100.0 * bound / seconds
