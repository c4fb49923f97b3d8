"""Share of their roofline that the flow kernels (K1, the coarse pass;
K2, the fine pass) reach: the least time of both passes on every pair
of the window, counted from the shapes (port_bench/work/flow.py), over
the device time of their launches in the trace. Nothing is read unless
the trace holds exactly two launches a pair."""

from port_bench.work import flow as work

LAYER = 'flow'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'mpix_per_s'
KERNELS = ('flow_fft_kernel', 'flow_peaks_kernel')


def read(ctx):
  launches = ctx.kernel_count(KERNELS)
  seconds = ctx.kernel_seconds(KERNELS)
  if not ctx.sections or launches != 2 * ctx.sections or seconds <= 0:
    return None
  bound = ctx.sections * work.pair_seconds(ctx.n, ctx.cfg['patch'],
                                           ctx.cfg['stride'])
  return 100.0 * bound / seconds
