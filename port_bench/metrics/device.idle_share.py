"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window."""

LAYER = 'device'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'mpix_per_s'


def read(ctx):
  if ctx.trace.window_s <= 0:
    return None
  return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
