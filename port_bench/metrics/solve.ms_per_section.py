"""Solve (compose and FIRE relaxation) wall per moving section: the solve phase of the
alignment entry's own phase clock (`timings=`, which synchronizes at
each phase), summed over the calls made untraced before the traced
window, over their moving sections."""

LAYER = 'solve'
UNIT = 'ms'
SOURCE = 'program_span'
MOVES = 'mpix_per_s'


def read(ctx):
  t = ctx.timings.get('solve')
  if t is None or not ctx.timing_sections:
    return None
  return 1e3 * t / ctx.timing_sections
