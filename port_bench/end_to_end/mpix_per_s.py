"""Moving-section pixels finished, (sections - anchors) x n^2, over the
wall from the window's start to the last completion (a call started
before the window's end is waited for and counted)."""

UNIT = 'Mpix/s'
BETTER = 'higher'
SOURCE = 'host_clock'


def read(ctx):
  win = ctx.window
  if not win.sections or win.wall <= 0:
    return None
  return win.sections * ctx.n * ctx.n / 1e6 / win.wall
