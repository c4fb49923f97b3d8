"""Set-up: from the process's start to the start of the measured window
(imports, the kernel library built or loaded, the inputs made on the
device, the warm-up)."""

UNIT = 's'
BETTER = 'lower'
SOURCE = 'host_clock'


def read(ctx):
  return ctx.setup_s
