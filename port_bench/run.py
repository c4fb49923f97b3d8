"""The port's benchmark: one run of one cell.

  python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> \
      --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for. Builds (or loads from build/port_bench/, inside the checkout) the
program's kernels, makes the cell's sections on the card from the seed,
warms up the cell's shapes, measures for `--seconds`, checks the
window's outputs against the plain reference, and prints one JSON line
last on standard output: with `--trace 0` the cell's end-to-end metrics,
with `--trace 1` its per-layer metrics from a torch.profiler trace of
the window. The numbers compared with their limits are printed last on
standard error and last in the line. Exits non-zero with no line when
the card is missing, when the program is not in the checkout, or when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'sofima_tpu')


def _process_age() -> float:
  """Seconds since this process started (0 where /proc cannot tell)."""
  try:
    start = int(open('/proc/self/stat').read().rsplit(')', 1)[1].split()[19])
    uptime = float(open('/proc/uptime').read().split()[0])
    return max(0.0, uptime - start / os.sysconf('SC_CLK_TCK'))
  except (OSError, ValueError, IndexError):
    return 0.0


def _finite(x):
  """JSON-safe numbers: inf and NaN as the largest float and null."""
  if isinstance(x, dict):
    return {k: _finite(v) for k, v in x.items()}
  if isinstance(x, list):
    return [_finite(v) for v in x]
  if isinstance(x, float) and not math.isfinite(x):
    return None if math.isnan(x) else math.copysign(1.7976931348623157e308, x)
  return x


def forbidden_modules() -> list[str]:
  return sorted({m.split('.')[0] for m in sys.modules
                 if m.split('.')[0] in FORBIDDEN})


def main(argv=None) -> int:
  t_start = T_START - _process_age()
  ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  if not (ROOT / 'sofima_tpu_torch' / '__init__.py').is_file():
    print('the program (sofima_tpu_torch/) is not in this checkout',
          file=sys.stderr)
    return 2
  os.environ['SOFIMA_TORCH_BUILD_DIR'] = str(ROOT / 'build' / 'port_bench'
                                             / 'kernels')
  sys.path.insert(0, str(ROOT))

  import torch  # noqa: E402
  from port_bench.harness import cell as cell_lib  # noqa: E402
  from port_bench.harness import spec  # noqa: E402

  cell = spec.load_cell(args.workload, ROOT)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f'{args.workload} needs {cell.chips} CUDA device(s); found '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
          file=sys.stderr)
    return 3
  import sofima_tpu_torch  # noqa: E402
  if ROOT not in pathlib.Path(sofima_tpu_torch.__file__).resolve().parents:
    print('sofima_tpu_torch was not imported from this checkout',
          file=sys.stderr)
    return 2
  result = cell_lib.run(cell, args.seed, args.seconds, bool(args.trace),
                        'cuda', t_start)
  loaded = forbidden_modules()
  if loaded:
    print(f'modules that must not load were loaded: {loaded}',
          file=sys.stderr)
    return 4
  for name, row in result['checks'].items():
    print(f'check {name} {row["value"]!r} limit {row["limit"]!r}',
          file=sys.stderr)
  print(json.dumps(_finite(result)))
  return 0


if __name__ == '__main__':
  sys.exit(main())
