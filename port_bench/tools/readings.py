"""Readings that the correctness limits are set from, on the card.

  python3 port_bench/tools/readings.py --workload <name> \
      --seeds <s1,s2,...> [--control-seeds <c1,...>] [--faults] \
      [--seconds <s>] [--out <file.jsonl>]

In one process (the kernels built once): a short window of the cell at
its own sizes and load on each seed, with the program's outputs checked
against the reference (the lower readings); then the bfloat16 control in
the program's place on each control seed (the upper readings); then,
with --faults, each planted fault (port_bench/tools/faults.py) on the
first control seed. One JSON line a run: its kind, seed and the numbers
compared.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seeds', required=True)
  ap.add_argument('--control-seeds', default='')
  ap.add_argument('--faults', action='store_true')
  ap.add_argument('--seconds', type=float, default=4.0)
  ap.add_argument('--out', default=None)
  args = ap.parse_args()
  os.environ['SOFIMA_TORCH_BUILD_DIR'] = str(ROOT / 'build' / 'port_bench'
                                             / 'kernels')
  sys.path.insert(0, str(ROOT))
  from port_bench.harness import cell as cell_lib
  from port_bench.harness import spec
  from port_bench.tools import faults
  cell = spec.load_cell(args.workload, ROOT)
  runs = [('program', int(s), None) for s in args.seeds.split(',') if s]
  runs += [('control', int(s), None) for s in args.control_seeds.split(',')
           if s]
  if args.faults and args.control_seeds:
    first = int(args.control_seeds.split(',')[0])
    runs += [('fault:' + f, first, f) for f in faults.FAULTS]
  out = open(args.out, 'a') if args.out else None
  for kind, seed, fault in runs:
    t = time.perf_counter()
    if fault:
      with faults.planted(fault):
        res = cell_lib.run(cell, seed, args.seconds, False, 'cuda', t)
    else:
      res = cell_lib.run(cell, seed, args.seconds, False, 'cuda', t,
                         control=kind == 'control')
    row = {'workload': args.workload, 'kind': kind, 'seed': seed,
           'correct': res['correct'], 'attempted': res['attempted'],
           'metrics': {k: v['value'] for k, v in res['metrics'].items()},
           'checks': {k: v['value'] for k, v in res['checks'].items()},
           'seconds': time.perf_counter() - t}
    line = json.dumps(row)
    print(line, flush=True)
    if out:
      out.write(line + '\n')
      out.flush()
  return 0


if __name__ == '__main__':
  sys.exit(main())
