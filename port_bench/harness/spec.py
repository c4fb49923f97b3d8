"""Finds a cell's pieces by name: BENCHMARK.json at the checkout's root,
the configuration's file, the traffic mix's file (traffic/<name>.json)
and the cell's limits (limits/<workload>.json); and the code each of
them names, one module a name:

  drivers/<traffic's driver>.py   the entry driven in the window
  inputs/<traffic's inputs>.py    the inputs made from the seed
  checks/<config's check>.py      the comparison with the plain reference
  end_to_end/<metric>.py          each end-to-end metric's reader
  metrics/<metric>.py             each per-layer metric's reader

A cell, configuration, traffic mix, driver, check or metric is added by
adding its files and its entry; nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict
  traffic: dict
  limits: dict
  end_to_end: list   # BENCHMARK.json entries this cell reports
  per_layer: list


def _reports(metric: dict, workload: str) -> bool:
  return 'workloads' not in metric or workload in metric['workloads']


def load_bench(root: pathlib.Path = ROOT) -> dict:
  return json.loads((root / 'BENCHMARK.json').read_text())


def load_cell(workload: str, root: pathlib.Path = ROOT) -> Cell:
  bench = load_bench(root)
  cells = {w['name']: w for w in bench['workloads']}
  if workload not in cells:
    raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
  w = cells[workload]
  cfg_entry = {c['name']: c for c in bench['configs']}[w['config']]
  config = json.loads((root / cfg_entry['file']).read_text())
  traffic = json.loads((BENCH_DIR / 'traffic' / f'{w["traffic"]}.json')
                       .read_text())
  limits = json.loads((BENCH_DIR / 'limits' / f'{workload}.json').read_text())
  return Cell(name=workload, chips=int(w['chips']), config=config,
              traffic=traffic, limits=limits,
              end_to_end=[m for m in bench['end_to_end']
                          if _reports(m, workload)],
              per_layer=[m for m in bench['per_layer']
                         if _reports(m, workload)])


def module(kind: str, name: str):
  """The module of <kind>/<name>.py under the benchmark's folder (kind:
  drivers, inputs, checks, end_to_end or metrics), loaded once."""
  qual = f'port_bench.{kind}.' + name.replace('.', '_').replace('-', '_')
  if qual in sys.modules:
    return sys.modules[qual]
  path = BENCH_DIR / kind / f'{name}.py'
  if not path.is_file():
    raise FileNotFoundError(f'no {kind} module {name!r} ({path})')
  spec = importlib.util.spec_from_file_location(qual, path)
  mod = importlib.util.module_from_spec(spec)
  sys.modules[qual] = mod
  spec.loader.exec_module(mod)
  return mod


def driver(cell: Cell):
  return module('drivers', cell.traffic['driver'])


def inputs(cell: Cell):
  return module('inputs', cell.traffic['inputs'])


def check(cell: Cell):
  return module('checks', cell.config['check'])


def metric_reader(name: str):
  """The per-layer reader metrics/<name>.py (LAYER, UNIT, SOURCE, MOVES,
  read)."""
  return module('metrics', name)


def end_to_end_reader(name: str):
  """The end-to-end reader end_to_end/<name>.py (UNIT, BETTER, SOURCE,
  read)."""
  return module('end_to_end', name)
