"""BENCHMARK.json against the benchmark contract's rules of form, and
every file the harness finds by name."""

import json
import re

from bench_helpers import ROOT

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
LINE = re.compile(r'^[^\t\n\r]{1,200}$')


def bench():
  return json.loads((ROOT / 'BENCHMARK.json').read_text())


def test_top_level_keys():
  b = bench()
  assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                    'workloads', 'end_to_end', 'per_layer'}
  assert 1 <= b['run_seconds'] <= 51 and isinstance(b['run_seconds'], int)
  assert 1 <= len(b['paths']) <= 16
  assert all(PATH.match(p) and not p.startswith('/') and '..' not in p
             for p in b['paths'])
  assert len(b['command']) <= 32
  assert all(LINE.match(w) for w in b['command'])
  assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_names_and_units():
  b = bench()
  names = []
  for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
    for entry in b[group]:
      assert NAME.match(entry['name']), entry['name']
      names.append((group in ('end_to_end', 'per_layer'), entry['name']))
      if 'unit' in entry:
        assert UNIT.match(entry['unit']), entry['unit']
      for key in ('why', 'layer', 'source'):
        if key in entry and group != 'end_to_end' and group != 'per_layer':
          assert LINE.match(entry[key])
      if group == 'per_layer':
        assert LINE.match(entry['layer'])
  assert len(names) == len(set(names))
  for w in b['workloads']:
    assert NAME.match(w['config']) and NAME.match(w['traffic'])
  for c in b['configs']:
    assert len(c['reduced']) <= 16
    assert all(NAME.match(k) for k in c['reduced'])


def test_entry_keys():
  b = bench()
  for c in b['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
  for w in b['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] in (1, 4)
  for m in b['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0 < m['bound'] <= 0.25
  for m in b['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
  for group in ('end_to_end', 'per_layer'):
    for m in b[group]:
      assert m['better'] in ('lower', 'higher')
  assert 'setup_s' in {m['name'] for m in b['end_to_end']}


def test_every_cell_reports_enough():
  b = bench()
  e2e = {m['name']: m for m in b['end_to_end']}
  for w in b['workloads']:
    def reports(m):
      return 'workloads' not in m or w['name'] in m['workloads']
    got = [m['name'] for m in b['end_to_end'] if reports(m)]
    assert 'setup_s' in got and len(got) >= 2
    layer = [m for m in b['per_layer'] if reports(m)]
    assert layer
    for m in layer:
      assert reports(e2e[m['moves']])


def test_files_found_by_name():
  from port_bench.harness import spec
  b = bench()
  config_files = [c['file'] for c in b['configs']]
  assert len(config_files) == len(set(config_files))
  for c in b['configs']:
    assert c['file'].startswith('port_bench/')
    assert json.loads((ROOT / c['file']).read_text())['name'] == c['name']
  for w in b['workloads']:
    cell = spec.load_cell(w['name'], ROOT)
    assert set(cell.limits) == set(spec.check(cell).NAMES)
    assert callable(spec.check(cell).judge)
    assert callable(spec.inputs(cell).make)
    drv = spec.driver(cell)
    assert callable(drv.prepare) and callable(drv.spans)
    assert hasattr(drv.Driver, 'window') and hasattr(drv.Driver, 'warm_up')
  for m in b['end_to_end']:
    reader = spec.end_to_end_reader(m['name'])
    assert (reader.UNIT, reader.BETTER, reader.SOURCE) == (
        m['unit'], m['better'], m['source'])
    assert callable(reader.read)
  for m in b['per_layer']:
    reader = spec.metric_reader(m['name'])
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        m['layer'], m['unit'], m['source'], m['moves'])
    assert callable(reader.read)
