"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import pathlib
import subprocess
import sys

from bench_helpers import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'sofima_tpu'}


def _loaded_after(code: str) -> set:
  probe = (f'import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; '
           'print(sorted({m.split(".")[0] for m in sys.modules}))')
  out = subprocess.run([sys.executable, '-c', probe], capture_output=True,
                       text=True, check=True, cwd=ROOT)
  return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_reference_load_no_jax():
  loaded = _loaded_after(
      'import port_bench.run; from port_bench.harness import cell, spec, '
      'trace; from port_bench.reference import chain; '
      'from port_bench.tools import faults, readings; '
      'from port_bench.drivers import _stack; '
      '[spec.driver(c) and spec.inputs(c) and spec.check(c) '
      ' for c in map(spec.load_cell, ("em2d.stack16", "em2d.stream"))]; '
      '[spec.module(k, p.stem) for k in ("end_to_end", "metrics") '
      ' for p in (spec.BENCH_DIR / k).glob("*.py") if p.stem != "__init__"]; '
      '_stack.stack_config(spec.load_cell("em2d.stack16").config)')
  assert not loaded & FORBIDDEN
  assert 'sofima_tpu_torch' in loaded  # the program itself does load


def test_reference_loads_nothing_of_the_program():
  loaded = _loaded_after('from port_bench.reference import chain')
  assert 'sofima_tpu_torch' not in loaded and not loaded & FORBIDDEN
  for path in (ROOT / 'port_bench' / 'reference').glob('*.py'):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
      names = []
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or '']
      for name in names:
        assert name.split('.')[0] not in FORBIDDEN | {'sofima_tpu_torch'}, (
            path.name, name)
        if name.split('.')[0] == 'port_bench':
          assert name.startswith('port_bench.reference'), (path.name, name)
