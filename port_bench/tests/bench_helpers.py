"""Helpers of the benchmark's CPU tests: the repository root on sys.path,
and small cells (480^2 sections, 3 a block) built from the committed
files. A small cell's solve stops after 2 000 FIRE steps, which both
sides count alike: on a 12 x 12 mesh em_2d's relaxation takes tens of
thousands of plain steps to settle."""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
  sys.path.insert(0, str(ROOT))


def small_cell(workload: str, n: int = 480, z: int = 3):
  from port_bench.harness import spec
  cell = spec.load_cell(workload, ROOT)
  cell.config = dict(cell.config, section_px=n,
                     mesh=dict(cell.config['mesh'], max_iters=2000))
  check = dict(cell.traffic['check'], sections=1)
  if 'calls_drawn_from' in check:
    check['calls_drawn_from'] = 1
  cell.traffic = dict(cell.traffic, sections_per_block=z, blocks=1,
                      check=check)
  return cell


def run_small(workload: str, seed: int = 2 ** 31 + 11, **kwargs):
  """One CPU run of a small cell with a window that ends after its first
  call or section."""
  from port_bench.harness import cell as cell_lib
  return cell_lib.run(small_cell(workload), seed, 0.01, False, 'cpu',
                      time.perf_counter(), **kwargs)
