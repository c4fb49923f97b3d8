"""Runs one function on N ranks, each a child process of this Python.

No `sofima_tpu` twin: the reference's one controller drives every device
of a jax Mesh, where a torch.distributed job has one process per rank.
`run` starts the ranks as subprocesses of `sys.executable` (not
`multiprocessing`, whose children re-import the caller's `__main__`),
each on this module's entry:

    python -m sofima_tpu_torch.parallel.launch <request.pkl> <rank>

The request names the function ('path/to/file.py:name' or
'package.module:name'), the world size, the backend and the arguments.
Each rank finds the rendezvous in the reference's environment variables
(SOFIMA_COORDINATOR, a FileStore in the run's directory so that two
runs at once never race for a TCP port; SOFIMA_NUM_PROCESSES;
SOFIMA_PROCESS_ID), joins the default group through
`distributed.initialize(backend=...)` (a no-op for one rank), calls the
function and pickles what it returns. A rank that exits non-zero or outlives
`timeout` fails the run: every rank is stopped and the RuntimeError
carries the end of each rank's output.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def run(target: str, world_size: int, backend: str = 'nccl',
        args: tuple = (), workdir=None, timeout: float = 600.0) -> list:
  """Calls `target(*args)` on `world_size` ranks, one thread each;
  returns their results in rank order."""
  with tempfile.TemporaryDirectory(dir=workdir, prefix='ranks') as tmp:
    tmp = pathlib.Path(tmp)
    request = tmp / 'request.pkl'
    request.write_bytes(pickle.dumps(dict(
        target=target, backend=backend, args=args)))
    child_env = dict(os.environ, OMP_NUM_THREADS='1')
    child_env['PYTHONPATH'] = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get('PYTHONPATH')) if p)
    child_env.update(SOFIMA_COORDINATOR=f'file://{tmp / "store"}',
                     SOFIMA_NUM_PROCESSES=str(world_size))
    procs, logs = [], []
    try:
      for rank in range(world_size):
        logs.append(open(tmp / f'rank{rank}.log', 'w+b'))
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'sofima_tpu_torch.parallel.launch',
             str(request), str(rank)],
            env=dict(child_env, SOFIMA_PROCESS_ID=str(rank)),
            stdout=logs[-1], stderr=subprocess.STDOUT))
      failure = _wait(procs, time.monotonic() + timeout)
      _stop(procs)
      if failure:
        tails = []
        for rank, log in enumerate(logs):
          log.seek(0)
          tails.append(f'--- rank {rank} (exit {procs[rank].returncode}) '
                       f'---\n' + log.read()[-4000:].decode(errors='replace'))
        raise RuntimeError(f'{target} on {world_size} ranks: {failure}\n'
                           + '\n'.join(tails))
    finally:
      _stop(procs)
      for log in logs:
        log.close()
    return [pickle.loads((tmp / f'result{r}.pkl').read_bytes())
            for r in range(world_size)]


def _wait(procs, deadline: float) -> str | None:
  """Waits for every rank; the first failure (or the timeout) as text."""
  while True:
    codes = [p.poll() for p in procs]
    bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
    if bad:
      return f'rank {bad[0]} exited with {codes[bad[0]]}'
    if all(c == 0 for c in codes):
      return None
    if time.monotonic() > deadline:
      return 'timed out'
    time.sleep(0.05)


def _stop(procs) -> None:
  for p in procs:
    if p.poll() is None:
      p.kill()
    p.wait()


def _resolve(target: str):
  where, name = target.rsplit(':', 1)
  if where.endswith('.py'):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(where).stem, where)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
  else:
    module = importlib.import_module(where)
  return getattr(module, name)


def _main(request_path: str, rank: int) -> None:
  import torch
  import torch.distributed as dist
  from sofima_tpu_torch.parallel import distributed

  request = pickle.loads(pathlib.Path(request_path).read_bytes())
  fn = _resolve(request['target'])
  torch.set_num_threads(1)
  distributed.initialize(backend=request['backend'])
  result = fn(*request['args'])
  (pathlib.Path(request_path).parent / f'result{rank}.pkl').write_bytes(
      pickle.dumps(result))
  if dist.is_initialized():
    dist.destroy_process_group()


if __name__ == '__main__':
  _main(sys.argv[1], int(sys.argv[2]))
