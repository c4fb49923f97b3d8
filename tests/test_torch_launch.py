"""sofima_tpu_torch.parallel.launch's failure paths (CPU, gloo ranks).

A rank that exits non-zero, or a run that outlives its timeout, fails the
whole run at once: every rank is stopped, and the RuntimeError names the
cause and carries each rank's output. A run does not wait out its
timeout for a rank that has already failed.
"""

import time

import pytest

from sofima_tpu_torch.parallel import distributed as tdist
from sofima_tpu_torch.parallel import launch


def _rank_fails_or_sleeps():
  if tdist.process_index() == 1:
    raise ValueError('rank 1 gives up')
  time.sleep(600)


def _rank_sleeps():
  time.sleep(600)


def test_first_failure_stops_every_rank(tmp_path):
  start = time.monotonic()
  with pytest.raises(RuntimeError, match='rank 1 exited with 1') as failed:
    launch.run(f'{__file__}:_rank_fails_or_sleeps', 2, 'gloo',
               workdir=tmp_path, timeout=240)
  assert time.monotonic() - start < 120
  assert 'rank 1 gives up' in str(failed.value)


def test_timeout_stops_every_rank(tmp_path):
  start = time.monotonic()
  with pytest.raises(RuntimeError, match='timed out'):
    launch.run(f'{__file__}:_rank_sleeps', 2, 'gloo', workdir=tmp_path,
               timeout=5)
  assert time.monotonic() - start < 120
