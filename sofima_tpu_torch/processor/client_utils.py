"""Block bookkeeping helpers for hierarchical (blockwise) alignment.

Twin of sofima_tpu/processor/client_utils.py.
"""

from __future__ import annotations

import bisect
from typing import Sequence


def get_block_id(z: int, sorted_block_starts: Sequence[int],
                 backward: bool = False) -> int:
  """Index of the block containing section `z`.

  Forward: block i spans [starts[i], starts[i+1]). Backward optimization
  treats a start section as belonging to the *preceding* block (it is the
  last section optimized there).
  """
  if backward:
    return bisect.bisect_left(sorted_block_starts, z)
  return bisect.bisect_right(sorted_block_starts, z)
