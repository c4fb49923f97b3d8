"""What a driver's measured window did, which the end-to-end readers
read."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
  t0: float                     # perf_counter at the window's start
  t_end: float                  # ... at the last completion
  sections: int                 # moving sections finished
  latencies: list               # seconds from hand-over to return, a section
  call_seconds: list            # seconds a call (block mode)
  kept: object                  # what the driver kept for the check

  @property
  def wall(self) -> float:
    return self.t_end - self.t0
