"""Faults planted in the timed path, for showing that the correctness
check fails them. Each is a context manager that swaps one phase
function of the alignment entry (pipeline/stack_align.py) for a broken
one while it is active:

  unchanged  the solve returns the mesh it was handed (a step that
             returns its state unchanged)
  half       the lower half of each pair's flow grid is left out (NaN):
             half of the batch of patch pairs measures nothing
  altered    each rendered section is moved by one pixel where it is
             produced (an answer altered)
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def planted(name: str):
  from sofima_tpu_torch.pipeline import stack_align
  attr, make = FAULTS[name]
  original = getattr(stack_align, attr)
  setattr(stack_align, attr, make(original))
  try:
    yield
  finally:
    setattr(stack_align, attr, original)


def _unchanged(solve):
  def broken(flow_full, solved_prev, cfg):
    del flow_full, cfg
    return solved_prev.clone()
  return broken


def _half(flow):
  def broken(*args, **kwargs):
    full, overflow = flow(*args, **kwargs)
    full = full.clone()
    full[..., full.shape[-2] // 2:, :] = float('nan')
    return full, overflow
  return broken


def _altered(render):
  def broken(*args, **kwargs):
    img, overflow = render(*args, **kwargs)
    return torch.roll(img, 1, dims=-1), overflow
  return broken


FAULTS = {
    'unchanged': ('_solve_phase', _unchanged),
    'half': ('_flow_phase', _half),
    'altered': ('_render_phase', _altered),
}
