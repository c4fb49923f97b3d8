"""What the stack-alignment drivers (block, stream) share: the program's
StackAlignConfig from a configuration file, the kernel library, the
sections to check drawn from the seed, and the layer spans of a traced
window."""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

PHASES = ('_flow_phase', '_solve_phase', '_invert_phase', '_render_phase')


def prepare(device) -> None:
  """Builds the program's kernels, or loads them from its build
  directory."""
  if torch.device(device).type == 'cuda':
    from sofima_tpu_torch.ops import _build
    _build.library()


def stack_config(cfg: dict):
  """The program's StackAlignConfig from a configuration file's dict: its
  keys that are the config's fields, the mesh as an IntegrationConfig."""
  from sofima_tpu_torch import mesh as mesh_lib
  from sofima_tpu_torch.pipeline import stack_align
  fields = {f.name for f in dataclasses.fields(stack_align.StackAlignConfig)}
  kw = {k: v for k, v in cfg.items() if k in fields and k != 'mesh'}
  m = dict(cfg['mesh'])
  m['stride'] = tuple(float(s) for s in m['stride'])
  return stack_align.StackAlignConfig(mesh=mesh_lib.IntegrationConfig(**m),
                                      **kw)


def sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def checked_sections(mix: dict, seed: int) -> list:
  """The block's first moving section, and `check.sections` more drawn
  from the seed among sections 2 .. sections_per_block - 1."""
  rng = np.random.default_rng([int(seed), 1])
  more = rng.choice(np.arange(2, mix['sections_per_block']),
                    size=mix['check']['sections'], replace=False)
  return [1] + sorted(int(z) for z in more)


def drawn_call(mix: dict, seed: int) -> int:
  """Which of the window's first `check.calls_drawn_from` calls is
  checked."""
  rng = np.random.default_rng([int(seed), 2])
  return int(rng.integers(0, mix['check']['calls_drawn_from']))


@contextlib.contextmanager
def layer_spans():
  """Wraps the entry's phase functions in profiler spans named
  port_bench.<layer> while active; restores them after."""
  from sofima_tpu_torch.pipeline import stack_align
  saved = {name: getattr(stack_align, name) for name in PHASES}

  def wrap(name, fn):
    label = 'port_bench.' + name.strip('_').split('_')[0]

    @functools.wraps(fn)
    def spanned(*args, **kwargs):
      with torch.profiler.record_function(label):
        return fn(*args, **kwargs)
    return spanned

  try:
    for name, fn in saved.items():
      setattr(stack_align, name, wrap(name, fn))
    yield
  finally:
    for name, fn in saved.items():
      setattr(stack_align, name, fn)
