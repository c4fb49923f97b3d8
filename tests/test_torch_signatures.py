"""Signatures of sofima_tpu_torch's public functions against sofima_tpu's (CPU).

The reference's own calls must work on the port. Each function below
takes the reference's parameters in the reference's order, with its
names and defaults; the port may only add parameters at the end
(`device`, `timings`). `test_public_surface_matches_reference` walks
every module of the port that has a counterpart in sofima_tpu: each
public function, class and class method of the reference's module must
exist in the port's with the same parameter names, order and defaults,
apart from the exceptions listed in `SURFACE_EXCEPTIONS` with their
reasons. Then the calls that once raised or shifted:
  * masked_xcorr(..., use_jax=True, dim=2, per_item=True), as
    sofima_tpu/stitch_rigid.py calls it, and a dim=3 call over a batch,
    each against the reference within atol 1e-4 (test_torch_montage.py's
    masked NCC bar);
  * coarse_to_fine_flow(..., batch_size=..., bf16=True) by keyword:
    equal to the call without them (the port computes in float32 and
    sizes its own launches) and to the reference's float32 flow.
"""

import dataclasses
import enum
import importlib
import inspect
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sofima_tpu import flow_field as jff
from sofima_tpu.pipeline import stitch3d as js3
from sofima_tpu_torch import flow_field as tff
from sofima_tpu_torch.pipeline import stitch3d as ts3

torch.set_num_threads(2)

# (reference, port, parameters the port may add at the end)
CASES = {
    'coarse_to_fine_flow': (jff.coarse_to_fine_flow, tff.coarse_to_fine_flow,
                            ()),
    'masked_xcorr': (jff.masked_xcorr, tff.masked_xcorr, ()),
    'dense_flow_field': (jff.dense_flow_field, tff.dense_flow_field, ()),
    'stitch_and_render_3d': (js3.stitch_and_render_3d,
                             ts3.stitch_and_render_3d, ('device', 'timings')),
}


def _params(fn):
  fn = inspect.unwrap(fn)
  return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize('name', sorted(CASES))
def test_signature_matches_reference(name):
  ref_fn, port_fn, extra = CASES[name]
  ref, port = _params(ref_fn), _params(port_fn)
  assert [n for n, _ in port[:len(ref)]] == [n for n, _ in ref]
  for (n, d_port), (_, d_ref) in zip(port, ref):
    if d_ref is inspect.Parameter.empty:
      assert d_port is inspect.Parameter.empty, n
    else:
      assert d_port == d_ref, (n, d_port, d_ref)
  assert tuple(n for n, _ in port[len(ref):]) == extra


# Parameters the port adds after the reference's, on any function. The
# processor layer's one difference is the trailing `device` of every
# processor constructor (and of runner.process_volume); the parallel
# package's `initialize` takes the process group's `backend`.
EXTRA_PARAMS = ('device', 'timings', 'backend')

# The processor layer and its volume foundation: 17 modules.
PROCESSOR_LAYER = (
    'utils.subvolume', 'utils.volume', 'utils.metrics', 'utils.config_utils',
    'utils.mask', 'ops.edt', 'processor.base', 'processor.runner',
    'processor.client_utils', 'processor.flow', 'processor.mesh',
    'processor.maps', 'processor.warp', 'processor.defaults.em_2d',
    'pipeline.flow_config', 'pipeline.mesh_config', 'pipeline.warp_config')

# The decorator layer with its registration primitives and the solver
# checkpoint: 7 modules.
DECORATOR_LAYER = (
    'decorators.base', 'decorators.flow', 'decorators.maps',
    'decorators.warp', 'decorators.affine', 'ops.registration',
    'utils.checkpoint')

# (module, name) -> why the port differs there on purpose.
SURFACE_EXCEPTIONS = {
    **{('ops.shift_warp', name): 'a TPU shift-lattice planner or its '
       'caller; the port gathers every tap and needs none of them '
       '(ROADMAP.md, "Deliberately not queued")'
       for name in ('shift_warp_2d', 'displacement_bounds',
                    'displacement_bounds_from_disp', 'tiled_shift_plan',
                    'shift_warp_2d_tiled', 'warp_sections_shift_tiled',
                    'shift_warp_3d', 'shift_path_profitable',
                    'warp_sections_shift')},
    **{('ops.fill', name): 'takes a trailing `dim` (the grid rank, '
       'default 2): the port fills a batch of fields at once where the '
       'reference vmaps over them, so the grid rank cannot come from '
       '`valid.ndim`'
       for name in ('nearest_fill', 'span_hull', 'harmonic_fill',
                    'fill_invalid')},
}


def _port_modules():
  root = os.path.dirname(os.path.abspath(tff.__file__))
  names = []
  for folder, _, files in os.walk(root):
    for f in files:
      if f.endswith('.py') and f != '__init__.py':
        rel = os.path.relpath(os.path.join(folder, f), root)[:-3]
        names.append(rel.replace(os.sep, '.'))
  return sorted(n for n in names
                if importlib.util.find_spec('sofima_tpu.' + n) is not None)


def _public(module):
  """Public functions and classes defined in `module` (not imported)."""
  out = {}
  for name, obj in vars(module).items():
    target = inspect.unwrap(obj) if callable(obj) else obj
    if (not name.startswith('_')
        and (inspect.isfunction(target) or inspect.isclass(target))
        and getattr(target, '__module__', None) == module.__name__):
      out[name] = obj
  return out


def _same_default(port, ref):
  """Defaults agree: equal values, NaN and NaN, the counterpart function
  of the module's own function, equal fields of a config dataclass, or
  the same member of the counterpart enum."""
  if inspect.isfunction(ref) or inspect.isfunction(port):
    if not (inspect.isfunction(ref) and inspect.isfunction(port)):
      return False
    ref_rel = ref.__module__.replace('sofima_tpu.', '', 1)
    port_rel = port.__module__.replace('sofima_tpu_torch.', '', 1)
    return (ref_rel, ref.__qualname__) == (port_rel, port.__qualname__)
  if dataclasses.is_dataclass(ref) and dataclasses.is_dataclass(port):
    return dataclasses.asdict(ref) == dataclasses.asdict(port)
  if isinstance(ref, enum.Enum) and isinstance(port, enum.Enum):
    return ((type(ref).__qualname__, ref.name, ref.value)
            == (type(port).__qualname__, port.name, port.value))
  if isinstance(ref, float) and isinstance(port, float):
    return ref == port or (math.isnan(ref) and math.isnan(port))
  return bool(port == ref)


def _surface_diffs(module_name):
  """[(name, what differs)] between the two modules' public surfaces."""
  ref_mod = importlib.import_module('sofima_tpu.' + module_name)
  port_mod = importlib.import_module('sofima_tpu_torch.' + module_name)
  ref_pub, port_pub = _public(ref_mod), _public(port_mod)
  diffs, pairs = [], []
  for name, ref_obj in ref_pub.items():
    if name not in port_pub:
      diffs.append((name, 'missing'))
      continue
    pairs.append((name, ref_obj, port_pub[name]))
    ref_cls = inspect.unwrap(ref_obj)
    if not inspect.isclass(ref_cls):
      continue
    for attr, member in vars(ref_cls).items():
      if attr.startswith('_') and attr != '__init__':
        continue
      if not isinstance(member, (property, staticmethod, classmethod)) and (
          not inspect.isfunction(member)):
        continue
      if not hasattr(port_pub[name], attr):
        diffs.append((f'{name}.{attr}', 'missing'))
      elif not isinstance(member, property):
        pairs.append((f'{name}.{attr}', getattr(ref_cls, attr),
                      getattr(port_pub[name], attr)))
  for name, ref_obj, port_obj in pairs:
    ref = _params(ref_obj)
    port = _params(port_obj)
    names_ok = [n for n, _ in port[:len(ref)]] == [n for n, _ in ref]
    extra = tuple(n for n, _ in port[len(ref):])
    if not names_ok or any(n not in EXTRA_PARAMS for n in extra):
      diffs.append((name, f'parameters {port} against {ref}'))
      continue
    for (n, d_port), (_, d_ref) in zip(port, ref):
      if (d_ref is inspect.Parameter.empty) != (
          d_port is inspect.Parameter.empty) or (
              d_ref is not inspect.Parameter.empty
              and not _same_default(d_port, d_ref)):
        diffs.append((name, f'default of {n}: {d_port!r} against {d_ref!r}'))
  return diffs


@pytest.mark.parametrize('module_name', _port_modules())
def test_public_surface_matches_reference(module_name):
  diffs = _surface_diffs(module_name)
  unexplained = [d for d in diffs
                 if (module_name, d[0].split('.')[0]) not in SURFACE_EXCEPTIONS]
  assert not unexplained, unexplained
  # Every listed exception still differs, so the list stays true.
  listed = {name for mod, name in SURFACE_EXCEPTIONS if mod == module_name}
  assert listed == {d[0].split('.')[0] for d in diffs}, (listed, diffs)


def test_surface_walk_covers_the_ported_modules():
  names = _port_modules()
  for must in ('flow_field', 'stitch_rigid', 'stitch_elastic', 'mesh',
               'ops.interp', 'utils.bounding_box', 'utils.box_generator',
               'utils.geom', 'ops.shift_warp', 'ops.fill',
               'parallel.mesh_sharding', 'parallel.distributed',
               *PROCESSOR_LAYER, *DECORATOR_LAYER):
    assert must in names
  calc = _public(importlib.import_module('sofima_tpu_torch.flow_field'))
  assert 'JAXMaskedXCorrWithStatsCalculator' in calc
  assert _same_default(
      inspect.signature(tff.JAXMaskedXCorrWithStatsCalculator.flow_field)
      .parameters['progress_fn'].default,
      inspect.signature(jff.JAXMaskedXCorrWithStatsCalculator.flow_field)
      .parameters['progress_fn'].default)


def _masked_pair(shape_prev, shape_curr, seed):
  rng = np.random.RandomState(seed)
  prev = rng.rand(*shape_prev).astype(np.float32)
  curr = rng.rand(*shape_curr).astype(np.float32)
  prev[1] *= 0.01  # a low-contrast item: per-item thresholds differ
  return (prev, curr, rng.rand(*prev.shape) < 0.2,
          rng.rand(*curr.shape) < 0.3)


@pytest.mark.parametrize('dim, shapes', [
    (2, ((3, 30, 24), (3, 26, 20))),
    (3, ((2, 6, 12, 10), (2, 5, 9, 8))),
])
def test_masked_xcorr_reference_call(dim, shapes):
  prev, curr, pm, cm = _masked_pair(*shapes, seed=dim)
  ref = np.asarray(jff.masked_xcorr(prev, curr, pm, cm, use_jax=True,
                                    dim=dim, per_item=True))
  got = tff.masked_xcorr(torch.from_numpy(prev), torch.from_numpy(curr),
                         torch.from_numpy(pm), torch.from_numpy(cm),
                         use_jax=True, dim=dim, per_item=True)
  assert got.shape == ref.shape
  assert ref.shape[-dim:] == tuple(a + b - 1 for a, b in
                                   zip(shapes[0][-dim:], shapes[1][-dim:]))
  np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def _texture(n, seed):
  rng = np.random.RandomState(seed)
  f = np.fft.rfft2(rng.rand(n, n).astype(np.float32))
  f *= np.exp(-((np.fft.rfftfreq(n)[None, :] ** 2
                 + np.fft.fftfreq(n)[:, None] ** 2) / (2 * 0.08 ** 2)))
  return (np.fft.irfft2(f, s=(n, n)) * 255).astype(np.float32)


def test_coarse_to_fine_flow_bf16_keyword():
  pre = _texture(128, seed=4)
  post = np.roll(pre, (3, -2), (0, 1))
  kw = dict(patch_size=(32, 32), step=(16, 16), max_displacement=16,
            residual=4)
  got = tff.coarse_to_fine_flow(torch.from_numpy(pre), torch.from_numpy(post),
                                batch_size=8, bf16=True, **kw).numpy()
  plain = tff.coarse_to_fine_flow(torch.from_numpy(pre),
                                  torch.from_numpy(post), **kw).numpy()
  ref = np.asarray(jff.coarse_to_fine_flow(jnp.asarray(pre),
                                           jnp.asarray(post), bf16=False,
                                           **kw))
  np.testing.assert_array_equal(got, plain)
  assert got.shape == ref.shape
  np.testing.assert_array_equal(np.nan_to_num(got[:2], nan=9e9),
                                np.nan_to_num(ref[:2], nan=9e9))
  assert np.isfinite(got[:2]).any()
