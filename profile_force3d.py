"""K9 (the 3d spring force) by tile shape, on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 profile_force3d.py

Builds csrc/force3d.cu as it stands (tiles of 16 rows where they give
every SM a block, else of 8) and in variants that take one tile height
for every mesh, each alone into a library of its own under the
git-ignored build/force3d_variants, and runs each on chip_smoke.py's K9
inputs: path (b)'s mesh [3, 8, 512, 1024] with and without NaN holes
(both force forms) and path (a)'s tile-mesh shape [3, 4, 4, 36, 36]
(ms a call, the wrapper's host time included). Each variant is held
against the plain force (max |df| < chip_smoke.FORCE_TOL) and timed
with CUDA events (mean of REPS calls after a warm-up), in turns: every
variant, then every variant again in reverse order. The compiler's
report (registers, spills) of each is printed.

Two probes say what bounds the kernel: the same kernel with fewer
instructions a spring, its results wrong where a link is not finite
(at the mesh's edges too), so timed only (held against plain on the
interior nodes of the mesh without holes):
'no finite checks' drops the per-component nan_to_num (two of ~29
instructions a component), 'rsqrt, no denormal scaling' takes
rsqrt.approx.ftz (three a spring). The last line is a JSON object of
the numbers.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
REPS = 20
# name: the condition under which the launcher takes 16-row tiles (else
# 8-row ones); the first is the source as it stands.
RULE = 'tiles16 * meshes >= sms[dev]'
VARIANTS = {'as built': RULE, '16 rows': 'true', '8 rows': 'false'}
# Probes: name -> (text in csrc/force3d.cu, its replacement).
FINITE = ('return make_float3(sofima::finite_or_zero(g0), '
          'sofima::finite_or_zero(g1),\n'
          '                     sofima::finite_or_zero(g2));')
RSQRT = 'const float inv_len = rsqrtf(dd);'
PROBES = {
    'no finite checks': (FINITE, 'return make_float3(g0, g1, g2);'),
    'rsqrt, no denormal scaling': (
        RSQRT, 'float inv_len;\n  asm("rsqrt.approx.ftz.f32 %0, %1;" '
        ': "=f"(inv_len) : "f"(dd));'),
}


def variant_source(text: str, name: str) -> str:
  if text.count(f'if ({RULE})') != 1:
    raise RuntimeError('csrc/force3d.cu no longer picks its tile rows by '
                       + RULE)
  if name in PROBES:
    old, new = PROBES[name]
    if text.count(old) != 1:
      raise RuntimeError(f'csrc/force3d.cu no longer has {old!r}')
    return text.replace(old, new)
  return text.replace(f'if ({RULE})', f'if ({VARIANTS[name]})')


def main() -> int:
  if not torch.cuda.is_available():
    print('profile_force3d: CUDA is not available', file=sys.stderr)
    return 2
  sys.path.insert(0, str(HERE))
  import chip_smoke as cs
  from sofima_tpu_torch import mesh
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.ops import cuda_mesh
  dev = torch.device('cuda', 0)
  print(cs.smi())
  rng = np.random.RandomState(cs.SEED + 3)
  shape_b = (3,) + cs.MESH3D
  xb = torch.from_numpy(rng.randn(*shape_b).astype(np.float32)).to(dev)
  holes = torch.from_numpy(rng.rand(*cs.MESH3D) < 0.001).to(dev)
  xh = torch.where(holes[None], torch.full_like(xb, float('nan')), xb)
  xa = torch.from_numpy(rng.randn(3, 4, 4, 36, 36).astype(np.float32)).to(dev)
  s40, s16 = (40.0,) * 3, (16.0,) * 3
  refs = {p: mesh.elastic_mesh_3d_plain(xh, 0.1, s40, p) for p in (0, 1)}
  source = (HERE / 'sofima_tpu_torch' / 'csrc' / 'force3d.cu').read_text()
  root = HERE / 'build' / 'force3d_variants'
  out = {}
  refs[2] = mesh.elastic_mesh_3d_plain(xb, 0.1, s40)
  names = list(VARIANTS) + list(PROBES)
  for order in (names, names[::-1]):
    for name in order:
      d = root / re.sub(r'\W+', '_', name)
      (d / 'csrc').mkdir(parents=True, exist_ok=True)
      (d / 'csrc' / 'force3d.cu').write_text(variant_source(source, name))
      shutil.copy(HERE / 'sofima_tpu_torch' / 'csrc' / 'mesh3d.cuh',
                  d / 'csrc' / 'mesh3d.cuh')
      _build.CSRC = d / 'csrc'
      _build._lib = None
      os.environ['SOFIMA_TORCH_BUILD_DIR'] = str(d / 'out')
      _build.library()
      if name not in out:
        for row in cs.compiler_report(_build.build_log, 'force3d_kernel'):
          print(f'{name}: {row}')
        errs = []
        if name in PROBES:  # right only where every link is finite:
          inner = (slice(None),) + (slice(1, -1),) * 3  # off the edges
          errs.append(float((cuda_mesh.force_3d(xb, 0.1, s40)
                             - refs[2])[inner].abs().max()))
        for p in (() if name in PROBES else (0, 1)):
          got = cuda_mesh.force_3d(xh, 0.1, s40, bool(p))
          cs.check(bool(torch.equal(torch.isnan(got), torch.isnan(refs[p]))),
                   f'{name}: NaN pattern differs')
          errs.append(float((got - refs[p]).abs().max()))
        cs.check(max(errs) < cs.FORCE_TOL, f'{name} differs from plain by '
                 f'{max(errs)}')
        out[name] = dict(err=max(errs), runs=[])
      t = dict(
          b=cs.cuda_ms(lambda: cuda_mesh.force_3d(xb, 0.1, s40), REPS),
          b_holes=cs.cuda_ms(lambda: cuda_mesh.force_3d(xh, 0.1, s40), REPS),
          b_prefer=cs.cuda_ms(lambda: cuda_mesh.force_3d(xb, 0.1, s40, True),
                              REPS),
          a=cs.cuda_ms(lambda: cuda_mesh.force_3d(xa, 0.1, s16), REPS))
      out[name]['runs'].append(t)
      print(f'{name}: max |df| {out[name]["err"]:.3g}; path (b) '
            f'{t["b"]:.4f} ms (NaN holes {t["b_holes"]:.4f}, '
            f'prefer_orig_order {t["b_prefer"]:.4f}); path (a)\'s shape '
            f'{t["a"]:.4f} ms a call', flush=True)
  print(cs.smi())
  print(json.dumps(out))
  return 0


if __name__ == '__main__':
  sys.exit(main())
