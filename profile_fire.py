"""Where the time of the fused FIRE solvers (K3, K11) goes, on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 profile_fire.py               # K3 and K11 at chip_smoke's inputs
    python3 profile_fire.py --variants    # and each nodes-per-thread plan
    python3 profile_fire.py --path-f      # and K3 on path (f)'s inputs

K3 runs on chip_smoke.py's 250^2 stack mesh with the headline solver
configuration, K11 on bench.py's mesh3d_fused mesh [3, 8, 128, 256] with
its configuration. For each: the steps, ms per launch (CUDA events, mean
of REPS launches after a warm-up), us per step, and max |dx| against the
plain solver (below MESH_TOL) with the step counts and NaN patterns
equal.

--variants also runs both meshes under each nodes-per-thread count that
fits the card (the port takes the smallest): `cuda_mesh.FIRE_NPT`, the
counts `fire_plan` may take, is narrowed to one count at a time. Each
run is held against the plain solver as above (max |dx| < MESH_TOL) and
timed.
--path-f builds path (f)'s solve inputs as chip_smoke.py does (the
library API's flow on e2e_alignment's 10k^2 pair), holds K3's first
K3_STEPS steps on them against the plain solver (max |dx| beside the
bar), and times the whole solve. The last line is a JSON object of the
numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
REPS = 5


@contextlib.contextmanager
def only_npt(cuda_mesh, npt: int):
  """fire_plan restricted to `npt` nodes per thread."""
  saved = cuda_mesh.FIRE_NPT
  cuda_mesh.FIRE_NPT = (npt,)
  cuda_mesh._fire_route_on.cache_clear()
  try:
    yield
  finally:
    cuda_mesh.FIRE_NPT = saved
    cuda_mesh._fire_route_on.cache_clear()


def print_fire_report(log: str) -> None:
  """The compiler's report (registers, spills, shared memory) of fire.cu."""
  take = False
  for line in log.splitlines():
    if 'nvcc' in line and ' -c ' in line:
      take = line.rstrip().endswith('fire.cu')
    if take and ('ptxas' in line or 'spill' in line):
      print(line.strip())


def held(cs, got, steps, ref, steps_p, name):
  err = float(torch.nan_to_num((got - ref).abs(), nan=0.0).max())
  cs.check(int(steps) == int(steps_p), f'{name} steps {int(steps)} vs '
           f'{steps_p}')
  cs.check(bool(torch.equal(torch.isnan(got), torch.isnan(ref))),
           f'{name} NaN pattern differs')
  cs.check(err < cs.MESH_TOL, f'{name} differs from plain by {err} px')
  return err


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument('--variants', action='store_true')
  ap.add_argument('--path-f', action='store_true')
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print('profile_fire: CUDA is not available', file=sys.stderr)
    return 2
  sys.path.insert(0, str(HERE))
  import chip_smoke as cs
  from sofima_tpu_torch.ops import _build
  from sofima_tpu_torch.ops import cuda_mesh
  dev = torch.device('cuda', 0)
  print(cs.smi())
  _build.library()
  print(f'kernel build + load: {_build.build_seconds:.2f} s')
  print_fire_report(_build.build_log)
  out = {}

  # K3: chip_smoke's stack mesh, the headline configuration.
  g = cs.N // cs.STRIDE
  cfg = cs.headline_config().mesh
  x0, prev = cs.k3_inputs(g, np.random.RandomState(cs.SEED + 1), dev)
  k3 = lambda: cuda_mesh.relax_mesh_fused(x0, prev, cfg)
  got, _, steps = k3()
  ref, _, steps_p = cuda_mesh.relax_mesh_fused_plain(x0[:, 0], prev[:, 0],
                                                     cfg)
  err = held(cs, got[:, 0], steps, ref, steps_p, 'K3')
  ms = cs.cuda_ms(k3, REPS)
  out['K3'] = dict(steps=int(steps), ms=ms, us_step=ms * 1e3 / int(steps),
                   err=err)
  # K11: bench.py's mesh3d_fused mesh.
  cfg3 = cs.fused3d_config()
  rng = np.random.RandomState(cs.SEED + 3)
  x3 = torch.from_numpy(rng.randn(3, *cs.FUSED3D).astype(np.float32)).to(dev)
  p3 = torch.zeros_like(x3)
  k11 = lambda: cuda_mesh.relax_mesh_fused_3d(x3, p3, cfg3)
  got, _, steps3 = k11()
  ref, _, steps3_p = cuda_mesh.relax_mesh_fused_3d_plain(x3, p3, cfg3)
  err3 = held(cs, got, steps3, ref, steps3_p, 'K11')
  ms3 = cs.cuda_ms(k11, REPS)
  out['K11'] = dict(steps=int(steps3), ms=ms3,
                    us_step=ms3 * 1e3 / int(steps3), err=err3)
  for k in ('K3', 'K11'):
    r = out[k]
    print(f'{k}: {r["steps"]} steps, {r["ms"]:.3f} ms, {r["us_step"]:.3f} '
          f'us a step, max |dx| vs plain {r["err"]:.3g} px')

  if args.variants:
    cases = (('K3', cuda_mesh.relax_mesh_fused,
              cuda_mesh.relax_mesh_fused_plain, x0, prev, cfg),
             ('K11', cuda_mesh.relax_mesh_fused_3d,
              cuda_mesh.relax_mesh_fused_3d_plain, x3, p3, cfg3))
    for key, fused, plain, xx, pp, cc in cases:
      plan = cuda_mesh.fire_plan_of(xx, cc)
      out[key]['plan'] = dict(npt=plan.npt, tile=plan.tile,
                              blocks=plan.nblocks, smem=plan.smem_bytes)
      ref, _, steps_p = (plain(xx[:, 0], pp[:, 0], cc) if key == 'K3'
                         else plain(xx, pp, cc))
      variants = {}
      for npt in cuda_mesh.FIRE_NPT:
        with only_npt(cuda_mesh, npt):
          try:
            p_n = cuda_mesh.fire_plan_of(xx, cc)
          except ValueError:
            continue
          run = lambda: fused(xx, pp, cc)
          got, _, st = run()
          got = got[:, 0] if key == 'K3' else got
          err_n = held(cs, got, st, ref, steps_p, f'{key} npt {npt}')
          ms_n = cs.cuda_ms(run, REPS)
        variants[npt] = dict(tile=p_n.tile, blocks=p_n.nblocks, err=err_n,
                             us_step=ms_n * 1e3 / int(st))
        print(f'{key} npt {npt}: tile {p_n.tile}, {p_n.nblocks} blocks, '
              f'{variants[npt]["us_step"]:.3f} us a step, max |dx| vs '
              f'plain {err_n:.3g} px')
      out[key]['variants'] = variants

  if args.path_f:
    pre, post = cs.e2e_pair(dev)
    final = cs.library_flow(pre, post, {})['final']
    del pre, post
    pf = torch.from_numpy(final).to(dev)
    cfg_f = cs.e2e_config()
    cfg_k = dataclasses.replace(cfg_f, max_iters=cs.K3_STEPS)
    got, _, st = cuda_mesh.relax_mesh_fused(torch.zeros_like(pf), pf, cfg_k)
    ref, _, st_p = cuda_mesh.relax_mesh_fused_plain(
        torch.zeros_like(pf[:, 0]), pf[:, 0], cfg_k)
    err_f = held(cs, got[:, 0], st, ref, st_p, 'path (f) K3')
    solve = lambda: cuda_mesh.relax_mesh_fused(torch.zeros_like(pf), pf,
                                               cfg_f)
    _, _, st_f = solve()
    ms_f = cs.cuda_ms(solve, 3)
    out['path_f'] = dict(err=err_f, bar=cs.MESH_TOL, steps=int(st_f),
                         ms=ms_f, us_step=ms_f * 1e3 / int(st_f))
    print(f'path (f) K3: first {cs.K3_STEPS} steps max |dx| {err_f:.3g} px '
          f'(bar {cs.MESH_TOL}); the solve: {int(st_f)} steps in '
          f'{ms_f:.3f} ms ({out["path_f"]["us_step"]:.3f} us a step)')

  print(cs.smi())
  print(json.dumps(out))
  return 0


if __name__ == '__main__':
  sys.exit(main())
