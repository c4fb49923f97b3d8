"""The plain stack-alignment chain of one section, and its lower-precision
control.

`align_section` runs flow -> clean -> solve -> invert -> render for the
pair (previous section, section) from the mesh handed to the section,
as the alignment entry does for each moving section. `cfg` is the
configuration file's dict. With `precision='bfloat16'` every field
handed from one layer to the next (the cleaned flow, the solved mesh,
the filled inverse map, the rendered section) is rounded to bfloat16:
the control that a correct comparison has to fail.
"""

from __future__ import annotations

import torch

from port_bench.reference import flow as flow_ref
from port_bench.reference import invert as invert_ref
from port_bench.reference import render as render_ref
from port_bench.reference import solve as solve_ref


def _rounder(precision: str):
  if precision == 'float32':
    return lambda t: t
  if precision == 'bfloat16':
    return lambda t: t.to(torch.bfloat16).to(torch.float32)
  raise ValueError(f'unknown precision {precision!r}')


def flow_full(sec_prev, sec_cur, cfg, precision='float32'):
  """Cleaned flow of a pair on the section's [G, G] node grid (NaN
  border) -> ([2, G, G], overflow of the coarse moves)."""
  p, s = cfg['patch'], cfg['stride']
  f4, overflow = flow_ref.coarse_to_fine(
      sec_prev, sec_cur, p, s, cfg['max_displacement'], cfg['peak_crop'])
  clean = flow_ref.clean(f4, cfg['min_peak_ratio'], cfg['min_peak_sharpness'],
                         cfg['max_magnitude'], cfg['max_deviation'])
  g = sec_cur.shape[-1] // s
  pad = p // 2 // s
  full = torch.full((2, g, g), float('nan'), dtype=torch.float32,
                    device=sec_cur.device)
  full[:, pad:pad + clean.shape[1], pad:pad + clean.shape[2]] = clean
  return _rounder(precision)(full), overflow


def invert(solved, cfg, precision='float32'):
  rel_inv, _ = invert_ref.invert_and_fill(
      solved, cfg['stride'], cfg['invert_fp_iters'],
      cfg['invert_newton_iters'], cfg['max_displacement'])
  rel_inv = _rounder(precision)(rel_inv)
  g0, g1 = rel_inv.shape[-2:]
  node = torch.arange(g0, dtype=torch.float32,
                      device=rel_inv.device) * cfg['stride']
  query = torch.stack([node[None, :].expand(g0, g1),
                       node[:, None].expand(g0, g1)])
  return rel_inv, rel_inv + query


def render_overflow(rel_inv, cfg, n):
  return render_ref.overflow(rel_inv[1], rel_inv[0], cfg['stride'], n,
                             cfg['residual'], cfg['max_displacement'])


def align_section(sec_prev, sec_cur, mesh_prev, cfg, precision='float32'):
  """One moving section -> dict(mesh [2, G, G], rendered [n, n] float32,
  overflow bool tensor, steps)."""
  rnd = _rounder(precision)
  full, ov_flow = flow_full(sec_prev, sec_cur, cfg, precision)
  mesh, steps = solve_ref.solve(full, mesh_prev.to(torch.float32), cfg['mesh'])
  mesh = rnd(mesh)
  rel_inv, inv_abs = invert(mesh, cfg, precision)
  n = sec_cur.shape[-1]
  coords = render_ref.upsample(torch.stack([inv_abs[1], inv_abs[0]]),
                               cfg['stride'], (n, n))
  rendered = rnd(render_ref.render(sec_cur, coords, cfg['method']))
  del coords
  return dict(mesh=mesh, rendered=rendered, steps=steps,
              overflow=ov_flow | render_overflow(rel_inv, cfg, n))
