"""The correctness check of a configuration whose `check` is
`stack_align`: the stack-alignment entry's meshes, renders and
`overflow` flag against the plain reference (port_bench/reference), on
sections drawn from the seed.

Each checked section is aligned again by the reference from the two
sections the benchmark handed the program and from the mesh handed to
that section: zeros for a block's first moving section (the start,
checked in every run), else the program's mesh of the section before
(the solve is sequential, and the reference's plain solve of every
earlier section would take longer than the window). The numbers
compared, each the worst over the checked sections:

  mesh_p99_px        99th percentile over the nodes of |mesh - reference
                     mesh| (px; a node finite on one side only counts as
                     inf). Not the maximum: where two correlation peaks
                     tie to float rounding, one flow node takes the other
                     peak on one side and moves its neighbourhood's
                     nodes by up to ~0.3 px, more than the control's
                     rounding moves any node
  render_off_share   share of pixels whose render differs from the
                     reference's (in the output's type) by > 1 gray
  overflow_mismatch  1 if the `overflow` flag differs, else 0: in block
                     mode the call's flag against the reference's over
                     every pair (coarse moves) and every section (render
                     envelope of the reference's inverse of the
                     program's mesh); in stream mode each section's

`control=True` puts the reference computed in bfloat16 in the
program's place (port_bench/reference/chain.py): a run that a correct
comparison has to fail.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from port_bench.reference import chain
from port_bench.reference import flow as flow_ref

NAMES = ('mesh_p99_px', 'render_off_share', 'overflow_mismatch')


@dataclasses.dataclass
class Kept:
  """What the window's program produced for the sections to check."""
  block: int
  zs: list                     # checked sections of the block
  mesh_prev: dict              # z -> [2, G, G] mesh handed to the section
  mesh: dict                   # z -> [2, G, G] program's mesh
  rendered: dict               # z -> [n, n] program's render
  overflow: dict               # z -> bool (stream) or {None: bool} (block)
  meshes_all: torch.Tensor | None = None  # block: [Z, 2, G, G]


def to_out(img: torch.Tensor, out_dtype: str | None) -> torch.Tensor:
  if out_dtype is None:
    return img.to(torch.float32)
  return torch.clamp(torch.round(img.to(torch.float32)), 0, 255).to(
      getattr(torch, out_dtype))


def _mesh_gap(a: torch.Tensor, b: torch.Tensor) -> float:
  """99th percentile over the nodes of the larger |a - b| of the two
  components; a node finite on one side only counts as inf."""
  fa, fb = torch.isfinite(a).all(dim=0), torch.isfinite(b).all(dim=0)
  gap = torch.abs(a - b).amax(dim=0).to(torch.float64)
  gap = torch.where(fa & fb, gap, torch.zeros_like(gap))
  gap = torch.where(fa != fb, torch.full_like(gap, float('inf')), gap)
  return float(torch.quantile(gap.reshape(-1), 0.99))


def _off_share(a: torch.Tensor, b: torch.Tensor) -> float:
  diff = torch.abs(a.to(torch.float32) - b.to(torch.float32))
  diff = torch.nan_to_num(diff, nan=float('inf'))
  return float((diff > 1.0).to(torch.float64).mean())


def _block_overflow(block, meshes_all, cfg) -> bool:
  """The reference's flag over a whole call: every pair's coarse moves,
  every moving section's render envelope."""
  flag = False
  for z in range(1, block.shape[0]):
    _, ov, _ = flow_ref.coarse_moves(block[z - 1], block[z], cfg['patch'],
                                     cfg['stride'], cfg['max_displacement'])
    flag |= bool(ov)
  rel_inv, _ = chain.invert(meshes_all[1:], cfg)
  n = block.shape[-1]
  for i in range(rel_inv.shape[0]):
    flag |= bool(chain.render_overflow(rel_inv[i], cfg, n))
  return flag


def judge(inputs: torch.Tensor, kept: Kept, cfg: dict, mix: dict,
          control: bool = False) -> dict:
  """The compared numbers of one run -> {name: value}. `inputs`: the
  blocks of sections handed to the program; `kept`: what the driver kept
  of the window's outputs."""
  block, out_dtype = inputs[kept.block], mix.get('out_dtype')
  mesh_gap, off, ref_ov, cand_ov, per_ov = 0.0, 0.0, False, False, 0
  for z in kept.zs:
    prev = kept.mesh_prev[z]
    ref = chain.align_section(block[z - 1], block[z], prev, cfg, 'float32')
    print(f'port_bench: reference section {z}: {ref["steps"]} FIRE steps',
          file=sys.stderr, flush=True)
    if control:
      ctl = chain.align_section(block[z - 1], block[z], prev, cfg,
                                'bfloat16')
      mesh, rendered, ov = ctl['mesh'], to_out(ctl['rendered'], out_dtype), \
          bool(ctl['overflow'])
    else:
      mesh, rendered = kept.mesh[z], kept.rendered[z]
      ov = kept.overflow.get(z)
    mesh_gap = max(mesh_gap, _mesh_gap(mesh, ref['mesh']))
    off = max(off, _off_share(rendered, to_out(ref['rendered'], out_dtype)))
    ref_ov |= bool(ref['overflow'])
    cand_ov |= bool(ov) if ov is not None else False
    if ov is not None:
      per_ov = max(per_ov, int(bool(ov) != bool(ref['overflow'])))
    del ref
  if None in kept.overflow and not control:
    mismatch = int(kept.overflow[None] != _block_overflow(
        block, kept.meshes_all, cfg))
  elif None in kept.overflow:
    mismatch = int(cand_ov != ref_ov)
  else:
    mismatch = per_ov
  return {'mesh_p99_px': mesh_gap, 'render_off_share': off,
          'overflow_mismatch': mismatch}
