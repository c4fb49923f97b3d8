"""Serial-section stack alignment: flow -> clean -> solve -> invert -> render.

Twin of sofima_tpu/pipeline/stack_align.py, on PyTorch and CUDA. Per
adjacent section pair:

  1. FLOW    coarse-to-fine dense grid (flow_field.coarse_to_fine_flow;
             kernels K1 and K2)
  2. CLEAN   flow_utils.clean_flow_device quality gates
  3. SOLVE   compose with the previous section's mesh, then the fused
             FIRE relaxation warm-started from the spring targets
             (ops.cuda_mesh; kernel K3), or with `mesh.remove_drift` the
             staged solver mesh.relax_mesh_fused (its force: kernel K8)
  4. INVERT  fixed-point + Newton map inversion and harmonic hole fill
  5. RENDER  Lanczos render through the inverted map (ops.cuda_warp;
             kernel K4), with the reference's envelope `overflow` flag

Only the solve carries state from section to section (a [2, 1, G, G]
mesh), so `align_stack_pipelined` runs the flow of every pair first,
then the sequential solves, then invert (all sections as one batch) and
render. With `warm_start`, each pair after the first targets its fine
pass from the previous pair's cleaned flow instead of a coarse pass, and
a stale prior is re-measured cold. A host (numpy) stack goes to `device`
(default: the CUDA card; without one, pass device='cpu'); a tensor stays
on its device, and the work stays there throughout.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import flow_utils
from sofima_tpu_torch import map_utils
from sofima_tpu_torch import mesh
from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import cuda_mesh
from sofima_tpu_torch.ops import cuda_warp
from sofima_tpu_torch.ops import fill as fill_ops
from sofima_tpu_torch.ops import interp as interp_ops
from sofima_tpu_torch.ops import shift_warp


@dataclasses.dataclass(frozen=True)
class StackAlignConfig:
  """Static configuration of the per-section chain.

  Same fields and defaults as sofima_tpu's StackAlignConfig (see its
  comments for the rationale of each default). `bf16` is kept for parity
  and not read: the port's flow kernels correlate in float32.
  `residual` sizes the `overflow` envelope checks of the render and of
  the masked flow transport. `warm_start` and `warm_refresh_min_valid`
  act in `align_stack_pipelined` only, as in the reference.
  """
  patch: int = 160
  stride: int = 40
  coarse_to_fine: bool = True
  fine_patch: int | None = None
  coarse_step: int | None = None
  peak_crop: int | None = None
  warm_start: bool = False
  warm_refresh_min_valid: float | None = 0.5
  bf16: bool = True
  min_peak_ratio: float = 1.6
  min_peak_sharpness: float = 1.6
  max_magnitude: float = 80.0
  max_deviation: float = 20.0
  max_displacement: int = 96
  residual: int = 8
  method: str = 'lanczos'
  render_two_pass: bool = False
  invert_newton_iters: int = 2
  invert_fp_iters: int = 12
  mesh: mesh.IntegrationConfig = dataclasses.field(
      default_factory=lambda: mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.1, k=0.1, stride=(40.0, 40.0),
          num_iters=500, max_iters=8000, stop_v_max=0.005,
          dt_max=100.0, start_cap=10.0, final_cap=10.0, cap_scale=1.1,
          prefer_orig_order=True))


def archival_em2d_config(**overrides) -> StackAlignConfig:
  """The reference's archival EM-2D solver protocol (k0=0.01, force-cap
  ramp 0.01 -> 10 at 1.1x per converged chunk, 1000 / 1e5 iterations)."""
  cfg = StackAlignConfig(
      mesh=mesh.IntegrationConfig(
          dt=0.001, gamma=0.0, k0=0.01, k=0.1, stride=(40.0, 40.0),
          num_iters=1000, max_iters=100000, stop_v_max=0.005,
          dt_max=100.0, start_cap=0.01, final_cap=10.0, cap_scale=1.1,
          prefer_orig_order=True))
  return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _flow_phase(sec_prev: torch.Tensor, sec_cur: torch.Tensor,
                cfg: StackAlignConfig, grid_n: int, prior=None):
  """FLOW + CLEAN for one section pair -> ([2, 1, G, G], overflow).

  `prior` ([2, G, G] on the padded full grid, NaN border included)
  warm-starts the fine pass in place of the coarse one: full-grid node j
  sits at pixel j * stride (pad * stride == patch // 2 when the stride
  divides patch // 2), hence the prior origin below.
  """
  p, s = cfg.patch, cfg.stride
  pre = sec_prev.to(torch.float32)
  post = sec_cur.to(torch.float32)
  overflow = torch.zeros((), dtype=torch.bool, device=pre.device)
  if cfg.coarse_to_fine:
    fp = None if cfg.fine_patch is None else (cfg.fine_patch,) * 2
    cs = None if cfg.coarse_step is None else (cfg.coarse_step,) * 2
    origin = p // 2 - (p // 2 // s) * s
    f4, overflow = flow_field.coarse_to_fine_flow(
        pre, post, (p, p), (s, s), coarse_step=cs, fine_patch=fp,
        max_displacement=cfg.max_displacement, residual=cfg.residual,
        return_overflow=True, peak_crop=cfg.peak_crop, prior=prior,
        prior_step=None if prior is None else (s, s),
        prior_origin=None if prior is None else (origin, origin))
  else:
    f4 = flow_field.dense_flow_field(pre, post, (p, p), (s, s), circular=True)
  clean = flow_utils.clean_flow_device(
      f4[:, None], cfg.min_peak_ratio, cfg.min_peak_sharpness,
      cfg.max_magnitude, cfg.max_deviation)
  pad = p // 2 // s
  full = torch.full((2, 1, grid_n, grid_n), float('nan'),
                    dtype=torch.float32, device=pre.device)
  full[:, :, pad:pad + clean.shape[2], pad:pad + clean.shape[3]] = clean
  return full, overflow


def _stale(flow: torch.Tensor, overflow: torch.Tensor, prev: torch.Tensor,
           cfg: StackAlignConfig) -> torch.Tensor:
  """The reference's three staleness signals of a warm pair (bool)."""
  pad = cfg.patch // 2 // cfg.stride
  fp = cfg.fine_patch if cfg.fine_patch is not None else cfg.patch // 2
  # Capture half-range of the fine peak search: the peak_crop core, else
  # a conservative quarter of the circular fine window.
  cap_half = cfg.peak_crop // 2 if cfg.peak_crop is not None else fp // 4
  n0, n1 = flow.shape[2:]
  inner = (slice(None), slice(None), slice(pad, n0 - pad),
           slice(pad, n1 - pad))
  interior = flow[inner]
  finite = torch.isfinite(interior[0, 0])
  valid = finite.to(torch.float32).mean()
  resid = torch.nan_to_num(
      torch.abs(interior - prev[inner]).amax(dim=(0, 1)))
  saturated = (finite & (resid > 0.75 * cap_half)).sum()
  frac_sat = saturated / torch.clamp(finite.sum(), min=1)
  return (overflow | (valid < cfg.warm_refresh_min_valid)
          | (frac_sat > 0.05))


def _solve_phase(flow_full: torch.Tensor, solved_prev: torch.Tensor,
                 cfg: StackAlignConfig) -> torch.Tensor:
  """SOLVE one section: spring targets from the composed flow, FIRE
  relaxation warm-started from the targets themselves. The fused kernel
  has no drift removal (as the reference's Pallas solver), so
  `remove_drift` takes the staged solver, as the reference does; so does
  a mesh above the reference's VMEM bound (cuda_mesh.fused_fits, the
  reference's rule)."""
  s = float(cfg.stride)
  zero3 = np.zeros(3, np.float32)
  prev = map_utils.compose_maps_fast(flow_full, zero3, s, solved_prev,
                                     zero3, s)
  x0 = torch.where(torch.isnan(prev), solved_prev, prev)
  if not cuda_mesh.fused_fits(x0, cfg.mesh):
    solved, _, _ = mesh.relax_mesh_fused(x0, prev, cfg.mesh)
  else:
    solved, _, _ = cuda_mesh.relax_mesh_fused(x0, prev, cfg.mesh)
  return solved


def _node_query(grid_n: int, stride: int, device) -> torch.Tensor:
  node = torch.arange(grid_n, dtype=torch.float32, device=device) * stride
  return torch.stack([node[None, :].expand(grid_n, grid_n),
                      node[:, None].expand(grid_n, grid_n)])  # xy channels


def _invert_phase(solved: torch.Tensor, cfg: StackAlignConfig):
  """INVERT solved meshes [..., 2, 1, G, G] -> (rel_inv, inv_abs), each
  [..., 2, G, G]; leading dimensions are a batch of sections."""
  s = cfg.stride
  grid_n = solved.shape[-1]
  query = _node_query(grid_n, s, solved.device)
  abs_map = solved[..., 0, :, :] + query
  inv_abs = map_utils._invert_section(
      abs_map, (0.0, 0.0), query, (float(s), float(s)),
      num_iters=cfg.invert_fp_iters, newton_iters=cfg.invert_newton_iters,
      shift_bound=-(-cfg.max_displacement // s) + 1)
  rel_inv = inv_abs - query
  valid = torch.isfinite(rel_inv).all(dim=-3)
  rel_inv = fill_ops.fill_invalid(rel_inv, valid, extrapolate=True)
  return rel_inv, rel_inv + query


def _render_phase(sec_cur: torch.Tensor, rel_inv: torch.Tensor,
                  inv_abs: torch.Tensor, cfg: StackAlignConfig):
  """RENDER one section through its inverted map -> (image, overflow).

  The gather kernel renders exactly (also for `render_two_pass`, which
  the reference runs as a separable approximation of the same render).
  `overflow` is the reference's static-envelope flag.
  """
  s = cfg.stride
  n = sec_cur.shape[-1]
  grid_n = rel_inv.shape[-1]
  node_np = np.arange(grid_n, dtype=np.float64) * s
  md = -(-cfg.max_displacement // 64) * 64
  env_r = (-cfg.residual, cfg.residual, -cfg.residual, cfg.residual)
  env_b = (-md, md, -md, md)
  plan = shift_warp.tiled_plan_device(rel_inv[1][None], rel_inv[0][None],
                                      node_np, node_np, (n, n), env_r, env_b)
  dense = interp_ops.upsample_map_linear(
      torch.stack([inv_abs[1], inv_abs[0]]), s, (0, 0), (n, n))
  rendered = cuda_warp.shift_warp(
      sec_cur.to(torch.float32)[None].contiguous(), dense[None].contiguous(),
      cfg.method)[0]
  return rendered, plan['overflow']


def _to_out(img: torch.Tensor, out_dtype):
  if out_dtype is None:
    return img.to(torch.float32)
  return torch.clamp(torch.round(img.to(torch.float32)), 0, 255).to(out_dtype)


def align_step(sec_prev, sec_cur, solved_prev, cfg: StackAlignConfig,
               device=None):
  """One per-section step: returns (solved, rendered, overflow).

  Always a cold flow (`warm_start` is ignored, as in the reference).

  Args:
    sec_prev/sec_cur: [n, n] raw adjacent sections (uint8 or float)
    solved_prev: [2, 1, G, G] relative mesh of the previous section
      (zeros for the first moving section); G = n // stride
    cfg: configuration
    device: where host (numpy) inputs go (default: the CUDA card)

  Returns:
    solved: [2, 1, G, G] relative mesh for sec_cur
    rendered: [n, n] float32 sec_cur rendered into the aligned frame
    overflow: bool tensor, a static envelope was exceeded somewhere
  """
  sec_prev, sec_cur, solved_prev = (placement.place(v, device) for v in
                                    (sec_prev, sec_cur, solved_prev))
  grid_n = sec_cur.shape[-1] // cfg.stride
  flow_full, ov_flow = _flow_phase(sec_prev, sec_cur, cfg, grid_n)
  solved = _solve_phase(flow_full, solved_prev, cfg)
  rel_inv, inv_abs = _invert_phase(solved, cfg)
  rendered, ov_render = _render_phase(sec_cur, rel_inv, inv_abs, cfg)
  return solved, rendered, ov_flow | ov_render


def align_stack_pipelined(stack, cfg: StackAlignConfig = StackAlignConfig(),
                          out_dtype=None, timings: dict | None = None,
                          device=None):
  """Whole-stack alignment with the phases run stack-wide in turn.

  Phase 1 runs flow + clean for every adjacent pair, phase 2 the
  sequential solves, phase 3 invert + fill for all sections as one batch,
  phase 4 the renders.
  Returns (rendered [Z, n, n], solved [Z, 2, 1, G, G], overflow), with
  rendered[0] = stack[0] and solved[0] = 0 (the anchor section).
  `out_dtype=torch.uint8` stores clip-rounded renders. If `timings` is
  a dict, it receives the wall seconds of each phase (synchronizing the
  device at each phase boundary). A host (numpy) stack goes to `device`
  (default: the CUDA card).

  With `cfg.warm_start` (and coarse_to_fine, and Z > 2) pair 0 runs
  cold and pair z targets its fine pass from pair z-1's cleaned flow
  (no coarse pass). Unless `warm_refresh_min_valid` is None, a warm pair
  whose prior looks stale is re-measured cold: its flow overflowed the
  targeting clamp, fewer than `warm_refresh_min_valid` of the interior
  nodes survived cleaning, or more than 5% of them measure a residual
  |flow - prior| beyond 3/4 of the fine capture half-range (the sign of
  a circular fine window aliasing a stale prior). That decision reads one
  bool per warm pair back to the host: the alternative, measuring every
  pair cold as well and selecting on the device, doubles the flow phase.
  """
  stack = placement.place(stack, device)
  z_dim, n, _ = stack.shape
  if z_dim < 2:
    raise ValueError('a stack needs at least two sections')
  grid_n = n // cfg.stride
  dev = stack.device
  solved0 = torch.zeros((2, 1, grid_n, grid_n), dtype=torch.float32,
                        device=dev)
  clock = _PhaseClock(timings, dev)

  flows, ov_flow = [], []
  warm = cfg.warm_start and cfg.coarse_to_fine and z_dim > 2
  for z in range(z_dim - 1):
    prior = flows[-1][:, 0] if warm and z > 0 else None
    f, ov = _flow_phase(stack[z], stack[z + 1], cfg, grid_n, prior=prior)
    if (prior is not None and cfg.warm_refresh_min_valid is not None
        and bool(_stale(f, ov, flows[-1], cfg))):
      f, ov = _flow_phase(stack[z], stack[z + 1], cfg, grid_n)
    flows.append(f)
    ov_flow.append(ov)
  clock.mark('flow')

  solved_seq = []
  solved = solved0
  for f in flows:
    solved = _solve_phase(f, solved, cfg)
    solved_seq.append(solved)
  clock.mark('solve')

  # Invert + fill with the sections as one batch (small-grid algebra:
  # batching divides its kernel launches by the section count).
  rel_inv_all, inv_abs_all = _invert_phase(torch.stack(solved_seq), cfg)
  clock.mark('invert')

  rendered = [_to_out(stack[0], out_dtype)]
  ov_render = []
  for z1 in range(1, z_dim):
    r, ov = _render_phase(stack[z1], rel_inv_all[z1 - 1],
                          inv_abs_all[z1 - 1], cfg)
    rendered.append(_to_out(r, out_dtype))
    ov_render.append(ov)
  clock.mark('render')

  overflow = torch.stack(ov_flow + ov_render).any()
  return (torch.stack(rendered), torch.stack([solved0] + solved_seq),
          overflow)


class _PhaseClock:
  """Wall time per phase, synchronizing the device at each mark."""

  def __init__(self, timings, device):
    self.timings = timings
    self.device = device
    self.t0 = self._now()

  def _now(self):
    if self.timings is not None and self.device.type == 'cuda':
      torch.cuda.synchronize(self.device)
    return time.perf_counter()

  def mark(self, name):
    if self.timings is None:
      return
    t = self._now()
    self.timings[name] = t - self.t0
    self.t0 = t


def align_stack(stack, cfg: StackAlignConfig = StackAlignConfig(),
                pipelined: bool = True, out_dtype=None, device=None):
  """Aligns a [Z, n, n] stack; returns (rendered, solved, overflow).

  `pipelined=True` runs `align_stack_pipelined`; `pipelined=False`
  streams section by section through `align_step` (cold flow, float32
  renders: the reference's streamed loop reads neither `warm_start`
  nor `out_dtype`). A host (numpy) stack goes to `device` (default: the
  CUDA card; without one, pass device='cpu'); a tensor stays where it
  is.
  """
  stack = placement.place(stack, device)
  if pipelined:
    return align_stack_pipelined(stack, cfg, out_dtype)
  z_dim, n, _ = stack.shape
  grid_n = n // cfg.stride
  solved = torch.zeros((2, 1, grid_n, grid_n), dtype=torch.float32,
                       device=stack.device)
  rendered = [stack[0].to(torch.float32)]
  solved_all = [solved]
  overflow = torch.zeros((), dtype=torch.bool, device=stack.device)
  for z in range(1, z_dim):
    solved, r, ov = align_step(stack[z - 1], stack[z], solved, cfg)
    rendered.append(r)
    solved_all.append(solved)
    overflow = overflow | ov
  return torch.stack(rendered), torch.stack(solved_all), overflow
