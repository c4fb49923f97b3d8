"""Solver-state checkpoint / resume.

Twin of sofima_tpu/utils/checkpoint.py: periodic snapshots of a
relaxation's state (positions, velocities, FIRE scalars, step) so that a
long relaxation can resume mid-flight, and the {x, key_to_idx} npz of
solved tile meshes. The files are plain npz files written by atomic
rename, with the reference's keys: a snapshot written by either package
loads in the other.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from sofima_tpu_torch import placement


def save_solver_state(path: str, x, v=None, fire_state: dict | None = None,
                      step: int = 0, metadata: dict | None = None) -> None:
  """Snapshots relaxation state to an npz file (atomic rename)."""
  arrays: dict[str, Any] = {'x': placement.to_host(x),
                            'step': np.asarray(step)}
  if v is not None:
    arrays['v'] = placement.to_host(v)
  if fire_state:
    for k, val in fire_state.items():
      arrays[f'fire_{k}'] = placement.to_host(val)
  if metadata:
    arrays['metadata'] = np.asarray([repr(metadata)])
  tmp = path + '.tmp'
  with open(tmp, 'wb') as f:
    np.savez_compressed(f, **arrays)
  os.replace(tmp, path)


def load_solver_state(path: str) -> dict[str, Any]:
  """Loads a snapshot; returns {} if the file does not exist."""
  if not os.path.exists(path):
    return {}
  with open(path, 'rb') as f:
    data = np.load(f, allow_pickle=True)
    return {k: data[k] for k in data.files}


def save_mesh_npz(path: str, x, key_to_idx: dict) -> None:
  """Persists solved tile meshes in the {x, key_to_idx} exchange format
  that StitchAndRender3dTiles reads."""
  tmp = path + '.tmp'
  with open(tmp, 'wb') as f:
    np.savez_compressed(f, x=placement.to_host(x), key_to_idx=key_to_idx)
  os.replace(tmp, path)


def load_mesh_npz(path: str) -> tuple[np.ndarray, dict]:
  with open(path, 'rb') as f:
    data = np.load(f, allow_pickle=True)
    return data['x'], data['key_to_idx'].item()


class CheckpointingRelaxer:
  """Wraps the staged relaxation with periodic snapshots + resume.

  Runs the solver in `config.num_iters` chunks (`mesh.velocity_verlet`,
  a host loop; K8 on the card with the default in-plane force) and
  snapshots every `save_every` chunks; a later `run` on the same path
  restores the snapshot and continues. Host inputs go to `device`
  (default: the CUDA card); tensors stay where they are.
  """

  def __init__(self, path: str, config, mesh_force=None, save_every: int = 10,
               device=None):
    from sofima_tpu_torch import mesh as mesh_lib
    self._path = path
    self._config = config
    self._mesh_force = mesh_force or mesh_lib.inplane_force
    self._save_every = save_every
    self._device = device

  def run(self, x, prev):
    """Relaxes `x` toward `prev` -> (positions, steps taken in all)."""
    from sofima_tpu_torch import mesh as mesh_lib

    cfg = self._config
    x = placement.place(x, self._device, torch.float32)
    dev = x.device
    if prev is not None:
      prev = placement.place(prev, dev, torch.float32)
    state = load_solver_state(self._path)
    if state:
      x = torch.from_numpy(state['x']).to(dev)
      v = torch.from_numpy(state['v']).to(dev)
      t = int(state['step'])
      dt = float(state.get('fire_dt', cfg.dt))
      alpha = float(state.get('fire_alpha', cfg.alpha))
      cap = float(state.get('fire_cap', cfg.start_cap))
    else:
      v = torch.zeros_like(x)
      t = 0
      dt, alpha, cap = cfg.dt, cfg.alpha, cfg.start_cap

    chunks_done = 0
    while t < cfg.max_iters:
      out = mesh_lib.velocity_verlet(
          x, v, prev, cfg, force_cap=cap, fire_dt=dt, fire_alpha=alpha,
          mesh_force=self._mesh_force)
      t += cfg.num_iters
      x, v = out[:2]
      v_max = float(torch.max(torch.linalg.vector_norm(v, dim=0)))
      if cfg.fire:
        dt, alpha, cap = float(out[-4]), float(out[-3]), float(out[-1])
      chunks_done += 1
      if chunks_done % self._save_every == 0:
        save_solver_state(
            self._path, x, v,
            fire_state={'dt': dt, 'alpha': alpha, 'cap': cap}, step=t)
      if v_max < cfg.stop_v_max and cap >= cfg.final_cap:
        break
      if v_max < cfg.stop_v_max:
        cap = min(cap * cfg.cap_scale, cfg.final_cap)

    save_solver_state(self._path, x, v,
                      fire_state={'dt': dt, 'alpha': alpha, 'cap': cap},
                      step=t)
    return x, t
