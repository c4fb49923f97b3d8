"""Multi-process execution utilities on torch.distributed.

Twin of sofima_tpu/parallel/distributed.py, which wraps jax.distributed
for multi-host TPU jobs. Here every process is one rank of a
torch.distributed default group:

  * `initialize()` — `dist.init_process_group` for multi-process runs
    (no-op for one process), the rendezvous address from the arguments
    or the reference's environment variables. The backend is explicit:
    NCCL by default, gloo only when the caller asks for it; a missing
    card or NCCL raises rather than switch.
  * `partition_work()` — deterministic round-robin assignment of
    processor work boxes to ranks (idempotent chunk jobs, so failure
    recovery = rerun missing chunks).
  * `process_volume_distributed()` — each rank runs its share of the
    chunk grid with the local runner; results land in a shared output
    volume (TensorStore on shared storage), followed by a barrier.
  * `device_mesh()` — a 1d or 2d mesh of the ranks for the spatially
    sharded solver (`mesh_sharding.DeviceMesh`).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from sofima_tpu_torch.parallel import mesh_sharding
from sofima_tpu_torch.processor import runner as runner_lib
from sofima_tpu_torch.utils.bounding_box import BoundingBox


def _init_method(address: str) -> str:
  """'host:port' -> 'tcp://host:port'; a URL ('tcp://...', 'file://...',
  'env://') is taken as it is."""
  return address if '://' in address else 'tcp://' + address


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = 'nccl') -> None:
  """Joins the default process group (no-op for single-process jobs).

  Unset arguments come from SOFIMA_COORDINATOR (default
  'localhost:8476'; a 'file://' URL rendezvouses through a FileStore),
  SOFIMA_NUM_PROCESSES (default 1) and SOFIMA_PROCESS_ID (default 0).
  With NCCL the rank takes card `process_id % device_count` as its
  current device.
  """
  if num_processes is None:
    num_processes = int(os.environ.get('SOFIMA_NUM_PROCESSES', '1'))
  if num_processes <= 1:
    return
  if process_id is None:
    process_id = int(os.environ.get('SOFIMA_PROCESS_ID', '0'))
  if coordinator_address is None:
    coordinator_address = os.environ.get('SOFIMA_COORDINATOR',
                                         'localhost:8476')
  if backend == 'nccl':
    if not torch.cuda.is_available() or not dist.is_nccl_available():
      raise RuntimeError('the NCCL backend needs CUDA and NCCL: pass '
                         'backend="gloo" to run the ranks over gloo')
    torch.cuda.set_device(process_id % torch.cuda.device_count())
  dist.init_process_group(backend,
                          init_method=_init_method(coordinator_address),
                          world_size=num_processes, rank=process_id)


def process_count() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def device_mesh(axis_names: Sequence[str] = ('mesh_y',),
                shape: Sequence[int] | None = None):
  """Mesh over all ranks of the job (or the first prod(shape)), default
  1d."""
  if shape is None:
    shape = (process_count(),)
  return mesh_sharding._build_mesh(shape, axis_names)


def partition_work(work_boxes: Sequence[BoundingBox],
                   num_parts: int | None = None,
                   part_index: int | None = None) -> list[BoundingBox]:
  """Deterministic round-robin share of the chunk grid for this rank."""
  if num_parts is None:
    num_parts = process_count()
  if part_index is None:
    part_index = process_index()
  return [b for i, b in enumerate(work_boxes)
          if i % num_parts == part_index]


def barrier(name: str = 'sofima-barrier') -> None:
  """Synchronization point of every rank (`name` is for the reader)."""
  del name
  if process_count() == 1:
    return
  dist.barrier()


def process_volume_distributed(processor, input_volume,
                               output_volume=None,
                               subvolume_size=None,
                               parallelism: int = 1):
  """Runs a processor's chunk grid, split across ranks.

  Each rank processes `work_boxes[i] for i % num_ranks == rank` (the
  reference's grid, `BoxGenerator` over the volume grown by the
  processor's context); the output volume must be shared storage
  (TensorStore) for a multi-process run. Returns this rank's output
  volume handle.
  """
  from sofima_tpu_torch.utils.box_generator import BoxGenerator
  from sofima_tpu_torch.utils.volume import open_volume

  vol = open_volume(input_volume)
  pre, post = processor.context()
  overlap = np.array(processor.overlap(), np.int64)
  if subvolume_size is None:
    suggested = np.array(tuple(processor.subvolume_size()), np.int64)
  else:
    suggested = np.array(subvolume_size, np.int64)
  vol_size = np.array(vol.meta.volume_size, np.int64)
  work_size = np.minimum(suggested, vol_size + overlap)
  outer = BoundingBox(
      start=(-np.array(pre)).tolist(),
      size=(vol_size + np.array(pre) + np.array(post)).tolist())
  gen = BoxGenerator(outer, box_size=work_size, box_overlap=overlap,
                     back_shift_small_boxes=True)
  mine = partition_work(list(gen))

  out = runner_lib.process_volume(
      processor, vol, output_volume=output_volume,
      subvolume_size=subvolume_size, parallelism=parallelism,
      work_boxes=mine)
  barrier('process-volume-' + processor.namespace)
  return out
