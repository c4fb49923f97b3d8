"""Chunk-parallel processor runner.

Twin of sofima_tpu/processor/runner.py: tiles the input volume into work
boxes (output region + context halo), pads out-of-bounds context,
executes the processor per box (optionally with a thread pool: the
threads overlap host I/O, and kernel launches from several threads are
counted exactly, see ops._build.count), and assembles outputs into a
destination volume, seam-free by construction.

Work items are independent and idempotent, so failure recovery =
re-running missing chunks.
"""

from __future__ import annotations

import concurrent.futures
from typing import Sequence

import numpy as np

from sofima_tpu_torch.processor.base import SubvolumeProcessor
from sofima_tpu_torch.utils import metrics
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.box_generator import BoxGenerator
from sofima_tpu_torch.utils.subvolume import Subvolume
from sofima_tpu_torch.utils.volume import (BaseVolume, InMemoryVolume,
                                           open_volume)


def _read_padded(vol: BaseVolume, box: BoundingBox) -> np.ndarray:
  """Reads `box` from `vol`, padding out-of-bounds voxels.

  Pads with NaN for float volumes and 0 otherwise.
  """
  if isinstance(vol, InMemoryVolume):
    return vol[box.to_slice4d()]  # handles OOB natively
  clipped = vol.clip_box_to_volume(box)
  fill = np.nan if np.issubdtype(vol.meta.dtype, np.floating) else 0
  out = np.full((vol.meta.num_channels,) + tuple(int(s) for s in
                                                 box.size[::-1]),
                fill, dtype=vol.meta.dtype)
  if clipped is not None:
    rel = clipped.translate(-box.start)
    out[rel.to_slice4d()] = vol[clipped.to_slice4d()]
  return out


def output_geometry(processor: SubvolumeProcessor,
                    in_meta) -> tuple[tuple[int, int, int], int]:
  """(output volume size XYZ, channels) for processing a full volume."""
  scale = 1.0 / processor.pixelsize(np.ones(3, np.float32))
  out_size = np.maximum(
      np.floor(np.array(in_meta.volume_size) * scale).astype(int), 1)
  channels = processor.num_channels(in_meta.num_channels)
  return tuple(int(v) for v in out_size), channels


def process_volume(
    processor: SubvolumeProcessor,
    input_volume,
    output_volume: BaseVolume | None = None,
    subvolume_size: Sequence[int] | None = None,
    parallelism: int = 1,
    work_boxes: Sequence[BoundingBox] | None = None,
    device=None,
) -> BaseVolume:
  """Maps `processor` over `input_volume`, returning the output volume.

  Args:
    processor: the SubvolumeProcessor to run
    input_volume: source volume (BaseVolume / ndarray / TS spec)
    output_volume: destination; created in memory if omitted
    subvolume_size: XYZ output-region size per work item (defaults to the
      processor's suggestion, clamped to the volume)
    parallelism: number of worker threads
    work_boxes: optional explicit work boxes (each *includes* context);
      computed from the tiling geometry if omitted
    device: where the processor's numeric work runs (passed to
      `processor.set_device`); None keeps the processor's own device

  Returns:
    the filled output volume
  """
  vol = open_volume(input_volume)
  if device is not None:
    processor.set_device(device)
  pre, post = processor.context()
  overlap = np.array(processor.overlap(), np.int64)

  if subvolume_size is None:
    suggested = np.array(tuple(processor.subvolume_size()), np.int64)
  else:
    suggested = np.array(subvolume_size, np.int64)
  vol_size = np.array(vol.meta.volume_size, np.int64)
  work_size = np.minimum(suggested, vol_size + overlap)

  if work_boxes is None:
    # Expand the volume bounds by the context so border outputs get
    # (padded) context too, then tile with the processor's overlap.
    outer = BoundingBox(
        start=(-np.array(pre)).tolist(),
        size=(vol_size + np.array(pre) + np.array(post)).tolist())
    gen = BoxGenerator(outer, box_size=work_size, box_overlap=overlap,
                       back_shift_small_boxes=True)
    work_boxes = list(gen)

  if output_volume is None:
    out_size, channels = output_geometry(processor, vol.meta)
    dtype = processor.output_type(vol.meta.dtype)
    fill = np.nan if np.issubdtype(np.dtype(dtype), np.floating) else 0
    output_volume = InMemoryVolume(
        np.full((channels,) + out_size[::-1], fill, dtype=dtype),
        pixel_size=tuple(
            processor.pixelsize(np.asarray(vol.meta.pixel_size))))

  processor.set_effective_subvol_and_overlap(work_size, overlap)

  def one(box: BoundingBox):
    with metrics.timer_counter(processor.namespace, 'process'):
      data = _read_padded(vol, box)
      result = processor.process(Subvolume(data, box))
    if result is None:
      return
    results = result if isinstance(result, list) else [result]
    for sv in results:
      output_volume.write(sv.data.astype(output_volume.meta.dtype),
                          sv.bbox)
    metrics.counter(processor.namespace, 'subvolumes-done').inc()

  if parallelism > 1:
    with concurrent.futures.ThreadPoolExecutor(parallelism) as pool:
      list(pool.map(one, work_boxes))
  else:
    for box in work_boxes:
      one(box)

  return output_volume
