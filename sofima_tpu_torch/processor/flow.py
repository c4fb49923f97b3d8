"""Flow-estimation processors.

Twin of sofima_tpu/processor/flow.py: chunked section-to-section flow
estimation, multi-resolution flow fusion, and multi-Δz re-estimation of
missing flow entries. Subvolumes are numpy in and out; the numeric work
runs on the processor's `device` (the CUDA card by default):

  * EstimateFlow: the default 'circular_dft' mode with several section
    pairs runs one K1 launch per pair (`dense_flow_field(circular=True)`,
    the reference's `per_pair_batch`), the flows stay on the device and
    come back in one copy; 'coarse_to_fine' runs K1 then K2; masked and
    selection-masked work items take the calculator's padfield mode;
  * ReconcileAndFilterFlows: clean_flow, the nearest / linear upsampling
    of lower-resolution flows and reconcile_flows on the device;
  * EstimateMissingFlow: the device waves (`_missing_flow_wave`, one
    torch function a wave, one copy back a section) or the host loop
    through the calculator (masked configs, and the `_force_host_waves`
    seam).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from sofima_tpu_torch import flow_field
from sofima_tpu_torch import flow_utils
from sofima_tpu_torch import placement
from sofima_tpu_torch.ops import interp
from sofima_tpu_torch.processor.base import (SubvolumeProcessor,
                                             SubvolumeOrMany, SuggestedXyz)
from sofima_tpu_torch.utils import metrics
from sofima_tpu_torch.utils import volume as volume_lib
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.subvolume import Subvolume


class EstimateFlow(SubvolumeProcessor):
  """Estimates section-to-section optical flow over a z-stack.

  Flow semantics: the flow f(z) for the section at z defines how points
  at z move to match the reference section at z - Δz:
      p(z) + f(z) <-> p(z - Δz)
  Δz > 0 references an earlier section (forward flow), Δz < 0 a later
  one. The flow value for the patch centered at pixel x is stored at
  node x // stride.
  """

  @dataclasses.dataclass(eq=True)
  class Config:
    """patch_size must be divisible by stride; z_stride is Δz.

    fixed_current computes all flows against a fixed current section
    (first/last of the subvolume depending on the z_stride sign) —
    used for coming-in regions. mask_configs masks input voxels,
    selection_mask_configs selects output flow entries to compute.
    flow_mode: 'padfield' | 'circular' | 'circular_dft' |
    'circular_dft_bf16' | 'coarse_to_fine' (the port correlates every
    circular mode in float32). Masked / selection-masked work items use
    'padfield'.
    """
    patch_size: int
    stride: int
    z_stride: int = 1
    fixed_current: bool = False
    mask_configs: Any = None
    mask_only_for_patch_selection: bool = False
    selection_mask_configs: Any = None
    batch_size: int = 1024
    flow_mode: str = 'circular_dft'

  def __init__(self, config: 'EstimateFlow.Config',
               input_volinfo_or_ts_spec=None, device=None):
    del input_volinfo_or_ts_spec
    assert config.patch_size % config.stride == 0
    self._config = config
    self._device = device

  def output_type(self, input_type):
    return np.float32

  def subvolume_size(self):
    size = self._config.patch_size * 8
    return SuggestedXyz(size, size, 16)

  def context(self):
    pre = self._config.patch_size // 2
    post = self._config.patch_size - pre
    z = self._config.z_stride
    if self._config.fixed_current:
      return ((pre, pre, 0), (post, post, z)) if z > 0 else (
          (pre, pre, -z), (post, post, 0))
    return ((pre, pre, z), (post, post, 0)) if z > 0 else (
        (pre, pre, 0), (post, post, -z))

  def num_channels(self, input_channels):
    del input_channels
    return (flow_field.JAXMaskedXCorrWithStatsCalculator
            .non_spatial_flow_channels + 2)

  def pixelsize(self, psize):
    psize = np.asarray(psize).copy().astype(np.float32)
    psize[:2] *= self._config.stride
    return psize

  def _pairs(self, nz: int) -> list[tuple[int, int]]:
    config = self._config
    if config.fixed_current:
      if config.z_stride > 0:
        return [(z, nz - 1) for z in range(nz - 1)]
      return [(z, 0) for z in range(1, nz)]
    if config.z_stride > 0:
      return [(z, z + config.z_stride) for z in range(nz - config.z_stride)]
    return [(z, z + config.z_stride) for z in range(-config.z_stride, nz)]

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    config = self._config
    box = subvol.bbox
    self.counter('subvolumes-started').inc()
    assert subvol.data.shape[0] == 1, 'Input volume should have 1 channel.'
    image = subvol.data[0]

    sel_mask = mask = None
    with self.timer('build-mask'):
      if config.mask_configs is not None:
        mask = self._build_mask(config.mask_configs, box)
      if config.selection_mask_configs is not None:
        sel_box = box.scale([1.0 / config.stride, 1.0 / config.stride, 1])
        sel_mask = self._build_mask(config.selection_mask_configs, sel_box)

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator(device=self._device)
    # coarse_to_fine is a dense unmasked grid mode; masked / selection
    # work items fall back to the padfield mode (same grid contract).
    per_pair_mode = ('padfield' if config.flow_mode == 'coarse_to_fine'
                     else config.flow_mode)
    unmasked = mask is None and sel_mask is None
    patch_t = (config.patch_size, config.patch_size)
    step_t = (config.stride, config.stride)

    with self.timer('flow'):
      pairs = self._pairs(image.shape[0])
      if config.flow_mode == 'coarse_to_fine' and unmasked:
        stack = placement.place(image, self._device, torch.float32)
        ret = torch.stack([
            flow_field.coarse_to_fine_flow(stack[zp], stack[zc], patch_t,
                                           step_t)
            for zp, zc in pairs]).cpu().numpy()
      elif config.flow_mode != 'padfield' and unmasked and len(pairs) > 1:
        # Every section pair on the device, one K1 launch each; one copy
        # back for all of them.
        stack = placement.place(image, self._device, torch.float32)
        per_pair_batch = max(64, config.batch_size // len(pairs))
        ret = torch.stack([
            flow_field.dense_flow_field(stack[zp], stack[zc], patch_t,
                                        step_t, batch_size=per_pair_batch,
                                        circular=True)
            for zp, zc in pairs]).cpu().numpy()
      else:
        ret = np.array([  # [z, c, gy, gx]
            mfc.flow_field(
                image[zp], image[zc], config.patch_size, config.stride,
                None if mask is None else mask[zp],
                None if mask is None else mask[zc],
                mask_only_for_patch_selection=(
                    config.mask_only_for_patch_selection),
                selection_mask=None if sel_mask is None else sel_mask[zc],
                batch_size=config.batch_size, mode=per_pair_mode)
            for zp, zc in pairs])

    out_box = self.crop_box(box)
    out_box = BoundingBox(
        start=out_box.start // [config.stride, config.stride, 1],
        size=[ret.shape[-1], ret.shape[-2], int(out_box.size[2])])
    if ret.shape[0] != out_box.size[2]:
      raise ValueError(f'flow z {ret.shape} vs box {out_box.size}')

    self.counter('subvolumes-done').inc()
    return Subvolume(np.transpose(ret, (1, 0, 2, 3)), out_box)

  # The flow grid is stride-decimated; shrink the overlap by one stride so
  # neighboring work items never produce the same output node.
  def overlap(self):
    ov = super().overlap()
    return (ov[0] - self._config.stride, ov[1] - self._config.stride, ov[2])

  def expected_output_box(self, box: BoundingBox) -> BoundingBox:
    scale = 1.0 / self.pixelsize(np.ones(3, np.float32))
    scaled = self.crop_box(box).scale(list(scale))
    size = scaled.size.copy()
    size[:2] = (np.array(tuple(self.subvolume_size())[:2])
                - self._config.patch_size
                + self._config.stride) // self._config.stride
    return BoundingBox(scaled.start, size)


@dataclasses.dataclass(frozen=True)
class FlowSource:
  """A flow volume + optional magnitude divisor for multi-res fusion."""

  volume: Any
  scale: float | None = None  # flow magnitude divisor; pixel ratio if None


class ReconcileAndFilterFlows(SubvolumeProcessor):
  """Cleans flows and fuses multi-resolution estimates.

  The highest-resolution flow is cleaned; any entries invalidated by the
  quality filters are filled from progressively lower-resolution flows
  (upsampled to the base grid with invalid-preserving interpolation and
  magnitude rescaling), then jointly filtered with reconcile_flows.
  """

  crop_at_borders = False

  @dataclasses.dataclass(eq=True)
  class Config:
    flow_volinfos: Any = None       # list of FlowSource/volumes (low-res)
    mask_configs: Any = None
    min_peak_ratio: float = 1.6
    min_peak_sharpness: float = 1.6
    max_magnitude: float = 40
    max_deviation: float = 10
    max_gradient: float = 40
    min_patch_size: int = 400
    multi_section: bool = False
    base_delta_z: int = 1

  def __init__(self, config: 'ReconcileAndFilterFlows.Config',
               input_path_or_metadata=None, device=None):
    self._config = config
    self._sources: list[FlowSource | None] = [None]
    self._base = input_path_or_metadata
    self._device = device
    for entry in (config.flow_volinfos or []):
      if not isinstance(entry, FlowSource):
        entry = FlowSource(volume=entry)
      self._sources.append(entry)

  def num_channels(self, input_channels=0):
    del input_channels
    return 3 if self._config.multi_section else 2

  def _pixel_ratio(self, vol) -> float:
    base = self._open_volume(self._base)
    ratio = base.meta.pixel_size[0] / vol.meta.pixel_size[0]
    assert ratio <= 1.0
    return ratio

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    config = self._config
    dev = self._device
    box = subvol.bbox
    mask = None
    if config.mask_configs is not None:
      mask = self._build_mask(config.mask_configs, box)

    flows = []
    for i, source in enumerate(self._sources):
      if i == 0:
        flow = np.asarray(subvol.data, np.float32)
        scale = 1.0
        read_box = box
      else:
        vol = self._open_volume(source.volume)
        scale = self._pixel_ratio(vol)
        read_box = box.scale((scale, scale, 1))
        if scale < 1:
          pre, post = self.context()
          read_box = read_box.adjusted_by(
              start=tuple(-p for p in pre), end=post)
        read_box = vol.clip_box_to_volume(read_box)
        assert read_box is not None
        with metrics.timer_counter('reconcile-flows', f'load-{i}'):
          flow = vol[read_box.to_slice4d()]

      with metrics.timer_counter('reconcile-flows', f'clean-{i}'):
        flow = flow_utils.clean_flow(
            flow, config.min_peak_ratio, config.min_peak_sharpness,
            config.max_magnitude, config.max_deviation, device=dev)

      if i == 0 or scale == 1:
        if config.multi_section and flow.shape[0] != 3:
          shape = np.array(flow.shape)
          shape[0] = 3
          nflow = np.full(shape, np.nan, dtype=flow.dtype)
          nflow[:2] = flow[:2]
          nflow[2][np.isfinite(nflow[0])] = config.base_delta_z
          flow = nflow
        flows.append(flow)
        continue

      mag_scale = source.scale if source.scale is not None else scale
      hires = np.zeros_like(flows[0])

      # Query grid: base nodes in low-res grid index coordinates.
      qy, qx = np.mgrid[:int(box.size[1]), :int(box.size[0])]
      qy = (qy + box.start[1]) * scale - read_box.start[1]
      qx = (qx + box.start[0]) * scale - read_box.start[0]
      coords = placement.place(np.stack([qy, qx]).astype(np.float32), dev)

      with metrics.timer_counter('reconcile-flows', f'upsample-{i}'):
        for z in range(flow.shape[1]):
          # Nearest-style validity: a base node is invalid iff its
          # nearest low-res node is invalid.
          nearest = placement.to_host(interp.sample_channels(
              placement.place(flow[:, z], coords.device), coords,
              method='nearest', mode='constant', cval=np.nan))
          invalid = np.isnan(nearest[0])
          # Spatial channels: linear interpolation + magnitude rescale.
          linear = placement.to_host(interp.sample_channels(
              placement.place(np.nan_to_num(flow[:2, z]), coords.device),
              coords, method='linear', mode='constant', cval=np.nan))
          hires[:2, z] = linear / mag_scale
          hires[0, z][invalid] = np.nan
          hires[1, z][invalid] = np.nan
          for c in range(2, self.num_channels()):
            hires[c, z] = nearest[c]

      if mask is not None:
        flow_utils.apply_mask(hires, mask)
      flows.append(hires)

    ret = flow_utils.reconcile_flows(
        flows, config.max_gradient, config.max_deviation,
        config.min_patch_size, device=dev)
    return self.crop_box_and_data(box, ret)


def _missing_flow_wave(prev_d, curr_d, todo_d, attempts_d, out, bias_d, *,
                       search_patch, patch, stride, batch_size, max_attempts,
                       min_peak_ratio, min_peak_sharpness, max_magnitude,
                       delta_z):
  """One EstimateMissingFlow Δz wave as one torch function on the device.

  Computes the whole grid (enlarged search patches vs regular current
  patches, the linear correlation of `dense_flow_field` with
  `post_patch_size`), subtracts the origin bias, gates quality
  (`clean_flow_device`, no deviation filter), and folds the
  accept/attempt bookkeeping in: nothing crosses to the host.
  """
  flow4 = flow_field.dense_flow_field(
      prev_d, curr_d, (search_patch, search_patch), (stride, stride),
      batch_size=batch_size, post_patch_size=(patch, patch))
  flow4 = torch.cat([flow4[:2] - bias_d[:, None, None], flow4[2:]])
  active = todo_d & (attempts_d <= max_attempts)
  raw_valid = torch.isfinite(flow4[0])
  attempts_new = attempts_d + (raw_valid & active).to(torch.int32)
  clean = flow_utils.clean_flow_device(
      flow4[:, None], min_peak_ratio, min_peak_sharpness, max_magnitude,
      max_deviation=0.0)
  accept = active & torch.isfinite(clean[0, 0])
  out = torch.stack([
      torch.where(accept, clean[0, 0], out[0]),
      torch.where(accept, clean[1, 0], out[1]),
      torch.where(accept, torch.full_like(out[2], float(delta_z)), out[2])])
  return todo_d & ~accept, attempts_new, out


class EstimateMissingFlow(SubvolumeProcessor):
  """Fills invalid flow entries by estimating against farther sections.

  For every NaN entry of the input (single-Δz) flow volume, flow is
  re-estimated against sections at increasing |Δz| (up to max_delta_z),
  with an enlarged search patch on the 'previous' section
  (search_radius), quality gating, and a per-voxel attempt budget.
  Output channels: flow_x, flow_y, lookback_z.
  """

  @dataclasses.dataclass(frozen=True)
  class Config:
    patch_size: int
    stride: int
    delta_z: int = 1
    max_delta_z: int = 4
    max_attempts: int = 2
    mask_configs: Any = None
    mask_only_for_patch_selection: bool = True
    selection_mask_configs: Any = None
    min_peak_ratio: float = 1.6
    min_peak_sharpness: float = 1.6
    max_magnitude: int = 40
    batch_size: int = 1024
    image_volinfo: Any = None
    image_cache_bytes: int = 0
    mask_cache_bytes: int = 0
    search_radius: int = 0

  def __init__(self, config: 'EstimateMissingFlow.Config',
               input_volinfo_or_ts_spec=None, device=None):
    del input_volinfo_or_ts_spec
    if config.patch_size % config.stride:
      raise ValueError('patch_size must be a multiple of stride')
    self._search_patch_size = config.patch_size + config.search_radius * 2
    if self._search_patch_size % config.stride:
      raise ValueError('search patch size must be a multiple of stride')
    self._config = config
    self._image_vol = None
    self._device = device

  def _open_image_volume(self):
    """Image volume behind a persistent LRU cache (image_cache_bytes)."""
    if self._image_vol is None:
      self._image_vol = volume_lib.maybe_cache(
          self._open_volume(self._config.image_volinfo),
          self._config.image_cache_bytes, 'EstimateMissingFlow_image')
    return self._image_vol

  def num_channels(self, input_channels):
    del input_channels
    return 3

  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    config = self._config
    box = subvol.bbox
    self.counter('subvolumes-started').inc()
    image_volume = self._open_image_volume()
    stride = config.stride

    # Image region covered by the flow grid incl. the search context.
    full_image_box = BoundingBox(
        start=(int(box.start[0]) * stride - self._search_patch_size // 2,
               int(box.start[1]) * stride - self._search_patch_size // 2,
               int(box.start[2])),
        size=((int(box.size[0]) - 1) * stride + self._search_patch_size,
              (int(box.size[1]) - 1) * stride + self._search_patch_size, 1))
    prev_image_box = image_volume.clip_box_to_volume(full_image_box)
    assert prev_image_box is not None
    if np.any(prev_image_box.size[:2] <= self._search_patch_size):
      return subvol

    # Trim flow entries lacking image context.
    offset = prev_image_box.translate(-full_image_box.start).start // stride
    out_box = box.adjusted_by(start=offset)
    data = subvol.data[:, :, int(offset[1]):, int(offset[0]):]
    offset = -((prev_image_box.end - full_image_box.end) // stride)
    out_box = out_box.adjusted_by(end=-offset)
    data = data[:, :, :int(out_box.size[1]), :int(out_box.size[0])]

    ret = np.zeros([3] + list(int(s) for s in out_box.size[::-1]))
    ret[:2] = data[:2]
    ret[2] = config.delta_z

    sel_mask = None
    if config.selection_mask_configs is not None:
      sel_mask = self._build_mask(config.selection_mask_configs, out_box)

    mfc = flow_field.JAXMaskedXCorrWithStatsCalculator(device=self._device)
    invalid = np.isnan(data[0])

    patch_size = config.patch_size
    curr_image_box = BoundingBox(
        start=(int(out_box.start[0]) * stride - patch_size // 2,
               int(out_box.start[1]) * stride - patch_size // 2,
               int(out_box.start[2])),
        size=((int(out_box.size[0]) - 1) * stride + patch_size,
              (int(out_box.size[1]) - 1) * stride + patch_size,
              invalid.shape[0]))
    curr_image_box = image_volume.clip_box_to_volume(curr_image_box)
    assert curr_image_box is not None

    if config.delta_z > 0:
      search_deltas = range(config.delta_z + 1, config.max_delta_z + 1)
      load_z = (int(out_box.start[2]) - config.max_delta_z,
                int(out_box.end[2]))
    else:
      search_deltas = range(config.delta_z - 1, config.max_delta_z - 1, -1)
      load_z = (int(out_box.start[2]),
                int(out_box.end[2]) - config.max_delta_z)

    load_box = BoundingBox(
        start=(int(prev_image_box.start[0]), int(prev_image_box.start[1]),
               load_z[0]),
        size=(int(prev_image_box.size[0]), int(prev_image_box.size[1]),
              load_z[1] - load_z[0]))
    load_box = image_volume.clip_box_to_volume(load_box)

    # Sections are read lazily, one z-row at a time: the retry loop only
    # probes a data-dependent subset of sections. With image_cache_bytes
    # > 0 the rows are LRU-cached on the processor instance, so
    # overlapping work items share them.
    nz = int(load_box.size[2])

    def _section_box(i: int) -> BoundingBox:
      return BoundingBox(
          start=(int(load_box.start[0]), int(load_box.start[1]),
                 int(load_box.start[2]) + i),
          size=(int(load_box.size[0]), int(load_box.size[1]), 1))

    def image_section(i: int) -> np.ndarray:
      return image_volume[_section_box(i).to_slice4d()][0, 0]

    mask_section = None
    if config.mask_configs is not None:
      mask_cache: dict[int, np.ndarray] = {}

      def mask_section(i: int) -> np.ndarray:
        if i in mask_cache:
          metrics.counter('EstimateMissingFlow_mask', 'hits').inc()
          return mask_cache[i]
        m = self._build_mask(config.mask_configs, _section_box(i))[0]
        budget = config.mask_cache_bytes
        if budget > 0 and (len(mask_cache) + 1) * m.nbytes <= budget:
          mask_cache[i] = m
        metrics.counter('EstimateMissingFlow_mask', 'misses').inc()
        return m

    rel = curr_image_box.start - load_box.start
    curr_slice = (slice(int(rel[1]), int(rel[1] + curr_image_box.size[1])),
                  slice(int(rel[0]), int(rel[0] + curr_image_box.size[0])))

    # Unmasked configs take the device waves: every Δz wave is one torch
    # function over the whole grid with accept/attempt bookkeeping on the
    # device, and the results come back in one copy per section.
    # `_force_host_waves` is a test seam pinning the two paths together.
    device_waves = config.mask_configs is None and not getattr(
        self, '_force_host_waves', False)

    for z in range(invalid.shape[0]):
      if not invalid[z].any():
        self.counter('sections-already-valid').inc()
        continue

      curr_z = (int(out_box.start[2]) + z) - int(load_box.start[2])
      assert 0 <= curr_z < nz

      curr_mask = None
      if mask_section is not None:
        curr_mask = mask_section(curr_z)[curr_slice]
        if curr_mask.all():
          self.counter('sections-masked').inc()
          continue

      attempts = np.zeros(ret.shape[2:], dtype=int)
      todo = ~np.isfinite(ret[0, z])
      if sel_mask is not None:
        todo &= sel_mask[z]
      curr = image_section(curr_z)[curr_slice]

      if device_waves:
        filled = self._device_wave_fill(
            curr, todo, image_section, curr_z, nz, search_deltas,
            (float(rel[0]), float(rel[1])))
        for delta_z, count in filled['counts'].items():
          self.counter(f'filled-delta{delta_z}').inc(count)
        acc = np.isfinite(filled['flow'][0])
        ret[0, z][acc] = filled['flow'][0][acc]
        ret[1, z][acc] = filled['flow'][1][acc]
        ret[2, z][acc] = filled['flow'][2][acc]
        continue

      for delta_z in search_deltas:
        prev_z = curr_z - delta_z
        if prev_z < 0 or prev_z >= nz:
          break

        prev_mask = None
        if mask_section is not None:
          prev_mask = mask_section(prev_z)
          if prev_mask.all():
            continue

        todo &= attempts <= config.max_attempts
        if not todo.any():
          break
        prev = image_section(prev_z)

        with self.timer('flow'):
          flow = mfc.flow_field(
              prev, curr, self._search_patch_size, stride, prev_mask,
              curr_mask,
              mask_only_for_patch_selection=(
                  config.mask_only_for_patch_selection),
              selection_mask=todo, batch_size=config.batch_size,
              post_patch_size=patch_size)

        # `prev` spans the full search context while `curr` is inset by
        # (search_patch - patch)/2; flow_field assumes both images share
        # an origin, so the measured flow carries a constant bias equal
        # to that origin offset. Subtract it, as the reference does.
        flow[0] -= float(rel[0])
        flow[1] -= float(rel[1])

        valid = np.isfinite(flow[0])
        attempts[:valid.shape[0], :valid.shape[1]][valid] += 1

        flow = flow_utils.clean_flow(
            flow[:, np.newaxis], config.min_peak_ratio,
            config.min_peak_sharpness, config.max_magnitude,
            max_deviation=0.0, device=self._device)

        sy, sx = flow.shape[2:]
        accept = todo[:sy, :sx] & np.isfinite(flow[0, 0])
        todo[:sy, :sx][accept] = False
        self.counter(f'filled-delta{delta_z}').inc(int(accept.sum()))
        ret[2, z, :sy, :sx][accept] = delta_z
        ret[0, z, :sy, :sx][accept] = flow[0, 0][accept]
        ret[1, z, :sy, :sx][accept] = flow[1, 0][accept]

    return Subvolume(ret, out_box)

  def _device_wave_fill(self, curr, todo, image_section, curr_z, nz,
                        search_deltas, bias):
    """Device-resident Δz waves: one function per wave, one final copy.

    Semantics match the host loop (selection_mask batching included):
    attempts only increment for todo patches that produced a raw peak,
    quality gating via clean_flow with max_deviation=0, first accepted
    Δz wins. Patches outside every section's range stay NaN.
    """
    config = self._config
    dev = placement.resolve(self._device)
    todo_d = torch.as_tensor(todo, device=dev)
    attempts_d = torch.zeros(todo.shape, dtype=torch.int32, device=dev)
    out = torch.full((3,) + todo.shape, float('nan'), dtype=torch.float32,
                     device=dev)
    curr_d = placement.place(curr, dev, torch.float32)
    bias_d = torch.tensor([bias[0], bias[1]], dtype=torch.float32,
                          device=dev)

    ran_deltas = []
    for delta_z in search_deltas:
      prev_z = curr_z - delta_z
      if prev_z < 0 or prev_z >= nz:
        break
      prev_d = placement.place(image_section(prev_z), dev, torch.float32)
      with self.timer('flow'):
        todo_d, attempts_d, out = _missing_flow_wave(
            prev_d, curr_d, todo_d, attempts_d, out, bias_d,
            search_patch=self._search_patch_size, patch=config.patch_size,
            stride=config.stride, batch_size=config.batch_size,
            max_attempts=config.max_attempts,
            min_peak_ratio=config.min_peak_ratio,
            min_peak_sharpness=config.min_peak_sharpness,
            max_magnitude=config.max_magnitude, delta_z=delta_z)
      ran_deltas.append(delta_z)

    flow_np = out.cpu().numpy()  # one copy back for all waves
    counts = {}
    for delta_z in ran_deltas:
      counts[delta_z] = int((flow_np[2] == delta_z).sum())
    return {'flow': flow_np, 'counts': counts}
