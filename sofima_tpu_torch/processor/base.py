"""SubvolumeProcessor: the chunk-parallel scale-out unit.

Twin of sofima_tpu/processor/base.py. A processor declares its halo
(`context`), preferred work geometry (`subvolume_size`, `overlap`), output
geometry transforms (`num_channels`, `pixelsize`, `expected_output_box`)
and a `process(Subvolume) -> Subvolume(s)` method; the runner
(sofima_tpu_torch.processor.runner) maps it over chunked volumes.
Subvolumes are numpy in and out, as in the reference; the port's
processors take a trailing `device=None` (the CUDA card; 'cpu' runs the
plain versions) on which their numeric work runs.

Deployment-specific I/O goes through overridable hooks (`_open_volume`,
`_build_mask`, `_get_metadata`, `_load_stitched_tile`) — the dependency
injection seam used by concrete deployments and tests alike.
"""

from __future__ import annotations

import collections
import enum
from typing import Any, Sequence

import numpy as np

from sofima_tpu_torch.utils import metrics
from sofima_tpu_torch.utils.bounding_box import BoundingBox
from sofima_tpu_torch.utils.subvolume import Subvolume
from sofima_tpu_torch.utils import volume as volume_lib

SuggestedXyz = collections.namedtuple('SuggestedXyz', 'x y z')
TupleOrSuggestedXyz = Any
SubvolumeOrMany = Subvolume | list[Subvolume]


class OutputNums(enum.Enum):
  SINGLE = 1
  MULTI = 2


class SubvolumeProcessor:
  """Base class for chunk-parallel volume processors."""

  # Whether the returned data should be cropped at the borders of the
  # containing volume (i.e. whether context is expected there).
  crop_at_borders = True
  output_num = OutputNums.SINGLE

  @property
  def namespace(self) -> str:
    return type(self).__name__

  @property
  def name_parts(self) -> tuple[str, ...]:
    return (type(self).__name__,)

  # -- Work geometry -------------------------------------------------------
  def context(self) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """(pre, post) XYZ context (halo) needed around the output region."""
    return (0, 0, 0), (0, 0, 0)

  def subvolume_size(self) -> TupleOrSuggestedXyz:
    """Suggested XYZ size of the output region of a work item."""
    return SuggestedXyz(512, 512, 16)

  def overlap(self) -> TupleOrSuggestedXyz:
    """XYZ overlap between adjacent work subvolumes (= summed context)."""
    pre, post = self.context()
    return tuple(p + q for p, q in zip(pre, post))

  # -- Output geometry -----------------------------------------------------
  def output_type(self, input_type):
    return input_type

  def num_channels(self, input_channels: int) -> int:
    return input_channels

  def pixelsize(self, psize) -> np.ndarray:
    return np.asarray(psize)

  def crop_box(self, box: BoundingBox) -> BoundingBox:
    """Removes the context margin from a work box."""
    pre, post = self.context()
    return box.adjusted_by(start=pre, end=tuple(-q for q in post))

  def crop_box_and_data(self, box: BoundingBox,
                        data: np.ndarray) -> Subvolume:
    """Crops `data` ([c, z, y, x], covering `box`) to the context-free box."""
    cropped = self.crop_box(box)
    rel = cropped.translate(-box.start)
    return Subvolume(np.ascontiguousarray(data[rel.to_slice4d()]), cropped)

  def expected_output_box(self, box: BoundingBox) -> BoundingBox:
    """Output box produced for the work box `box`."""
    scale = 1.0 / self.pixelsize(np.ones(3, np.float32))
    return self.crop_box(box).scale(list(scale))

  # -- The work ------------------------------------------------------------
  def process(self, subvol: Subvolume) -> SubvolumeOrMany:
    raise NotImplementedError

  # -- Where the numeric work runs ----------------------------------------
  # The card by default (None); processors take `device=` last in their
  # constructors, and the runner's `device=` reaches them through here.
  _device = None

  @property
  def device(self):
    return self._device

  def set_device(self, device) -> None:
    self._device = device

  # -- Deployment hooks (overridden by deployments/tests) ------------------
  def set_effective_subvol_and_overlap(self, subvol_size, overlap) -> None:
    """Informs the processor of the runner's actual work geometry."""
    self._effective_subvol = subvol_size
    self._effective_overlap = overlap

  def _open_volume(self, spec) -> volume_lib.BaseVolume:
    return volume_lib.open_volume(spec)

  def _get_metadata(self, spec) -> volume_lib.VolumeMetadata:
    return volume_lib.open_volume(spec).meta

  def _get_mask_configs(self, mask_configs: str):
    raise NotImplementedError(
        'Mask-config parsing must be provided by a deployment subclass.')

  def _build_mask(self, mask_configs, box: BoundingBox):
    """Returns a ZYX boolean array for `box` (True = masked).

    Accepts a raw boolean source (ndarray / BaseVolume, read as-is) or a
    structured mask config (utils.mask.MaskConfigs / MaskConfig / dicts)
    with threshold/invert/combine semantics.
    """
    if isinstance(mask_configs, (np.ndarray, volume_lib.BaseVolume)):
      vol = volume_lib.open_volume(mask_configs)
      return vol[box.to_slice4d()][0].astype(bool)
    from sofima_tpu_torch.utils import mask as mask_lib
    return mask_lib.build_mask(mask_configs, box, opener=self._open_volume)

  def _load_stitched_tile(self, output_dir, box: BoundingBox
                          ) -> np.ndarray | None:
    raise NotImplementedError(
        'Tile loading must be provided by a deployment subclass.')

  # -- Metrics -------------------------------------------------------------
  def counter(self, name: str) -> metrics.counter:
    return metrics.counter(self.namespace, name)

  def timer(self, name: str):
    return metrics.timer_counter(self.namespace, name)


def default_run_geometry(
    processor: SubvolumeProcessor,
    requested_size: Sequence[int] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
  """Returns (work box size, overlap) XYZ for driving a processor."""
  size = np.array(requested_size if requested_size is not None
                  else tuple(processor.subvolume_size()), np.int64)
  overlap = np.array(tuple(processor.overlap()), np.int64)
  return size, overlap
