"""Map densification for the 3d render (subset).

Twin of sofima_tpu/warp.py. Ported: `_densify_box_3d`, which the
stitched-volume render (pipeline.stitch3d) uses to turn a tile's
inverted node map into per-voxel sampling coordinates. The rest of the
module (`warp_subvolume`, `ndimage_warp`, `render_tiles`, ...) is still
to be ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch

from sofima_tpu_torch.ops import interp


def _densify_box_3d(src_map_zyx: torch.Tensor, box_start, inv_stride,
                    neg_off, box_shape) -> torch.Tensor:
  """Trilinear map densification for one work box.

  `src_map_zyx`: [3, gz, gy, gx] absolute source coords at map nodes
  (channels z, y, x); output voxel v of the box samples the node grid at
  (box_start + v + neg_off) * inv_stride per axis, with linear
  extrapolation past the last node. Returns [3, *box_shape] per-voxel
  source sampling coords. The query grid is separable, so it is passed
  to the sampler as three broadcastable axis vectors.
  """
  dev = src_map_zyx.device
  coords = []
  for a in range(3):
    view = [1, 1, 1]
    view[a] = int(box_shape[a])
    iota = torch.arange(box_shape[a], dtype=torch.float32, device=dev)
    c = ((float(box_start[a]) + iota + float(neg_off[a]))
         * float(inv_stride[a]))
    coords.append(c.reshape(view))
  return torch.stack([interp.grid_sample_linear(src_map_zyx[a], coords)
                      .expand(*box_shape) for a in range(3)])
