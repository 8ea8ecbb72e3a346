"""RoI-aware point pooling (counterpart of ``sst_tpu/ops/roiaware.py``;
the reference's ``RoIAwarePool3d`` CUDA op): each roi's interior points
rasterised onto a fixed (gx, gy, gz) grid of sub-voxels and reduced there.

The pairing is ``models/fsd/roi_head.py dynamic_point_pool``'s static
[R, K] layout (the first K points in each roi, no enlargement); the grid
reduction is one ``segment_reduce`` over the (roi, sub-voxel) slots. No
kernel of ours: torch ops.
"""

from __future__ import annotations

import torch

from sst_tpu_torch.models.fsd.roi_head import _local_frame, dynamic_point_pool
from sst_tpu_torch.ops.segment import segment_reduce


def roiaware_pool3d(points_xyz, feats, pts_valid, pts_batch, rois, roi_valid,
                    roi_batch, out_size=(4, 4, 4), mode: str = "max",
                    max_inbox_point: int = 256) -> torch.Tensor:
    """[R, gx, gy, gz, C] pooled features, 0 where a sub-voxel is empty (the
    CUDA op's zero-initialised output). ``mode`` is a ``segment_reduce``
    mode (``"max"``, ``"mean"``, ``"sum"``, ``"min"``)."""
    gx, gy, gz = out_size
    r = rois.shape[0]
    k = max_inbox_point
    pool = dynamic_point_pool(points_xyz, pts_valid, pts_batch, rois,
                              roi_valid, roi_batch, extra_wlh=(0.0, 0.0, 0.0),
                              max_inbox_point=k)
    flat_idx = pool["idx"].reshape(-1).long()
    pv = pool["valid"].reshape(-1)
    pts = points_xyz[flat_idx]
    f = feats[flat_idx]
    proi = rois.repeat_interleave(k, dim=0)
    lw, ll, lz = _local_frame(pts, proi)
    # box-local coordinates to sub-voxel indices: lw spans w (gx bins), ll
    # spans l (gy), lz the height (gz)
    ix, iy, iz = (torch.clamp((loc / torch.clamp(proi[:, c], min=1e-4)
                               + 0.5) * g, 0, g - 1e-4).to(torch.int32)
                  for loc, c, g in ((lw, 3, gx), (ll, 4, gy), (lz, 5, gz)))
    rid = torch.arange(r, dtype=torch.int32,
                       device=rois.device).repeat_interleave(k)
    slot = ((rid * gx + ix) * gy + iy) * gz + iz
    slot = torch.where(pv, slot, r * gx * gy * gz)
    out = segment_reduce(f, slot, r * gx * gy * gz, mode)
    return out.reshape(r, gx, gy, gz, -1)
