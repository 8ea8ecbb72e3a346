"""Target assignment (counterpart of ``sst_tpu/core/target_assign.py``; the
per-point gt labels FSD's ``add_gt_fg_points`` reads)."""

from __future__ import annotations

import torch

from sst_tpu_torch.core.boxes import points_in_boxes


def gt_point_class_labels(points_xyz, batch_idx, valid, gt_boxes, gt_labels,
                          gt_valid):
    """[P] int32: the class of the first valid gt box of its sample that
    holds the point, -1 when none does (and for invalid points)."""
    b, g = gt_boxes.shape[:2]
    gt_flat = gt_boxes.reshape(b * g, -1)[:, :7]
    gt_b = torch.arange(b, dtype=batch_idx.dtype,
                        device=batch_idx.device).repeat_interleave(g)
    ok = (points_in_boxes(points_xyz[:, :3], gt_flat)
          & gt_valid.reshape(1, -1)
          & (batch_idx[:, None] == gt_b[None, :]))
    first = torch.argmax(ok.to(torch.uint8), dim=1)
    lbl = torch.where(ok.any(dim=1), gt_labels.reshape(-1)[first], -1)
    return torch.where(valid, lbl, -1).to(torch.int32)
