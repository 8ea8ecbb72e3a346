"""Target assignment (counterpart of ``sst_tpu/core/target_assign.py``: the
anchor head's max-IoU assigner and the per-point gt labels FSD's
``add_gt_fg_points`` reads)."""

from __future__ import annotations

import torch

from sst_tpu_torch.core.boxes import points_in_boxes

NEG = -1
IGNORE = -2


def max_iou_assign(anchors, gts, gt_valid, pos_thr: float, neg_thr: float,
                   min_pos_iou: float, iou_fn):
    """Each anchor to a gt box (mmdet ``MaxIoUAssigner``).

    Args:
      anchors: [A, 7]; gts: [G, 7+] padded gt boxes; gt_valid: [G] bool;
      iou_fn: pairwise (a_boxes, b_boxes) -> [n, m] IoU.

    Returns (assigned [A] int32: gt index, NEG or IGNORE; max_iou [A]): an
    anchor whose best IoU reaches ``pos_thr`` takes its first best gt, one
    below ``neg_thr`` is negative, the rest are ignored; then every anchor
    that achieves some valid gt's best IoU (at least ``min_pos_iou``) takes
    the first such gt. The JAX package streams the anchors in chunks to
    bound its memory; the full [A, G] matrix gives the same result."""
    iou = iou_fn(anchors, gts[:, :7])
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    max_iou = iou.amax(dim=1)
    argmax_gt = torch.argmax(iou, dim=1).to(torch.int32)
    # JAX's running maximum starts from -1 (an invalid gt's IoU)
    gt_best = torch.clamp(iou.amax(dim=0), min=-1.0)
    assigned = torch.full_like(argmax_gt, IGNORE)
    assigned = torch.where(max_iou < neg_thr, NEG, assigned)
    assigned = torch.where(max_iou >= pos_thr, argmax_gt, assigned)
    hit = ((iou == gt_best[None, :]) & (gt_best[None, :] >= min_pos_iou)
           & gt_valid[None, :])
    which = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.int32)
    return torch.where(hit.any(dim=1), which, assigned), max_iou


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
