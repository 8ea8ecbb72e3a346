"""Test-time augmentation: the detector over flipped and rotated copies of
a frame, its detections mapped back and merged by weighted NMS
(counterpart of ``sst_tpu/models/tta.py``).

The augmentations are applied to the batch's tensors around any ``predict``
of the port (``predict_fn(batch) -> dict(boxes [B, K, 7+], scores, labels,
valid)``); the merge runs per sample, class-aware through a per-label x
offset, on ``core/nms.py weighted_nms_bev``, and its top ``max_num`` keeps
``jax.lax.top_k``'s tie order.
"""

from __future__ import annotations

import dataclasses

import torch

from sst_tpu_torch.core.boxes import flip_boxes, rotate_2d, rotate_boxes
from sst_tpu_torch.core.nms import weighted_nms_bev
from sst_tpu_torch.ops.ccl import stable_topk


def _flip_points(points: torch.Tensor, axis: str) -> torch.Tensor:
    # the boxes' "x" flip negates y (horizontal flip), "y" negates x
    idx = 1 if axis == "x" else 0
    out = points.clone()
    out[..., idx] = -points[..., idx]
    return out


def _aug_batch(batch, flip: str, angle: float):
    pts = batch.points
    if flip in ("x", "y"):
        pts = _flip_points(pts, flip)
    elif flip == "xy":
        pts = _flip_points(_flip_points(pts, "x"), "y")
    if angle:
        b, p, _ = pts.shape
        yaw = torch.full((b * p,), angle, dtype=pts.dtype, device=pts.device)
        xy = rotate_2d(pts[..., :2].reshape(-1, 2), yaw)
        pts = torch.cat([xy.reshape(b, p, 2), pts[..., 2:]], dim=-1)
    return dataclasses.replace(batch, points=pts)


def _invert_boxes(boxes: torch.Tensor, flip: str,
                  angle: float) -> torch.Tensor:
    """Detections of the augmented frame in the original frame."""
    if angle:
        boxes = rotate_boxes(boxes, -angle)
    if flip in ("x", "y"):
        boxes = flip_boxes(boxes, flip)
    elif flip == "xy":
        boxes = flip_boxes(flip_boxes(boxes, "x"), "y")
    return boxes


def tta_predict(predict_fn, batch, flips=("none", "x", "y", "xy"),
                angles=(0.0,), wnms_thr_lo: float = 0.1,
                wnms_thr_hi: float = 0.55, max_num: int = 500) -> dict:
    """Augmented inference and the weighted-NMS merge: one ``predict_fn``
    call per (flip, angle), in that order. Returns the predict schema with
    [B, min(max_num, rows)] rows (scores 0 and ``valid`` False past the
    kept boxes)."""
    all_boxes, all_scores, all_labels, all_valid = [], [], [], []
    for flip in flips:
        for angle in angles:
            if flip != "none" or angle:
                out = predict_fn(_aug_batch(batch, flip, angle))
                boxes = torch.stack([_invert_boxes(b, flip, angle)
                                     for b in out["boxes"]])
            else:
                out = predict_fn(batch)
                boxes = out["boxes"]
            all_boxes.append(boxes)
            all_scores.append(out["scores"])
            all_labels.append(out["labels"])
            all_valid.append(out["valid"])
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    labels = torch.cat(all_labels, dim=1)
    valid = torch.cat(all_valid, dim=1)

    merged = {"boxes": [], "scores": [], "labels": [], "valid": []}
    for i in range(boxes.shape[0]):
        # class-aware merge: the centres offset per label, so the weighted
        # NMS never mixes classes (one frame: a large x offset is safe)
        off = labels[i].float() * 1e4
        shifted = boxes[i, :, :7].clone()
        shifted[:, 0] = shifted[:, 0] + off
        mboxes, mscores, keep = weighted_nms_bev(
            shifted, scores[i], valid[i], thr_lo=wnms_thr_lo,
            thr_hi=wnms_thr_hi)
        mboxes = mboxes.clone()
        mboxes[:, 0] = mboxes[:, 0] - off
        s = torch.where(keep, mscores, -torch.inf)
        top, idx = stable_topk(s, min(max_num, s.shape[0]))
        finite = torch.isfinite(top)
        merged["boxes"].append(mboxes[idx])
        merged["scores"].append(torch.where(finite, top, 0.0))
        merged["labels"].append(labels[i][idx])
        merged["valid"].append(finite)
    return {k: torch.stack(v) for k, v in merged.items()}
