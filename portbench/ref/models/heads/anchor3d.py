"""Anchor-based BEV detection head (counterpart of
``sst_tpu/models/heads/anchor3d.py``: forward, the per-class max-IoU
targets and the loss, and both inference paths of ``get_bboxes``).

Predictions are [B, H, W, A, K] with A = num_classes * num_rots and the
anchor axis ordered (class range, rotation), as in the JAX package. The
convolutions give [B, A * K, H, W]; they are permuted to channels last
before the reshape.

At a compute ``dtype`` below float32 (flax's ``dtype``) the convolutions'
products, and so the predictions, are in that dtype; ``loss`` and
``get_bboxes`` take them through JAX's promotions (the decoded boxes are
float32, the scores stay in the predictions' dtype).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.ref.core import losses as L
from portbench.ref.core.anchors import multiclass_aligned_anchors
from portbench.ref.core.box_coders import delta_decode, delta_encode
from portbench.ref.core.boxes import limit_period
from portbench.ref.core.iou import nearest_iou
from portbench.ref.core.nms import (
    box3d_multiclass_nms,
    multiclass_nms_preselected,
    topk_presort,
)
from portbench.ref.core.target_assign import IGNORE, max_iou_assign
from portbench.ref.models.layers import Conv


# the JAX head's loss weights, which no config changes
LOSS_CLS_WEIGHT, LOSS_BBOX_WEIGHT, LOSS_DIR_WEIGHT = 1.0, 0.5, 0.2


class Anchor3DHead(nn.Module):
    """``feat_channels`` is the width of the input map; ``assigner_thrs``
    per class (pos_iou_thr, neg_iou_thr, min_pos_iou)."""

    def __init__(self, num_classes: int = 3, feat_channels: int = 384,
                 use_direction_classifier: bool = True,
                 anchor_ranges: tuple = (
                     (-74.88, -74.88, -0.0345, 74.88, 74.88, -0.0345),
                     (-74.88, -74.88, -0.1188, 74.88, 74.88, -0.1188),
                     (-74.88, -74.88, 0.0, 74.88, 74.88, 0.0)),
                 anchor_sizes: tuple = ((2.08, 4.73, 1.77),
                                        (0.84, 1.81, 1.77),
                                        (0.84, 0.91, 1.74)),
                 anchor_rotations: tuple = (0.0, 1.5707963),
                 assigner_thrs: tuple = ((0.55, 0.4, 0.4), (0.5, 0.3, 0.3),
                                         (0.5, 0.3, 0.3)),
                 dir_offset: float = 0.7854, box_code_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.use_direction_classifier = use_direction_classifier
        self.anchor_ranges = tuple(anchor_ranges)
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_rotations = tuple(anchor_rotations)
        self.assigner_thrs = tuple(assigner_thrs)
        self.dir_offset = dir_offset
        self.box_code_size = box_code_size
        a = self.num_anchors
        self.conv_cls = Conv(feat_channels, a * num_classes, 1, dtype=dtype)
        self.conv_reg = Conv(feat_channels, a * box_code_size, 1, dtype=dtype)
        if use_direction_classifier:
            self.conv_dir_cls = Conv(feat_channels, a * 2, 1, dtype=dtype)
        self._anchors = {}  # (H, W, device) -> [num_cls, H*W*num_rot, 7]

    @property
    def num_rot(self) -> int:
        return len(self.anchor_rotations)

    @property
    def num_anchors(self) -> int:
        return self.num_classes * self.num_rot

    def grid_anchors(self, featmap_size, device="cpu") -> torch.Tensor:
        """[num_cls, H * W * num_rot, 7] float32 anchors on ``device``,
        made once per feature-map size and device (they are constants)."""
        key = (tuple(featmap_size), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(multiclass_aligned_anchors(
                featmap_size, self.anchor_ranges, self.anchor_sizes,
                self.anchor_rotations)).to(device)
        return self._anchors[key]

    def forward(self, x):
        """x: [B, C, H, W] -> dict of cls [B, H, W, A, num_classes], reg
        [B, H, W, A, 7] and dir [B, H, W, A, 2]."""
        b, _, h, w = x.shape
        a = self.num_anchors

        def hwak(t, k):
            return t.permute(0, 2, 3, 1).reshape(b, h, w, a, k)

        out = {"cls": hwak(self.conv_cls(x), self.num_classes),
               "reg": hwak(self.conv_reg(x), self.box_code_size)}
        if self.use_direction_classifier:
            out["dir"] = hwak(self.conv_dir_cls(x), 2)
        return out

    def _dir_target(self, yaw):
        rot = limit_period(yaw - self.dir_offset, 0.0, 2 * math.pi)
        return torch.clamp(torch.floor(rot / math.pi), 0, 1).to(torch.int32)

    def targets_single(self, anchors_by_cls, gt_boxes, gt_labels, gt_valid):
        """One sample's targets per anchor, [num_cls, M, ...] for anchors
        ``anchors_by_cls`` [num_cls, M, 7] (M = H * W * num_rot): each class
        range's anchors are assigned to the valid gt boxes of that class by
        nearest-BEV IoU. Labels are the class, ``num_classes`` for
        background and -1 for ignored anchors."""
        labels, bbox_t, bbox_w, dir_t, pos = [], [], [], [], []
        for c in range(self.num_classes):
            anchors = anchors_by_cls[c]
            p, n_thr, mp = self.assigner_thrs[c]
            assigned, _ = max_iou_assign(
                anchors, gt_boxes, gt_valid & (gt_labels == c), pos_thr=p,
                neg_thr=n_thr, min_pos_iou=mp, iou_fn=nearest_iou)
            is_pos = assigned >= 0
            matched = gt_boxes[torch.clamp(assigned, min=0).long()]
            lbl = torch.where(is_pos, c, self.num_classes)
            labels.append(torch.where(assigned == IGNORE, -1, lbl))
            bt = delta_encode(anchors, matched[:, :self.box_code_size])
            bbox_t.append(torch.where(is_pos[:, None], bt, 0.0))
            bbox_w.append(is_pos.float())
            dir_t.append(torch.where(is_pos, self._dir_target(matched[:, 6]),
                                     0))
            pos.append(is_pos)
        return {"labels": torch.stack(labels),
                "bbox_targets": torch.stack(bbox_t),
                "bbox_weights": torch.stack(bbox_w),
                "dir_targets": torch.stack(dir_t),
                "num_pos": torch.stack(pos).sum()}

    @staticmethod
    def _add_sin_difference(pred, target):
        """sin(a - b) = sin(a) cos(b) - cos(a) sin(b): the yaw channel of
        the prediction becomes sin(a) cos(b), the target's cos(a) sin(b)."""
        sin_p = torch.sin(pred[..., 6:7]) * torch.cos(target[..., 6:7])
        cos_t = torch.cos(pred[..., 6:7]) * torch.sin(target[..., 6:7])
        return (torch.cat([pred[..., :6], sin_p, pred[..., 7:]], dim=-1),
                torch.cat([target[..., :6], cos_t, target[..., 7:]], dim=-1))

    def loss(self, preds, anchors_by_cls, gt_boxes, gt_labels, gt_valid):
        """The focal classification loss over non-ignored anchors, the L1
        box loss (with the sine yaw difference) and the direction
        cross-entropy over positive anchors, each over the number of
        positives, and ``num_pos``. ``preds`` from :meth:`forward`;
        ``gt_*`` are [B, G, ...] padded."""
        b, h, w, _, _ = preds["cls"].shape
        ncls, nrot, k = self.num_classes, self.num_rot, self.box_code_size
        m = h * w * nrot
        tgts = [self.targets_single(anchors_by_cls, gt_boxes[i], gt_labels[i],
                                    gt_valid[i]) for i in range(b)]
        tgt = {key: torch.stack([t[key] for t in tgts]) for key in tgts[0]}

        def to_cls_major(t):  # [B, H, W, A, K] -> [B, cls * M, K]
            x = t.reshape(b, h * w, ncls, nrot, t.shape[-1])
            return x.permute(0, 2, 1, 3, 4).reshape(b, ncls * m, t.shape[-1])

        labels = tgt["labels"].reshape(-1)
        bbox_w = tgt["bbox_weights"].reshape(-1)
        num_pos = torch.clamp(tgt["num_pos"].sum().float(), min=1.0)
        loss_cls = L.sigmoid_focal_loss(
            to_cls_major(preds["cls"]).reshape(-1, ncls),
            torch.clamp(labels, min=0), weight=(labels >= 0).float(),
            avg_factor=num_pos) * LOSS_CLS_WEIGHT
        rp, rt = self._add_sin_difference(
            to_cls_major(preds["reg"]).reshape(-1, k),
            tgt["bbox_targets"].reshape(-1, k))
        loss_bbox = L.l1_loss(rp, rt, weight=bbox_w,
                              avg_factor=num_pos) * LOSS_BBOX_WEIGHT
        out = {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
               "num_pos": num_pos}
        if self.use_direction_classifier:
            out["loss_dir"] = L.cross_entropy_loss(
                to_cls_major(preds["dir"]).reshape(-1, 2),
                tgt["dir_targets"].reshape(-1), weight=bbox_w,
                avg_factor=num_pos) * LOSS_DIR_WEIGHT
        return out

    def _rotate_by_dir(self, boxes, dir_logits):
        """The direction classifier's half-turn on the decoded yaw."""
        dir_score = torch.argmax(dir_logits, dim=-1)
        rot = limit_period(boxes[..., 6] - self.dir_offset, 0.0, math.pi)
        yaw = rot + self.dir_offset + math.pi * dir_score.to(rot.dtype)
        return torch.cat([boxes[..., :6], yaw[..., None], boxes[..., 7:]],
                         dim=-1)

    def get_bboxes(self, preds, anchors_by_cls, score_thr=0.1, nms_thr=0.25,
                   nms_pre=4096, max_num=500, use_rotate_nms=True,
                   use_wnms=False, wnms_thr_lo=0.1, wnms_thr_hi=0.7):
        """Decode + per-class NMS per sample: per-class top-k on the raw
        logits (sigmoid is monotonic), then decode only the ``nms_pre``
        candidates. ``use_wnms``: the whole anchor grid decoded (with the
        direction classifier) and scored, then ``box3d_multiclass_nms``'s
        weighted NMS. Returns a dict of [B, max_num] boxes, scores,
        labels, valid."""
        b, h, w, _, _ = preds["cls"].shape
        ncls, nrot = self.num_classes, self.num_rot
        anchors_flat = anchors_by_cls.reshape(-1, 7)  # [cls * M, 7]
        # the JAX package takes the log in float32
        logit_thr = torch.log(torch.tensor(score_thr / (1.0 - score_thr),
                                           dtype=torch.float32))

        def cm(t):  # [H, W, A, k] -> [cls * M, k], class major
            x = t.reshape(h * w, ncls, nrot, t.shape[-1])
            return x.permute(1, 0, 2, 3).reshape(ncls * h * w * nrot,
                                                 t.shape[-1])

        results = []
        for i in range(b):
            logits = cm(preds["cls"][i])
            if use_wnms:
                boxes = delta_decode(anchors_flat, cm(preds["reg"][i]))
                if self.use_direction_classifier:
                    boxes = self._rotate_by_dir(boxes, cm(preds["dir"][i]))
                results.append(box3d_multiclass_nms(
                    boxes, torch.sigmoid(logits),
                    torch.ones(boxes.shape[0], dtype=torch.bool,
                               device=boxes.device),
                    num_classes=ncls, score_thr=score_thr, nms_thr=nms_thr,
                    nms_pre=nms_pre, max_num=max_num,
                    use_rotate_nms=use_rotate_nms, use_wnms=True,
                    wnms_thr_lo=wnms_thr_lo, wnms_thr_hi=wnms_thr_hi))
                continue
            k = min(nms_pre, logits.shape[0])
            sel = [topk_presort(logits[:, c], logits[:, c] > logit_thr, k)
                   for c in range(ncls)]
            idxs = torch.stack([s[0] for s in sel])  # [C, K]
            sels = torch.stack([s[1] for s in sel])
            cand_scores = torch.sigmoid(torch.gather(logits.t(), 1, idxs))
            cand_boxes = delta_decode(anchors_flat[idxs],
                                      cm(preds["reg"][i])[idxs])
            if self.use_direction_classifier:
                cand_boxes = self._rotate_by_dir(cand_boxes,
                                                 cm(preds["dir"][i])[idxs])
            results.append(multiclass_nms_preselected(
                cand_boxes, cand_scores, sels, nms_thr, max_num,
                use_rotate_nms))
        return {key: torch.stack([r[key] for r in results])
                for key in results[0]}
