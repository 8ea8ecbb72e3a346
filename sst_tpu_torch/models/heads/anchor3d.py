"""Anchor-based BEV detection head (counterpart of
``sst_tpu/models/heads/anchor3d.py``; forward and the fast inference path of
``get_bboxes``).

Predictions are [B, H, W, A, K] with A = num_classes * num_rots and the
anchor axis ordered (class range, rotation), as in the JAX package. The
convolutions give [B, A * K, H, W]; they are permuted to channels last
before the reshape. Loss and targets are not ported; ``use_wnms=True``
raises.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sst_tpu_torch.core.anchors import multiclass_aligned_anchors
from sst_tpu_torch.core.box_coders import delta_decode
from sst_tpu_torch.core.boxes import limit_period
from sst_tpu_torch.core.nms import multiclass_nms_preselected, topk_presort


class Anchor3DHead(nn.Module):
    """``feat_channels`` is the width of the input map."""

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
                 dir_offset: float = 0.7854, box_code_size: int = 7):
        super().__init__()
        self.num_classes = num_classes
        self.use_direction_classifier = use_direction_classifier
        self.anchor_ranges = tuple(anchor_ranges)
        self.anchor_sizes = tuple(anchor_sizes)
        self.anchor_rotations = tuple(anchor_rotations)
        self.dir_offset = dir_offset
        self.box_code_size = box_code_size
        a = self.num_anchors
        self.conv_cls = nn.Conv2d(feat_channels, a * num_classes, 1)
        self.conv_reg = nn.Conv2d(feat_channels, a * box_code_size, 1)
        if use_direction_classifier:
            self.conv_dir_cls = nn.Conv2d(feat_channels, a * 2, 1)
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

    def get_bboxes(self, preds, anchors_by_cls, score_thr=0.1, nms_thr=0.25,
                   nms_pre=4096, max_num=500, use_rotate_nms=True,
                   use_wnms=False):
        """Decode + per-class NMS per sample: per-class top-k on the raw
        logits (sigmoid is monotonic), then decode only the ``nms_pre``
        candidates. Returns a dict of [B, max_num] boxes, scores, labels,
        valid."""
        if use_wnms:
            raise NotImplementedError("use_wnms")
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
            k = min(nms_pre, logits.shape[0])
            sel = [topk_presort(logits[:, c], logits[:, c] > logit_thr, k)
                   for c in range(ncls)]
            idxs = torch.stack([s[0] for s in sel])  # [C, K]
            sels = torch.stack([s[1] for s in sel])
            cand_scores = torch.sigmoid(torch.gather(logits.t(), 1, idxs))
            cand_boxes = delta_decode(anchors_flat[idxs],
                                      cm(preds["reg"][i])[idxs])
            if self.use_direction_classifier:
                dir_score = torch.argmax(cm(preds["dir"][i])[idxs], dim=-1)
                rot = limit_period(cand_boxes[..., 6] - self.dir_offset, 0.0,
                                   math.pi)
                yaw = rot + self.dir_offset + math.pi * dir_score.to(
                    rot.dtype)
                cand_boxes = torch.cat([cand_boxes[..., :6], yaw[..., None],
                                        cand_boxes[..., 7:]], dim=-1)
            results.append(multiclass_nms_preselected(
                cand_boxes, cand_scores, sels, nms_thr, max_num,
                use_rotate_nms))
        return {key: torch.stack([r[key] for r in results])
                for key in results[0]}
