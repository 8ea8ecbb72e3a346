"""SparseClusterHeadV2 — FSD's single-stage head over cluster features
(counterpart of ``sst_tpu/models/fsd/sparse_cluster_head.py``: forward,
``loss`` and ``get_bboxes``).

Per task (class group): shared MLP → separate MLPs for score / centre / dim /
rot. Boxes decode with the base-point coder w.r.t. each cluster's centre; a
cluster whose centre lies in a gt box of the task is that box's positive.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.core import losses as L
from sst_tpu_torch.core.box_coders import base_point_decode, base_point_encode
from sst_tpu_torch.core.boxes import points_in_boxes
from sst_tpu_torch.core.nms import box3d_multiclass_nms
from sst_tpu_torch.models.layers import MLP


class FSDSeparateHead(nn.Module):
    """One MLP per attribute, each a child named after its attribute."""

    def __init__(self, in_channels: int, attrs: tuple, norm: str = "ln",
                 act: str = "relu", dtype=torch.float32):
        super().__init__()
        self.names = tuple(a[0] for a in attrs)
        for name, out_dim, num_layers, hidden in attrs:
            self.add_module(name, MLP(in_channels,
                                      (hidden,) * num_layers + (out_dim,),
                                      act=act, norm=norm, is_head=True,
                                      dtype=dtype))

    def forward(self, x, valid, train: bool = False):
        return {name: getattr(self, name)(x, valid, train)
                for name in self.names}


class SparseClusterHeadV2(nn.Module):
    def __init__(self, num_classes: int = 3,
                 tasks: tuple = (("Car",), ("Pedestrian",), ("Cyclist",)),
                 class_names: tuple = ("Car", "Pedestrian", "Cyclist"),
                 in_channel: int = 768,
                 shared_mlp_dims: Sequence[int] = (1024, 1024),
                 num_cls_layer: int = 2, cls_hidden_dim: int = 128,
                 common_attrs: tuple = (("center", 3, 2, 128),
                                        ("dim", 3, 2, 128),
                                        ("rot", 2, 2, 128)),
                 bbox_coder_scale: float = 1.0,
                 enlarge_width: float | None = None,
                 loss_cls_weight: float = 2.0,
                 loss_center_weight: float = 0.5,
                 loss_size_weight: float = 0.5,
                 loss_rot_weight: float = 0.2, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, norm: str = "ln",
                 act: str = "relu", code_size: int = 8,
                 with_vel: bool = False, loss_vel_weight: float = 0.2,
                 with_iou: bool = False, loss_iou_weight: float = 1.0,
                 iou_score_weight: float = 0.5, dtype=torch.float32):
        """``code_size``, ``loss_vel_weight``, ``loss_iou_weight`` and
        ``iou_score_weight`` belong to the velocity and IoU branches, which
        are not ported (they raise)."""
        super().__init__()
        if with_vel or with_iou:
            raise NotImplementedError("with_vel / with_iou")
        if enlarge_width is not None:
            raise NotImplementedError("enlarge_width")
        if code_size != 8:
            raise NotImplementedError(f"code_size={code_size}")
        self.loss_weights = dict(cls=loss_cls_weight,
                                 center=loss_center_weight,
                                 size=loss_size_weight, rot=loss_rot_weight)
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.num_classes = num_classes
        self.tasks = tuple(tuple(t) for t in tasks)
        self.class_names = tuple(class_names)
        self.bbox_coder_scale = bbox_coder_scale
        c = in_channel
        self.shared_mlp = None
        if shared_mlp_dims:
            self.shared_mlp = MLP(in_channel, tuple(shared_mlp_dims), act=act,
                                  norm=norm, dtype=dtype)
            c = self.shared_mlp.out_channels
        for t, names in enumerate(self.tasks):
            attrs = tuple(common_attrs) + (
                ("score", len(names), num_cls_layer, cls_hidden_dim),)
            self.add_module(f"task_{t}",
                            FSDSeparateHead(c, attrs, norm, act, dtype))

    def _task_class_ids(self, task_id):
        return [self.class_names.index(n) for n in self.tasks[task_id]]

    def forward(self, cluster_feats, valid, train: bool = False):
        x = cluster_feats
        if self.shared_mlp is not None:
            x = self.shared_mlp(x, valid, train)
        cls_logits, reg_preds = [], []
        for t in range(len(self.tasks)):
            ret = getattr(self, f"task_{t}")(x, valid, train)
            cls_logits.append(ret["score"])
            reg_preds.append(torch.cat([ret["center"], ret["dim"], ret["rot"]],
                                       dim=-1))
        return {"cls_logits": cls_logits, "reg_preds": reg_preds}

    def loss(self, outs, cluster_xyz, cluster_batch, cluster_valid,
             gt_boxes, gt_labels, gt_valid):
        """gt_*: [B, G, ...]; cluster_* are flat [C] with a batch index.
        Per task: ``loss_cls``, ``loss_center``, ``loss_size`` and
        ``loss_rot`` with a ``.task{t}`` suffix."""
        losses = {}
        for t in range(len(self.tasks)):
            losses.update(self._loss_single_task(
                t, outs["cls_logits"][t], outs["reg_preds"][t], cluster_xyz,
                cluster_batch, cluster_valid, gt_boxes, gt_labels, gt_valid))
        return losses

    def _loss_single_task(self, task_id, cls_logits, reg_preds, cluster_xyz,
                          cluster_batch, cluster_valid, gt_boxes, gt_labels,
                          gt_valid):
        ids = self._task_class_ids(task_id)
        # gt labels as task-local ids; boxes of other classes are dropped
        task_gt_valid = gt_valid & torch.isin(
            gt_labels, torch.tensor(ids, dtype=gt_labels.dtype,
                                    device=gt_labels.device))
        local = torch.zeros_like(gt_labels)
        for li, ci in enumerate(ids):
            local = torch.where(gt_labels == ci, li, local)

        # a cluster's box: the first of its sample's task boxes that holds
        # its centre
        b, g = gt_boxes.shape[:2]
        assigned = torch.full(cluster_xyz.shape[:1], -1, dtype=torch.int64,
                              device=cluster_xyz.device)
        for i in range(b):
            inb = (points_in_boxes(cluster_xyz, gt_boxes[i])
                   & task_gt_valid[i][None, :]
                   & (cluster_batch == i)[:, None])
            first = torch.argmax(inb.to(torch.uint8), dim=1)
            assigned = torch.where(inb.any(dim=1) & cluster_valid,
                                   i * g + first, assigned)

        is_pos = assigned >= 0
        safe = torch.clamp(assigned, min=0)
        labels = torch.where(is_pos, local.reshape(-1)[safe], len(ids))
        matched = gt_boxes.reshape(b * g, -1)[safe]

        num_total = torch.clamp(cluster_valid.sum().float(), min=1.0)
        loss_cls = L.sigmoid_focal_loss(
            cls_logits, labels.to(torch.int32), weight=cluster_valid.float(),
            gamma=self.focal_gamma, alpha=self.focal_alpha,
            avg_factor=num_total) * self.loss_weights["cls"]
        targets = base_point_encode(cluster_xyz, matched[:, :7],
                                    self.bbox_coder_scale)
        pw = is_pos.float()
        num_pos = torch.clamp(pw.sum(), min=1.0)
        out = {f"loss_cls.task{task_id}": loss_cls}
        for name, sl in (("center", slice(0, 3)), ("size", slice(3, 6)),
                         ("rot", slice(6, 8))):
            out[f"loss_{name}.task{task_id}"] = L.l1_loss(
                reg_preds[:, sl], targets[:, sl], pw, num_pos) \
                * self.loss_weights[name]
        return out

    def get_bboxes(self, outs, cluster_xyz, cluster_batch, cluster_valid,
                   batch_size: int, score_thr=0.1, nms_thr=0.25, max_num=500,
                   nms_pre=1024, use_rotate_nms=True):
        """Per-sample decoded + NMS'd boxes across tasks, padded
        [B, max_num]."""
        all_boxes, all_scores = [], []
        for t in range(len(self.tasks)):
            scores = torch.sigmoid(outs["cls_logits"][t])
            all_boxes.append(base_point_decode(
                cluster_xyz, outs["reg_preds"][t], self.bbox_coder_scale))
            full = scores.new_zeros((scores.shape[0], self.num_classes))
            for li, ci in enumerate(self._task_class_ids(t)):
                full[:, ci] = scores[:, li]
            all_scores.append(full)
        n_tasks = len(self.tasks)
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores)
        valid = torch.cat([cluster_valid] * n_tasks)
        batch = torch.cat([cluster_batch] * n_tasks)
        results = [
            box3d_multiclass_nms(
                boxes, scores, valid & (batch == i),
                num_classes=self.num_classes, score_thr=score_thr,
                nms_thr=nms_thr, nms_pre=nms_pre, max_num=max_num,
                use_rotate_nms=use_rotate_nms)
            for i in range(batch_size)
        ]
        return {k: torch.stack([r[k] for r in results]) for k in results[0]}
