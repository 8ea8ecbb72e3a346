"""SparseClusterHeadV2 — FSD's single-stage head over cluster features
(counterpart of ``sst_tpu/models/fsd/sparse_cluster_head.py``; forward and
``get_bboxes``).

Per task (class group): shared MLP → separate MLPs for score / centre / dim /
rot. Boxes decode with the base-point coder w.r.t. each cluster's centre.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.core.box_coders import base_point_decode
from sst_tpu_torch.core.nms import box3d_multiclass_nms
from sst_tpu_torch.models.layers import MLP


class FSDSeparateHead(nn.Module):
    """One MLP per attribute, each a child named after its attribute."""

    def __init__(self, in_channels: int, attrs: tuple, norm: str = "ln",
                 act: str = "relu"):
        super().__init__()
        self.names = tuple(a[0] for a in attrs)
        for name, out_dim, num_layers, hidden in attrs:
            self.add_module(name, MLP(in_channels,
                                      (hidden,) * num_layers + (out_dim,),
                                      act=act, norm=norm, is_head=True))

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
                 bbox_coder_scale: float = 1.0, norm: str = "ln",
                 act: str = "relu", with_vel: bool = False,
                 with_iou: bool = False, **_loss_cfg):
        super().__init__()
        if with_vel or with_iou:
            raise NotImplementedError("with_vel / with_iou")
        self.num_classes = num_classes
        self.tasks = tuple(tuple(t) for t in tasks)
        self.class_names = tuple(class_names)
        self.bbox_coder_scale = bbox_coder_scale
        c = in_channel
        self.shared_mlp = None
        if shared_mlp_dims:
            self.shared_mlp = MLP(in_channel, tuple(shared_mlp_dims), act=act,
                                  norm=norm)
            c = self.shared_mlp.out_channels
        for t, names in enumerate(self.tasks):
            attrs = tuple(common_attrs) + (
                ("score", len(names), num_cls_layer, cls_hidden_dim),)
            self.add_module(f"task_{t}", FSDSeparateHead(c, attrs, norm, act))

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
