"""FSD — the two-stage fully-sparse detector, predict and loss
(counterpart of ``sst_tpu/models/fsd/two_stage.py``).

SingleStageFSD as the RPN, then GroupCorrectionHead refinement. Proposals
are the top cluster boxes of each sample by score (no NMS), at most
``rois_per_sample``; the RoI point set is the pre-voxelized cloud with the
SIR point features written back onto its rows.
"""

from __future__ import annotations

import torch
from torch import nn

from sst_tpu_torch.core.box_coders import base_point_decode
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.roi_head import GroupCorrectionHead
from sst_tpu_torch.models.fsd.single_stage import SingleStageFSD
from sst_tpu_torch.ops.ccl import topk_compact
from sst_tpu_torch.ops.segment import gather_rows


def scatter_last_wins(rows: torch.Tensor, index: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """[rows, C]: row r holds ``values[j]`` for the largest j with
    ``index[j] == r``, zeros where no j names r; indices outside [0, rows)
    are dropped. The winner among duplicate indices is explicit (the
    highest position, a ``scatter_reduce`` amax of the positions), where a
    scatter-set with duplicates promises no order on the card. The rows are
    read by ``gather_rows``: the rows no j names (most of them) do not all
    send their zero gradients to ``values[0]``."""
    pos = torch.arange(index.shape[0], device=index.device)
    inside = (index >= 0) & (index < rows)
    winner = torch.full((rows + 1,), -1, dtype=pos.dtype,
                        device=index.device)
    winner.scatter_reduce_(0, torch.where(inside, index.long(), rows), pos,
                           "amax")
    return gather_rows(values, winner[:rows])


def top_proposals(head, outs: dict, centers, valid, batch,
                  batch_size: int, k: int):
    """The single stage's boxes as rois: each task's boxes decoded at the
    ``centers`` (``head.bbox_coder_scale``), scored by their best class and
    labelled with its class id, then per sample the ``k`` best valid ones
    over all tasks (``topk_compact``, no NMS). Returns flat [B * k] (boxes,
    scores (0 on empty slots), labels, valid, batch)."""
    boxes_l, scores_l, labels_l = [], [], []
    for t in range(len(head.tasks)):
        scores = torch.sigmoid(outs["cls_logits"][t])
        boxes_l.append(base_point_decode(centers, outs["reg_preds"][t],
                                         head.bbox_coder_scale))
        scores_l.append(scores.amax(dim=-1))
        local = scores.argmax(dim=-1)
        lbl = torch.zeros_like(local, dtype=torch.int32)
        for li, ci in enumerate(head._task_class_ids(t)):
            lbl = torch.where(local == li, ci, lbl)
        labels_l.append(lbl)
    n_tasks = len(head.tasks)
    boxes = torch.cat(boxes_l)
    scores = torch.cat(scores_l)
    labels = torch.cat(labels_l)
    valid = torch.cat([valid] * n_tasks)
    batch = torch.cat([batch] * n_tasks)

    out = [[], [], [], [], []]
    for i in range(batch_size):
        idx, sv = topk_compact(scores, valid & (batch == i), k)
        for lst, v in zip(out, (boxes[idx], torch.where(sv, scores[idx], 0.0),
                                labels[idx], sv,
                                torch.full((k,), i, dtype=torch.int32,
                                           device=idx.device))):
            lst.append(v)
    return tuple(torch.cat(lst) for lst in out)


class FSD(nn.Module):
    """``num_point_features`` is the width of the raw point rows (xyz
    first), passed to the single stage's segmentor and SIR and to the RoI
    head, whose widths flax infers."""

    def __init__(self, num_point_features: int = 5,
                 single_stage: dict | None = None,
                 roi_head: dict | None = None, rois_per_sample: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.rpn = SingleStageFSD(num_point_features=num_point_features,
                                  dtype=dtype, **(single_stage or {}))
        self.rois_per_sample = rois_per_sample
        seg = self.rpn.segmentor_mod
        self.roi = GroupCorrectionHead(
            num_point_features,
            self.rpn.backbone_mod.out_channels + seg.feat_channels,
            num_classes=self.rpn.num_classes, dtype=dtype, **(roi_head or {}))

    @property
    def point_cloud_range(self):
        return self.rpn.point_cloud_range

    @property
    def test_cfg(self):
        return self.rpn.test_cfg

    def _proposals(self, pipe: dict):
        """Per-sample top-k decoded cluster boxes across tasks → flat rois
        (boxes, scores, labels, valid, batch)."""
        ex = pipe["ex"]
        return top_proposals(self.rpn.head_mod, pipe["outs"],
                             ex["cluster_xyz"], ex["cluster_valid"],
                             ex["cluster_batch"], pipe["batch_size"],
                             self.rois_per_sample)

    def _roi_points(self, pipe: dict):
        """RoI point set: the pre-voxelized points, their features the SIR
        point features (zeros on rows no class selected) beside the
        segmentor's. A row that two classes selected takes the features of
        the later class's stream (the highest stream position)."""
        data, ex = pipe["data"], pipe["ex"]
        pv = data["seg_points"].shape[0]
        idx = torch.where(ex["pt_valid"], ex["pt_idx"], pv)
        sir_feats = scatter_last_wins(pv, idx, ex["pt_feats"])
        feats = torch.cat([sir_feats, data["seg_feats"]], dim=-1)
        return data["seg_points"], feats, data["valid"], data["batch_idx"]

    def loss(self, batch: PointBatch, train: bool = True,
             thr_extra: float = 0.0, pretrain: bool = False,
             generator: torch.Generator | None = None) -> dict:
        """The training losses of a labelled batch (``loss*`` keys, summed
        by ``train/step.py``) and the counters JAX's returns.
        ``pretrain``: the segmentor's losses alone (the single stage's
        ``loss``). Otherwise the single stage's losses, then the RoI head's
        on the detached proposals. ``generator``: the source of the SST
        segmentor's voxel shuffle (JAX's ``shuffle`` rng) and then of the
        RoI sampler's uniforms (its ``sampler`` rng)."""
        if pretrain:
            return self.rpn.loss(batch, train, thr_extra, pretrain=True,
                                 generator=generator)
        pipe = self.rpn.run_pipeline(batch, train, thr_extra,
                                     generator=generator)
        losses = self.rpn.losses_from_pipeline(batch, pipe)
        rois, _, rlabels, rvalid, rbatch = self._proposals(pipe)
        pts, feats, pvalid, pbatch = self._roi_points(pipe)
        losses.update(self.roi.loss(
            pts, feats, pvalid, pbatch, rois.detach(), rlabels, rvalid,
            rbatch, batch.gt_boxes, batch.gt_labels, batch.gt_valid, train,
            generator=generator))
        return losses

    @torch.inference_mode()
    def predict_seg(self, batch: PointBatch, score_thr: float = 0.5) -> dict:
        """The single stage's ``predict_seg`` (``tools/test.py --eval
        seg``)."""
        return self.rpn.predict_seg(batch, score_thr)

    @torch.inference_mode()
    def predict(self, batch: PointBatch, skip_rcnn: bool = False) -> dict:
        """Boxes for a batch. ``skip_rcnn``: the single stage's boxes
        ([B, max_num]); else the refined proposals ([B, min(max_num,
        B * rois_per_sample)])."""
        pipe = self.rpn.run_pipeline(batch, detach_seg=False)
        if skip_rcnn:
            ex = pipe["ex"]
            return self.rpn.head_mod.get_bboxes(
                pipe["outs"], ex["cluster_xyz"], ex["cluster_batch"],
                ex["cluster_valid"], pipe["batch_size"], **self.test_cfg)
        rois, rscores, rlabels, rvalid, rbatch = self._proposals(pipe)
        pts, feats, pvalid, pbatch = self._roi_points(pipe)
        return self.roi.predict(
            pts, feats, pvalid, pbatch, rois, rscores, rlabels, rvalid,
            rbatch, pipe["batch_size"],
            **{k: v for k, v in self.test_cfg.items()
               if k in ("nms_thr", "score_thr", "max_num", "use_rotate_nms")})

    def forward(self, batch: PointBatch, train: bool = False):
        pipe = self.rpn.run_pipeline(batch, train)
        rois, _, _, rvalid, rbatch = self._proposals(pipe)
        pts, feats, pvalid, pbatch = self._roi_points(pipe)
        return self.roi.pool_and_forward(pts, feats, pvalid, pbatch,
                                         rois[:, :7], rvalid, rbatch, train)
