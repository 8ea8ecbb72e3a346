"""CTRL, offline track-centric auto-labelling: ``TrackletDetector``
predict and loss (counterpart of ``sst_tpu/models/ctrl/tracklet_detector.py``).

A batch element is one tracklet: the multi-frame point cloud around one
track in the track-centric frame, the tracker's per-frame boxes and, for
training, one gt candidate box per frame. ``TrackletSegmentor`` is a pure
feature extractor (a dynamic VFE and a sparse UNet over the whole track
cloud with its time channel); ``TrackletRoIHead`` refines every frame's
tracker box with SIR² over that frame's in-box points. The frame pairing is
the ordinary in-box pool with the composite group id ``tracklet * F +
frame``: a point pairs only with its own frame's roi.

The sparse convs run the hand-written sparse conv kernel on the card (in
training also the weight-gradient kernel and the input gradient); the
segmentor's VFE leaves ``use_sorted_reduce`` at its default, off, as the
JAX module does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from sst_tpu_torch.core import losses as L
from sst_tpu_torch.core.box_coders import delta_encode
from sst_tpu_torch.core.boxes import corners
from sst_tpu_torch.core.iou import boxes_iou_3d
from sst_tpu_torch.models import batch_to
from sst_tpu_torch.models.fsd.roi_head import (
    FullySparseBboxHead,
    canonical_gt,
    decode_rcnn,
    pool_and_refine,
)
from sst_tpu_torch.models.sparse_unet import SimpleSparseUNet, build_unet_plan
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops.segment import INT_SENTINEL, gather_segments
from sst_tpu_torch.ops.sparse_conv import SparseGrid
from sst_tpu_torch.ops.voxelize import dynamic_voxelize, grid_shape_zyx


@dataclass
class TrackletBatch:
    """B tracklets, each of P points over F frames (track-frame
    coordinates). Fields hold numpy arrays or torch tensors; :meth:`to`
    makes tensors on a device.

    points [B, P, C] (the last channel the point's time lag); valid [B, P];
    frame_inds [B, P] int32 in [0, F); trk_boxes [B, F, 7] tracker boxes;
    trk_scores, trk_valid [B, F]; labels [B] track class; gt_boxes [B, F, 7]
    the one-to-one gt candidate per frame; gt_valid [B, F]."""

    points: Any
    valid: Any
    frame_inds: Any
    trk_boxes: Any
    trk_scores: Any
    trk_valid: Any
    labels: Any
    gt_boxes: Any
    gt_valid: Any

    def to(self, device) -> "TrackletBatch":
        return batch_to(self, device)


class TrackletSegmentor(nn.Module):
    """Feature extractor over the whole tracklet cloud: tanh of the
    intensity channels and the time channel over ``ts_normalizer`` (the
    reference's scalar timestamp encoding), dynamic voxelize,
    ``DynamicVFE``, ``SimpleSparseUNet``, then each point's voxel features
    and its offset from the voxel centre. ``in_channels`` is the width of a
    point row (xyz first, the time lag last), which the JAX module reads
    from its input. ``dtype`` is the compute dtype of the VFE and the
    sparse UNet."""

    def __init__(self, in_channels: int,
                 point_cloud_range: tuple = (-3.2, -3.2, -4.0, 3.2, 3.2, 4.0),
                 voxel_size: tuple = (0.1, 0.1, 0.2), max_voxels: int = 8192,
                 unet_level_caps: tuple = (8192, 4096, 2048),
                 unet_strides: tuple = ((2, 2, 2),) * 2,
                 unet_paddings: tuple = ((1, 1, 1),) * 2,
                 ts_normalizer: float = 1.0, vfe: dict | None = None,
                 unet: dict | None = None, dtype=torch.float32):
        super().__init__()
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.max_voxels = max_voxels
        self.unet_level_caps = tuple(unet_level_caps)
        self.unet_strides = tuple(tuple(s) for s in unet_strides)
        self.unet_paddings = tuple(tuple(p) for p in unet_paddings)
        self.ts_normalizer = ts_normalizer
        self.grid = grid_shape_zyx(self.point_cloud_range, self.voxel_size)
        self.vfe_mod = DynamicVFE(
            in_channels, voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range, dtype=dtype,
            **(vfe or dict(feat_channels=(64, 64), mode="max")))
        cfg = dict(unet or {})
        # the JAX module reads the UNet's input width from its input
        cfg.pop("in_channels", None)
        self.unet_mod = SimpleSparseUNet(self.vfe_mod.out_channels,
                                         dtype=dtype, **cfg)
        self.feat_channels = self.unet_mod.out_channels + 3

    def forward(self, points, batch_idx, points_valid, batch_size: int,
                train: bool = False) -> dict:
        """points: [P, C] flat batch. Returns ``seg_points`` (the encoded
        rows), ``seg_feats`` [P, feat_channels] and ``valid``."""
        pts = torch.cat([points[:, :3], torch.tanh(points[:, 3:-1]),
                         points[:, -1:] / self.ts_normalizer], dim=-1)
        vm = dynamic_voxelize(pts, batch_idx, points_valid,
                              self.point_cloud_range, self.voxel_size,
                              self.max_voxels, batch_size)
        voxel_feats = self.vfe_mod(pts, vm, train)
        # the voxel unique sorted the voxels by key: no re-sort
        sg = SparseGrid(
            keys=torch.where(vm.voxel_valid, vm.unique.unique_keys,
                             INT_SENTINEL),
            coords=vm.voxel_coords, valid=vm.voxel_valid, grid=self.grid,
            batch_size=batch_size)
        plan = build_unet_plan(sg, (self.max_voxels,)
                               + self.unet_level_caps[1:],
                               self.unet_strides, self.unet_paddings)
        out = self.unet_mod(voxel_feats, plan, train)
        pt_feats = gather_segments(out["voxel_feats"], vm.point_seg_ids)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                          device=pts.device)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=pts.device)
        centers = (vm.coords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
        local = torch.where(vm.valid[:, None], pts[:, :3] - centers, 0.0)
        return {"seg_points": pts,
                "seg_feats": torch.cat([pt_feats, local], dim=-1),
                "valid": vm.valid}


class TrackletRoIHead(nn.Module):
    """Per-frame RoI refinement over the track: the rois are the tracker
    boxes, each assigned the frame's one-to-one gt candidate.
    ``point_channels`` is the width of a raw point row and
    ``feat_channels_in`` that of the segmentor's point features; flax
    infers both. ``max_paired_points`` caps the points inside any roi; the
    ones past it are dropped and counted (``roi_membership_overflow``)."""

    def __init__(self, point_channels: int, feat_channels_in: int,
                 num_classes: int = 1, extra_wlh: tuple = (0.5, 0.5, 0.5),
                 max_inbox_point: int = 96, max_paired_points: int = 32768,
                 cls_pos_thr: float = 0.8, cls_neg_thr: float = 0.2,
                 loss_cls_weight: float = 1.0, loss_bbox_weight: float = 2.0,
                 corner_loss_weight: float = 1.0,
                 bbox_head: dict | None = None, dtype=torch.float32):
        super().__init__()
        del num_classes  # read by no layer, as in the JAX module
        self.extra_wlh = tuple(extra_wlh)
        self.max_inbox_point = max_inbox_point
        self.max_paired_points = max_paired_points
        self.cls_pos_thr = cls_pos_thr
        self.cls_neg_thr = cls_neg_thr
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.corner_loss_weight = corner_loss_weight
        self.bbox_head_mod = FullySparseBboxHead(
            point_channels, feat_channels_in, dtype=dtype,
            **(bbox_head or {}))

    @staticmethod
    def _flatten(batch: TrackletBatch):
        """Flat points and rois with their group ids: point group
        ``tracklet * F + frame``, roi group its flat index."""
        b, f, _ = batch.trk_boxes.shape
        p = batch.points.shape[1]
        dev = batch.points.device
        pt_group = (torch.arange(b, dtype=torch.int32, device=dev)
                    .repeat_interleave(p) * f
                    + batch.frame_inds.reshape(-1))
        roi_group = torch.arange(b * f, dtype=torch.int32, device=dev)
        return (batch.points.reshape(b * p, -1), pt_group,
                batch.trk_boxes.reshape(b * f, 7), roi_group)

    def _refine(self, batch, pts_feats, seg_valid, train: bool):
        """(rois, roi_valid, cls_score, bbox_pred, nonempty,
        membership_overflow) over the flat [B * F] rois."""
        pts, pt_group, rois, roi_group = self._flatten(batch)
        roi_valid = batch.trk_valid.reshape(-1)
        return (rois, roi_valid) + pool_and_refine(
            self, pts, pts_feats, batch.valid.reshape(-1) & seg_valid,
            pt_group, rois, roi_valid, roi_group, train)

    def loss(self, batch: TrackletBatch, pts_feats, seg_valid,
             train: bool = True) -> dict:
        """``loss_trk_cls`` (BCE to the IoU's soft label over the valid
        non-empty rois), ``loss_trk_bbox`` (L1 of the canonical residuals)
        and ``loss_trk_corner`` over the non-empty rois with a valid gt,
        ``mean_roi_iou`` over those, and ``roi_membership_overflow``."""
        b, f, _ = batch.trk_boxes.shape
        rois, roi_valid, cls_score, bbox_pred, nonempty, mem_overflow = \
            self._refine(batch, pts_feats, seg_valid, train)
        gts = batch.gt_boxes.reshape(b * f, 7)
        gv = batch.gt_valid.reshape(-1) & roi_valid
        # padded slots take a unit box: a zero-size box makes delta_encode's
        # log NaN, and 0 * NaN poisons the masked loss
        unit = torch.tensor([0, 0, 0, 1, 1, 1, 0], dtype=rois.dtype,
                            device=rois.device)
        rois = torch.where(roi_valid[:, None], rois, unit)
        gts = torch.where(gv[:, None], gts, rois)
        iou = torch.where(gv, boxes_iou_3d(rois, gts, aligned=True), 0.0)
        soft = torch.clamp((iou - self.cls_neg_thr)
                           / (self.cls_pos_thr - self.cls_neg_thr), 0.0, 1.0)
        lw = (roi_valid & nonempty).float()
        loss_cls = L.binary_cross_entropy_loss(
            cls_score, soft, weight=lw,
            avg_factor=torch.clamp(lw.sum(), min=1.0)) * self.loss_cls_weight

        ct = canonical_gt(rois, gts)
        anchors = torch.cat([torch.zeros_like(rois[:, :3]), rois[:, 3:6],
                             torch.zeros_like(rois[:, 6:7])], dim=-1)
        targets = delta_encode(anchors, ct)
        rw = (gv & nonempty).float()
        n_reg = torch.clamp(rw.sum(), min=1.0)
        loss_bbox = L.l1_loss(bbox_pred, targets, weight=rw,
                              avg_factor=n_reg) * self.loss_bbox_weight

        pred_corners = corners(decode_rcnn(rois, bbox_pred))
        flipped = torch.cat([gts[:, :6], gts[:, 6:7] + math.pi], dim=-1)
        cd = torch.minimum(
            torch.linalg.vector_norm(pred_corners - corners(gts), dim=-1),
            torch.linalg.vector_norm(pred_corners - corners(flipped), dim=-1))
        huber = torch.where(cd < 1.0, 0.5 * cd**2, cd - 0.5).mean(-1)
        loss_corner = (huber * rw).sum() / n_reg * self.corner_loss_weight
        return {
            "loss_trk_cls": loss_cls,
            "loss_trk_bbox": loss_bbox,
            "loss_trk_corner": loss_corner,
            "mean_roi_iou": (iou * rw).sum() / n_reg,
            "roi_membership_overflow": mem_overflow.float(),
        }

    def predict(self, batch: TrackletBatch, pts_feats, seg_valid) -> dict:
        """Refined per-frame boxes and scores of every tracklet: [B, F, 7]
        boxes, [B, F] scores, valid and labels. An empty roi keeps its
        tracker box and scores 0."""
        b, f, _ = batch.trk_boxes.shape
        rois, roi_valid, cls_score, bbox_pred, nonempty, _ = self._refine(
            batch, pts_feats, seg_valid, False)
        decoded = torch.where(nonempty[:, None],
                              decode_rcnn(rois, bbox_pred), rois)
        return {
            "boxes": decoded.reshape(b, f, 7),
            "scores": (torch.sigmoid(cls_score) * nonempty).reshape(b, f),
            "valid": (roi_valid & nonempty).reshape(b, f),
            "labels": batch.labels[:, None].expand(b, f),
        }


class TrackletDetector(nn.Module):
    """Segmentor, then the track RoI head. ``num_point_features`` is the
    width of a point row: 6 for the tracklet dataset's x, y, z, intensity,
    elongation and time lag. ``dtype`` is the compute dtype of both parts,
    float32 or bfloat16 (the sparse UNet on the conv kernels' bf16
    routes), as the JAX module's."""

    def __init__(self, num_point_features: int = 6,
                 segmentor: dict | None = None, roi_head: dict | None = None,
                 dtype=torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"dtype={dtype}: float32 and bfloat16 are ported")
        self.segmentor_mod = TrackletSegmentor(num_point_features,
                                               dtype=dtype,
                                               **(segmentor or {}))
        self.roi_mod = TrackletRoIHead(num_point_features,
                                       self.segmentor_mod.feat_channels,
                                       dtype=dtype, **(roi_head or {}))

    def _seg(self, batch: TrackletBatch, train: bool) -> dict:
        b, p, _ = batch.points.shape
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=batch.points.device)
        return self.segmentor_mod(batch.points.reshape(b * p, -1),
                                  batch_idx.repeat_interleave(p),
                                  batch.valid.reshape(-1), b, train)

    def loss(self, batch: TrackletBatch, train: bool = True) -> dict:
        """The training losses (``loss*`` keys, summed by
        ``train/step.py``), ``mean_roi_iou`` and the pool's overflow."""
        seg = self._seg(batch, train)
        return self.roi_mod.loss(batch, seg["seg_feats"], seg["valid"], train)

    @torch.inference_mode()
    def predict(self, batch: TrackletBatch) -> dict:
        seg = self._seg(batch, False)
        return self.roi_mod.predict(batch, seg["seg_feats"], seg["valid"])

    def forward(self, batch: TrackletBatch, train: bool = False) -> dict:
        return self.loss(batch, train)
