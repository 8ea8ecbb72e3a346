"""PointPillars, the hard-voxel pillar detector (counterpart of
``sst_tpu/models/detectors/pointpillars.py``): hard voxelize →
PillarFeatureNet (or HardSimpleVFE) → PointPillarsScatter → SECOND →
SECONDFPN → Anchor3DHead, with ``loss`` and ``predict``.

``num_point_features`` is the width of the raw point rows, which the JAX
module reads from its input. The head's input width is the neck's output
(flax infers it; the config's ``feat_channels`` is not read).
"""

from __future__ import annotations

import torch
from torch import nn

from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.detectors.dynamic_voxelnet import DEFAULT_TEST_CFG
from sst_tpu_torch.models.heads.anchor3d import Anchor3DHead
from sst_tpu_torch.models.middle_encoders import PointPillarsScatter
from sst_tpu_torch.models.second import SECOND, SECONDFPN
from sst_tpu_torch.models.vfe import HardSimpleVFE, PillarFeatureNet
from sst_tpu_torch.ops.voxelize import grid_shape_zyx, hard_voxelize


class PointPillars(nn.Module):
    """``vfe_type``: 'pillar' (PillarFeatureNet) or 'simple' (the mean of
    each pillar's points)."""

    def __init__(self, num_point_features: int = 5,
                 voxel_size: tuple = (0.32, 0.32, 6.0),
                 point_cloud_range: tuple = (-74.88, -74.88, -2.0, 74.88,
                                             74.88, 4.0),
                 max_voxels: int = 32000, max_points_per_voxel: int = 20,
                 vfe_type: str = "pillar", vfe: dict | None = None,
                 backbone: dict | None = None, neck: dict | None = None,
                 head: dict | None = None, test_cfg: dict | None = None,
                 dtype=torch.float32):
        super().__init__()
        if vfe_type not in ("pillar", "simple"):
            raise ValueError(f"vfe_type={vfe_type!r}")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = max_voxels
        self.max_points_per_voxel = max_points_per_voxel
        self.vfe_type = vfe_type
        self.test_cfg = dict(test_cfg or DEFAULT_TEST_CFG)
        _, ny, nx = grid_shape_zyx(self.point_cloud_range, self.voxel_size)
        self.bev_shape = (ny, nx)
        if vfe_type == "pillar":
            self.vfe_mod = PillarFeatureNet(
                num_point_features, voxel_size=self.voxel_size,
                point_cloud_range=self.point_cloud_range, dtype=dtype,
                **(vfe or {}))
            c = self.vfe_mod.out_channels
        else:
            self.vfe_mod = HardSimpleVFE()
            c = num_point_features
        self.backbone_mod = SECOND(c, dtype=dtype, **(backbone or {}))
        self.neck_mod = SECONDFPN(self.backbone_mod.out_channels, dtype=dtype,
                                  **(neck or {}))
        head = dict(head or {})
        head["feat_channels"] = self.neck_mod.out_channels
        self.head_mod = Anchor3DHead(dtype=dtype, **head)

    def extract_feat(self, batch: PointBatch, train: bool = False,
                     diag: dict | None = None):
        """BEV features [B, C, H, W]; ``diag``, if given, receives
        ``num_voxels``."""
        b, p, _ = batch.points.shape
        pts = batch.points.reshape(b * p, -1)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=pts.device).repeat_interleave(p)
        voxels, num_points, coords, vox_valid = hard_voxelize(
            pts, batch_idx, batch.valid.reshape(-1), self.point_cloud_range,
            self.voxel_size, self.max_voxels, self.max_points_per_voxel, b)
        if self.vfe_type == "pillar":
            pillar_feats = self.vfe_mod(voxels, num_points, coords, train)
        else:
            pillar_feats = self.vfe_mod(voxels, num_points)
        canvas = PointPillarsScatter(pillar_feats.shape[-1], self.bev_shape,
                                     b)(pillar_feats, coords, vox_valid)
        feats = self.neck_mod(self.backbone_mod(canvas, train), train)
        if diag is not None:
            diag["num_voxels"] = vox_valid.sum().float()
        return feats

    def forward(self, batch: PointBatch, train: bool = False,
                diag: dict | None = None):
        return self.head_mod(self.extract_feat(batch, train, diag))

    def loss(self, batch: PointBatch, train: bool = True) -> dict:
        """The head's losses (``loss*`` keys), ``num_pos`` and
        ``num_voxels``, as the JAX model returns them."""
        diag: dict = {}
        preds = self(batch, train, diag)
        h, w = preds["cls"].shape[1:3]
        anchors = self.head_mod.grid_anchors((h, w), preds["cls"].device)
        losses = self.head_mod.loss(preds, anchors, batch.gt_boxes,
                                    batch.gt_labels, batch.gt_valid)
        losses.update(diag)
        return losses

    @torch.inference_mode()
    def predict(self, batch: PointBatch):
        """Boxes for a batch: dict of [B, max_num] boxes, scores, labels and
        valid."""
        preds = self(batch)
        h, w = preds["cls"].shape[1:3]
        anchors = self.head_mod.grid_anchors((h, w), preds["cls"].device)
        return self.head_mod.get_bboxes(preds, anchors, **self.test_cfg)
