"""DynamicVoxelNet, the SST detector (counterpart of
``sst_tpu/models/detectors/dynamic_voxelnet.py``; inference and ``loss``).

Dynamic voxelize -> DynamicVFE -> SST input layer (window plans) -> SSTv2
-> SECONDFPN -> Anchor3DHead (``head_type="anchor"``) or CenterHead
(``head_type="center"``). The static capacities (voxels, windows per
bucket) come from the config; ``extract_feat(diag=...)`` reports what they
dropped. In training the voxel rows are shuffled before the window plan
with a permutation drawn from the caller's generator (JAX's ``shuffle``
rng).

``dtype`` is the compute dtype of every module (the VFE, the backbone, the
neck and the head), as in JAX: float32 parameters, products in ``dtype``
(``models/layers.py``). At bfloat16 the head's predictions, and the scores
of ``predict``, are bfloat16.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.ref.models import PointBatch
from portbench.ref.models.heads.anchor3d import Anchor3DHead
from portbench.ref.models.second import SECONDFPN
from portbench.ref.models.sst import SSTv2
from portbench.ref.models.sst_input import sst_input_layer
from portbench.ref.models.vfe import DynamicVFE
from portbench.ref.ops.voxelize import dynamic_voxelize, grid_shape_zyx
from portbench.ref.ops.window import BucketSpec


def voxel_permutation(n: int, generator: torch.Generator) -> torch.Tensor:
    """The training-time voxel shuffle: a random permutation of the ``n``
    voxel rows, drawn on the generator's device."""
    return torch.randperm(n, generator=generator, device=generator.device)


DEFAULT_TEST_CFG = dict(score_thr=0.1, nms_thr=0.25, nms_pre=1024,
                        max_num=500, use_rotate_nms=True)


class DynamicVoxelNet(nn.Module):
    """``num_point_features`` is the width of the raw point rows (xyz
    first)."""

    def __init__(self, num_point_features: int = 3,
                 voxel_size: tuple = (0.32, 0.32, 6.0),
                 point_cloud_range: tuple = (-74.88, -74.88, -2.0, 74.88,
                                             74.88, 4.0),
                 max_voxels: int = 32768, max_total_windows: int = 8192,
                 window_shape: tuple = (12, 12),
                 buckets: tuple = (BucketSpec(30, 0, 30, 2048),
                                   BucketSpec(60, 30, 60, 512),
                                   BucketSpec(100, 60, 100000, 256)),
                 vfe: dict | None = None, backbone: dict | None = None,
                 neck: dict | None = None, head: dict | None = None,
                 head_type: str = "anchor", backbone_type: str = "sstv2",
                 test_cfg: dict | None = None, dtype=torch.float32):
        super().__init__()
        if head_type != "anchor":
            raise NotImplementedError(f"head_type={head_type!r}")
        if backbone_type != "sstv2":
            raise NotImplementedError(f"backbone_type={backbone_type!r}")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = max_voxels
        self.max_total_windows = max_total_windows
        self.window_shape = tuple(window_shape)
        self.buckets = tuple(buckets)
        self.test_cfg = dict(test_cfg or DEFAULT_TEST_CFG)
        _, ny, nx = grid_shape_zyx(self.point_cloud_range, self.voxel_size)
        self.bev_shape = (ny, nx)

        self.vfe_mod = DynamicVFE(num_point_features,
                                  voxel_size=self.voxel_size,
                                  point_cloud_range=self.point_cloud_range,
                                  dtype=dtype, **(vfe or {}))
        bb = dict(output_shape=self.bev_shape)
        bb.update(backbone or {})
        self.backbone_mod = SSTv2(dtype=dtype, **bb)
        self.neck_mod = SECONDFPN(self.backbone_mod.out_channels,
                                  dtype=dtype, **(neck or {}))
        self.head_type = head_type
        self.head_mod = Anchor3DHead(dtype=dtype, **(head or {}))

    def extract_feat(self, batch: PointBatch, train: bool = False,
                     diag: dict | None = None,
                     generator: torch.Generator | None = None):
        """BEV features [B, C, H, W]. ``diag``, if given, receives the
        capacity counters: ``num_voxels``, ``num_voxel_overflow_points``
        (points whose voxel fell past ``max_voxels``),
        ``num_window_seat_trimmed_voxels`` (SST's own drop rule, expected
        on dense frames) and ``num_window_dropped_voxels`` (window-cap
        overflow; the training buckets may drop there by design).
        ``generator``: in train mode, the source of the voxel shuffle
        (:func:`voxel_permutation`); None shuffles nothing, as JAX without
        a ``shuffle`` rng."""
        b, p, _ = batch.points.shape
        pts = batch.points.reshape(b * p, -1)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=pts.device).repeat_interleave(p)
        vm = dynamic_voxelize(pts, batch_idx, batch.valid.reshape(-1),
                              self.point_cloud_range, self.voxel_size,
                              self.max_voxels, b)
        voxel_feats = self.vfe_mod(pts, vm, train)
        perm = None
        if train and generator is not None:
            perm = voxel_permutation(vm.voxel_coords.shape[0], generator)
        ny, nx = self.bev_shape
        plan = sst_input_layer(
            vm.voxel_coords, vm.voxel_valid, sparse_shape=(nx, ny, 1),
            window_shape=self.window_shape, buckets=self.buckets,
            d_model=self.backbone_mod.d_model[0],
            max_total_windows=self.max_total_windows, perm=perm)
        bev, _ = self.backbone_mod(voxel_feats, vm.voxel_coords, plan, b,
                                   train)
        feats = self.neck_mod(bev, train)
        if diag is not None:
            diag["num_voxels"] = vm.voxel_valid.sum().float()
            diag["num_voxel_overflow_points"] = (
                vm.valid & (vm.unique.seg_ids >= self.max_voxels)
            ).sum().float()
            total_win_lost = (vm.voxel_valid & ~plan.valid).sum().float()
            seat = plan.num_seat_trimmed.float()
            diag["num_window_seat_trimmed_voxels"] = seat
            diag["num_window_dropped_voxels"] = total_win_lost - seat
        return feats

    def forward(self, batch: PointBatch, train: bool = False,
                diag: dict | None = None,
                generator: torch.Generator | None = None):
        feats = self.extract_feat(batch, train, diag, generator)
        return self.head_mod(feats)

    def loss(self, batch: PointBatch, train: bool = True,
             generator: torch.Generator | None = None) -> dict:
        """The head's losses (``loss*`` keys, summed by ``train/step.py``),
        ``num_pos`` and the capacity counters of :meth:`extract_feat`, as
        the JAX model returns them. ``generator`` drives the voxel
        shuffle."""
        diag: dict = {}
        preds = self(batch, train, diag, generator)
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
