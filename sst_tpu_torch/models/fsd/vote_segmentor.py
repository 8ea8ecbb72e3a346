"""VoteSegmentor — FSD stage-0 point segmentation + centre voting
(counterpart of ``sst_tpu/models/fsd/vote_segmentor.py``), with the sparse,
the dense-BEV and the SST backbones.

Flow: tanh on the channels past xyz → dynamic voxelize → DynamicVFE →
backbone → per-point gather + local-xyz decoration → MLP → (seg logits
[P, C], vote preds [P, 3C]). The backbone is either SimpleSparseUNet over
the voxel grid's rulebooks (``backbone="sparse"``) or BEVScatter →
DenseBEVUNet → DenseVoxelDecode (``backbone="dense_bev"``) or the FSD
SST-encoder recipe (``backbone="sst"``: full-height pillars, the SST input
layer's window plan and ``SSTv2(to_bev=False)``, its per-voxel outputs
zeroed where the plan dropped the voxel; in training the voxel rows are
shuffled by a permutation drawn from the caller's generator), each with
train mode and the head's losses. ``voxel_downsampling_size`` (the 3-sweep
recipe) first averages each sample's points over voxels of that size.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from sst_tpu_torch.core import losses as L
from sst_tpu_torch.core.boxes import gravity_center, points_in_boxes
from sst_tpu_torch.models.dense_bev import (
    BEVScatter,
    DenseBEVUNet,
    DenseVoxelDecode,
)
from sst_tpu_torch.models.detectors import dynamic_voxelnet
from sst_tpu_torch.models.layers import MLP, Dense
from sst_tpu_torch.models.sparse_unet import SimpleSparseUNet, build_unet_plan
from sst_tpu_torch.models.sst import SSTv2
from sst_tpu_torch.models.sst_input import sst_input_layer
from sst_tpu_torch.models.vfe import DynamicVFE
from sst_tpu_torch.ops.segment import (
    INT_SENTINEL,
    gather_segments,
    segment_reduce,
    unique_segments,
)
from sst_tpu_torch.ops.sparse_conv import SparseGrid
from sst_tpu_torch.ops.voxelize import (
    dynamic_voxelize,
    f32_reciprocal,
    grid_shape_zyx,
)
from sst_tpu_torch.ops.window import BucketSpec

# the SST encoder's window plan where the config gives none (JAX's)
SST_DEFAULTS = dict(window_shape=(12, 12),
                    buckets=((30, 0, 30, 1536), (60, 30, 60, 1280),
                             (100, 60, 100000, 768)),
                    max_total_windows=2048, shuffle_voxels=True)


def encode_vote(delta):
    """sign(d) * sqrt(|d|)."""
    return torch.sign(delta) * torch.sqrt(torch.abs(delta))


def decode_vote(pred):
    return pred * torch.abs(pred)


def seg_targets(points_xyz, points_valid, gt_boxes, gt_labels, gt_valid,
                num_classes: int):
    """Per-point class label (background = num_classes), vote target
    ``encode_vote(gravity centre - point)`` and vote mask, for one sample:
    the first valid gt box holding the point decides."""
    inb = points_in_boxes(points_xyz, gt_boxes) & gt_valid[None, :]
    any_in = inb.any(dim=1)
    first = torch.argmax(inb.to(torch.uint8), dim=1)
    lbl = torch.where(any_in, gt_labels[first], num_classes)
    delta = torch.where(any_in[:, None],
                        gravity_center(gt_boxes)[first] - points_xyz, 0.0)
    lbl = torch.where(points_valid, lbl, num_classes).to(torch.int32)
    return lbl, encode_vote(delta), any_in & points_valid


class VoteSegHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 3,
                 hidden_dims: Sequence[int] = (128, 128),
                 init_bias: float = -2.0, gamma: float = 3.0,
                 alpha: float = 0.8, loss_seg_weight: float = 1.0,
                 loss_vote_weight: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.init_bias = init_bias
        self.gamma = gamma
        self.alpha = alpha
        self.loss_seg_weight = loss_seg_weight
        self.loss_vote_weight = loss_vote_weight
        self.pre_seg = MLP(in_channels, tuple(hidden_dims), norm="bn",
                           dtype=dtype)
        c = self.pre_seg.out_channels
        self.conv_seg = Dense(c, num_classes, dtype=dtype)
        self.voting = Dense(c, num_classes * 3, dtype=dtype)

    def forward(self, feats, valid, train: bool = False):
        x = self.pre_seg(feats, valid, train)
        return self.conv_seg(x), self.voting(x)

    def losses(self, logits, votes, labels, vote_targets, vote_mask, valid):
        """Focal segmentation loss over valid points and L1 vote loss over
        the target class's 3 offsets of foreground points."""
        num_valid = torch.clamp(valid.sum().float(), min=1.0)
        loss_seg = L.sigmoid_focal_loss(
            logits, torch.where(valid, labels, self.num_classes),
            weight=valid.float(), gamma=self.gamma, alpha=self.alpha,
            avg_factor=num_valid) * self.loss_seg_weight
        v = votes.reshape(-1, self.num_classes, 3)
        safe = torch.clamp(labels.long(), max=self.num_classes - 1)
        picked = torch.gather(v, 1, safe[:, None, None].expand(-1, 1, 3))[:, 0]
        vm = vote_mask & valid
        num_vote = torch.clamp(vm.sum().float(), min=1.0)
        loss_vote = L.l1_loss(picked, vote_targets, weight=vm.float(),
                              avg_factor=num_vote) * self.loss_vote_weight
        return {"loss_sem_seg": loss_seg, "loss_vote": loss_vote}


class VoteSegmentor(nn.Module):
    """``in_channels`` is the width of the raw point rows (xyz first)."""

    def __init__(self, in_channels: int,
                 voxel_size: tuple = (0.25, 0.25, 0.2),
                 point_cloud_range: tuple = (-80.0, -80.0, -2.0, 80.0, 80.0,
                                             4.0),
                 max_voxels: int = 65536, backbone: str = "sparse",
                 sst: dict | None = None, z_groups: int = 1,
                 dense_group_channels: int = 32,
                 dense_pre_channels: int = 32,
                 unet_level_caps: tuple = (65536, 32768, 16384, 8192, 4096),
                 unet_strides: tuple = ((2, 2, 2),) * 4,
                 unet_paddings: tuple = ((1, 1, 1), (1, 1, 1), (0, 1, 1),
                                         (1, 1, 1)),
                 vfe: dict | None = None, unet: dict | None = None,
                 head: dict | None = None,
                 voxel_downsampling_size: tuple | None = None,
                 tanh_dims: tuple | None = None,
                 return_multiscale: bool = False, dtype=torch.float32):
        super().__init__()
        if backbone not in ("sparse", "dense_bev", "sst"):
            raise ValueError(f"backbone={backbone!r}")
        self.backbone = backbone
        self.voxel_downsampling_size = (
            None if voxel_downsampling_size is None
            else tuple(voxel_downsampling_size))
        if self.voxel_downsampling_size is not None:
            nz, ny, nx = grid_shape_zyx(point_cloud_range,
                                        self.voxel_downsampling_size)
            if nz * ny * nx >= 2**31:
                raise ValueError("downsample key overflow; grow voxel")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.max_voxels = max_voxels
        self.unet_level_caps = tuple(unet_level_caps)
        self.unet_strides = tuple(tuple(s) for s in unet_strides)
        self.unet_paddings = tuple(tuple(p) for p in unet_paddings)
        self.tanh_dims = tanh_dims
        self.return_multiscale = return_multiscale
        self.grid = grid_shape_zyx(self.point_cloud_range, self.voxel_size)
        nz = self.grid[0]
        self.vfe_mod = DynamicVFE(
            in_channels, voxel_size=self.voxel_size,
            point_cloud_range=self.point_cloud_range, dtype=dtype,
            **(vfe or dict(feat_channels=(64, 64), mode="max")))
        cfg = dict(unet or {})
        if backbone == "sst":
            if nz != 1:
                raise ValueError(
                    f"the sst segmentor backbone needs a full-height pillar "
                    f"voxel (z grid {nz} != 1)")
            cfg.setdefault("num_attached_conv", 0)
            self.unet_mod = SSTv2(to_bev=False, dtype=dtype, **cfg)
            sst_cfg = dict(SST_DEFAULTS, **(sst or {}))
            self.sst_window_shape = tuple(sst_cfg["window_shape"])
            self.sst_buckets = tuple(BucketSpec(*b)
                                     for b in sst_cfg["buckets"])
            self.sst_max_total_windows = sst_cfg["max_total_windows"]
            self.sst_shuffle_voxels = sst_cfg["shuffle_voxels"]
            out_ch = self.unet_mod.out_channels
            self.decoder_widths = ()
        elif backbone == "sparse":
            # the JAX module reads the UNet's input width from its input
            cfg.pop("in_channels", None)
            self.unet_mod = SimpleSparseUNet(
                self.vfe_mod.out_channels,
                return_multiscale=return_multiscale, dtype=dtype, **cfg)
            out_ch = self.unet_mod.out_channels
            self.decoder_widths = self.unet_mod.decoder_widths
        else:
            out_ch = cfg.pop("out_channels", 128)
            cfg.pop("in_channels", None)
            cfg.pop("base_channels", None)
            self.scatter_mod = BEVScatter(
                self.vfe_mod.out_channels, nz, z_groups=z_groups,
                pre_channels=dense_pre_channels if z_groups > 1 else 0,
                dtype=dtype)
            unet_out = (z_groups * dense_group_channels if z_groups > 1
                        else out_ch)
            self.unet_mod = DenseBEVUNet(self.scatter_mod.out_channels,
                                         out_channels=unet_out, dtype=dtype,
                                         **cfg)
            self.decode_mod = DenseVoxelDecode(
                unet_out, nz, out_channels=out_ch, z_groups=z_groups,
                group_channels=dense_group_channels, dtype=dtype)
            self.decoder_widths = self.unet_mod.decoder_channels
        self.head_mod = VoteSegHead(out_ch + 3, dtype=dtype, **(head or {}))
        self.feat_channels = out_ch + 3

    def preprocess(self, points):
        if self.tanh_dims is None:
            return torch.cat([points[:, :3], torch.tanh(points[:, 3:])], dim=-1)
        out = points.clone()
        for d in self.tanh_dims:
            out[:, d] = torch.tanh(out[:, d])
        return out

    def voxel_downsample(self, points, points_valid, batch_size: int):
        """Average-dedup each sample's points over
        ``voxel_downsampling_size`` voxels: the [B*P, C] flat batch keeps
        its shape, a sample's merged points fill its first rows in key
        order, and the freed rows turn invalid. The cell is
        ``floor((p - lo) * (1 / size))`` with the float32 reciprocal, as
        jitted XLA divides (``ops/voxelize.py f32_reciprocal``)."""
        n, c = points.shape
        p = n // batch_size
        size = self.voxel_downsampling_size
        lo = self.point_cloud_range
        nz, ny, nx = grid_shape_zyx(lo, size)
        outs, oks = [], []
        for pp, vv in zip(points.reshape(batch_size, p, c),
                          points_valid.reshape(batch_size, p)):
            cc = torch.stack([torch.floor((pp[:, i] - lo[i])
                                          * f32_reciprocal(size[i]))
                              for i in range(3)], dim=-1).to(torch.int32)
            in_r = (vv & (cc >= 0).all(-1) & (cc[:, 0] < nx)
                    & (cc[:, 1] < ny) & (cc[:, 2] < nz))
            key = (cc[:, 2] * ny + cc[:, 1]) * nx + cc[:, 0]
            uniq = unique_segments(key, in_r, p)
            outs.append(segment_reduce(pp, uniq.seg_ids, p, "mean"))
            oks.append(uniq.unique_keys != INT_SENTINEL)
        return torch.cat(outs), torch.cat(oks)

    def forward(self, points, batch_idx, points_valid, batch_size: int,
                train: bool = False,
                generator: torch.Generator | None = None):
        """points: [P, C] flat batch. Returns the per-point seg dict.
        ``generator``: with the SST backbone in train mode, the source of
        the voxel shuffle (None shuffles nothing, as JAX without a
        ``shuffle`` rng)."""
        if self.voxel_downsampling_size is not None:
            points, points_valid = self.voxel_downsample(
                points, points_valid, batch_size)
        pts = self.preprocess(points)
        vm = dynamic_voxelize(pts, batch_idx, points_valid,
                              self.point_cloud_range, self.voxel_size,
                              self.max_voxels, batch_size)
        voxel_feats = self.vfe_mod(pts, vm, train)
        if self.backbone == "sparse":
            # the voxel unique already sorted the voxels by key, so the
            # SparseGrid is built without a re-sort
            sg = SparseGrid(
                keys=torch.where(vm.voxel_valid, vm.unique.unique_keys,
                                 INT_SENTINEL),
                coords=vm.voxel_coords, valid=vm.voxel_valid, grid=self.grid,
                batch_size=batch_size)
            plan = build_unet_plan(
                sg, (self.max_voxels,) + self.unet_level_caps[1:],
                self.unet_strides, self.unet_paddings)
            unet_out = self.unet_mod(voxel_feats, plan, train)
            vox_out = unet_out["voxel_feats"]
        elif self.backbone == "sst":
            perm = None
            if train and self.sst_shuffle_voxels and generator is not None:
                perm = dynamic_voxelnet.voxel_permutation(
                    vm.voxel_coords.shape[0], generator)
            plan = sst_input_layer(
                vm.voxel_coords, vm.voxel_valid,
                sparse_shape=(self.grid[2], self.grid[1], 1),
                window_shape=self.sst_window_shape, buckets=self.sst_buckets,
                d_model=self.unet_mod.d_model[0],
                max_total_windows=self.sst_max_total_windows, perm=perm)
            vox_out, vox_valid = self.unet_mod(voxel_feats, vm.voxel_coords,
                                               plan, batch_size, train)
            vox_out = torch.where(vox_valid[:, None], vox_out, 0.0)
        else:
            canvas = self.scatter_mod(voxel_feats, vm.voxel_coords,
                                      vm.voxel_valid, batch_size,
                                      self.grid[1:], train)
            bev_out, decoder_maps = self.unet_mod(canvas, train)
            vox_out = self.decode_mod(bev_out, vm.voxel_coords,
                                      vm.voxel_valid, train)

        pt_vox_feats = gather_segments(vox_out, vm.point_seg_ids)
        vs = torch.tensor(self.voxel_size, dtype=torch.float32,
                          device=pts.device)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=pts.device)
        centers = (vm.coords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
        local_xyz = torch.where(vm.valid[:, None], pts[:, :3] - centers, 0.0)
        feats = torch.cat([pt_vox_feats, local_xyz], dim=-1)

        logits, votes = self.head_mod(feats, vm.valid, train)
        out = {
            "seg_points": pts,
            "seg_logits": logits,
            "seg_vote_preds": votes,
            "offsets": decode_vote(votes),
            "seg_feats": feats,
            "batch_idx": batch_idx,
            "valid": vm.valid,
        }
        if self.return_multiscale:
            if self.backbone == "sparse":
                out["decoder_features"] = unet_out["decoder_features"]
                out["unet_plan"] = plan
            else:
                out["decoder_maps"] = decoder_maps
                out["voxel_mapping"] = vm
        return out
