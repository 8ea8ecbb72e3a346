"""FSDv2 — virtual-voxel fully-sparse detector (counterpart of
``sst_tpu/models/fsd/fsdv2.py``): the single stage, inference and ``loss``
(train mode) in its sparse and dense-BEV builds, and the two stage
``FSDV2`` (the single stage as its RPN, then ``GroupCorrectionHead`` over
the recovered per-point features).

Pipeline: VoteSegmentor (multiscale) → per-class fg sampling (threshold +
static top-k) → virtual points = vote-shifted centres with ``virtual_proj``
features; real points with ``ori_proj`` features → union voxelized at
``virtual_voxel_size`` → DynamicVFE → multiscale fusion → mixer →
virtual-voxel compaction (static cap) → SparseClusterHeadV2.

``mixer_type="sparse"`` (with the sparse segmentor): the segmentor's UNet
decoder features are projected onto the virtual grid, segment-mean merged
with the virtual voxels into a union grid, and mixed by VirtualVoxelMixer
(a sparse UNet). ``mixer_type="dense_bev"`` (with the dense-BEV segmentor):
each virtual voxel gathers its xy cell from the decoder BEV maps and
DenseBEVMixer mixes them.

``loss``: the segmentor's focal and vote losses against the points' gt
boxes, and the head's per-task losses against the virtual voxels' gt boxes.
``seg_logits``, ``seg_vote_preds`` and ``offsets`` reach the detection
branch detached (``detach_seg``), as in the JAX package.

Batched group sampling (``group_names``, the nuScenes and Argo2
recipes): virtual points are sampled per class group. The segmentor head
carries a background column (``num_classes + 1`` logits); a group's fg
score is the softmax sum of its member classes, its vote offset the one of
the member with the largest logit, scaled by ``group_offset_scale``;
thresholds and fg caps are per group. The head's tasks stay the config's.

``as_rpn``: ``extract_feat`` also recovers per-point features for an RoI
stage: each real and virtual point takes its virtual voxel's mixed
features and its offset from the voxel centre through ``recover_proj``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from portbench.ref.core.target_assign import (
    gt_fg_points_mask,
    gt_point_class_labels,
)
from portbench.ref.models import PointBatch
from portbench.ref.models.dense_bev import DenseBEVMixer
from portbench.ref.models.fsd.sparse_cluster_head import SparseClusterHeadV2
from portbench.ref.models.fsd.vote_segmentor import (
    VoteSegmentor,
    seg_targets,
)
from portbench.ref.models.layers import MLP
from portbench.ref.models.vfe import DynamicVFE
from portbench.ref.ops.ccl import topk_compact
from portbench.ref.ops.segment import (
    INT_SENTINEL,
    gather_segments,
    segment_reduce,
    unique_segments,
)
from portbench.ref.ops.voxelize import (
    delinearize_key,
    dynamic_voxelize,
    grid_shape_zyx,
    linearize_coords,
)


@dataclass(frozen=True)
class FSDV2Caps:
    """Static capacities for the FSDv2 pipeline."""

    fg_per_class: tuple = (8192, 4096, 4096)
    voxels: int = 32768
    union_voxels: int = 49152
    virtual_out: int = 8192


class SingleStageFSDV2(nn.Module):
    """``num_point_features`` is the width of the raw point rows (xyz
    first). ``dtype`` is the compute dtype of every module, float32 or
    bfloat16, as flax's ``dtype`` (``models/layers.py``), in the dense-BEV
    and in the sparse build (the sparse UNet and mixer run the conv
    kernels' bf16 routes); the parameters stay float32. Options of the JAX
    model outside this port's slice raise NotImplementedError."""

    def __init__(self, num_point_features: int = 3,
                 point_cloud_range: tuple = (-80.0, -80.0, -2.0, 80.0, 80.0,
                                             4.0),
                 virtual_voxel_size: tuple = (0.5, 0.5, 0.5),
                 num_classes: int = 3,
                 class_names: tuple = ("Car", "Pedestrian", "Cyclist"),
                 score_thresh: tuple = (0.3, 0.25, 0.25),
                 group_names: tuple | None = None,
                 group_offset_scale: float = 1.0,
                 offset_normalizer: float = 10.0,
                 proj_hidden: tuple = (64, 64),
                 multiscale_levels: tuple = (0, 1),
                 ms_projector_hiddens: tuple = ((128,), (128,)),
                 ms_output_dim: int = 128, mixer_type: str = "sparse",
                 mixer_strides: tuple = ((2, 2, 2), (2, 2, 2)),
                 mixer_paddings: tuple = ((1, 1, 1), (1, 1, 1)),
                 centroid_alpha: float | None = None,
                 caps: FSDV2Caps | None = None, segmentor: dict | None = None,
                 vfe: dict | None = None, mixer: dict | None = None,
                 head: dict | None = None, as_rpn: bool = False,
                 test_cfg: dict | None = None, dtype=torch.float32,
                 **train_cfg):
        super().__init__()
        segmentor = dict(segmentor or {})
        backbone = segmentor.get("backbone", "sparse")
        # the sparse mixer fuses the sparse UNet's decoder features and the
        # dense mixer the dense UNet's BEV maps; the JAX model runs no other
        # pairing either
        if (mixer_type, backbone) != ("dense_bev", "dense_bev"):
            raise NotImplementedError(
                f"mixer_type={mixer_type!r} with segmentor backbone "
                f"{backbone!r}: the port runs 'sparse' with 'sparse' and "
                f"'dense_bev' with 'dense_bev'")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"dtype={dtype}: float32 and bfloat16 are ported")
        # options read only by training
        unknown = set(train_cfg) - {"add_gt_fg_points"}
        if unknown:
            raise TypeError(f"unexpected arguments {sorted(unknown)}")
        # add_gt_fg_points: at train time, points inside a same-class gt box
        # join the fg selection (single_stage_fsd.py:776-796)
        self.add_gt_fg_points = bool(train_cfg.get("add_gt_fg_points", False))
        # in training, a virtual voxel's centroid weighs gt-foreground
        # points 1 and the others centroid_alpha (None: the plain mean)
        self.centroid_alpha = centroid_alpha
        self.mixer_type = mixer_type
        self.as_rpn = as_rpn
        self.mixer_strides = tuple(tuple(s) for s in mixer_strides)
        self.mixer_paddings = tuple(tuple(p) for p in mixer_paddings)
        self.point_cloud_range = tuple(point_cloud_range)
        self.virtual_voxel_size = tuple(virtual_voxel_size)
        self.num_classes = num_classes
        self.class_names = tuple(class_names)
        self.group_names = (None if group_names is None
                            else tuple(tuple(g) for g in group_names))
        self.group_offset_scale = group_offset_scale
        self.score_thresh = tuple(score_thresh)
        self.offset_normalizer = offset_normalizer
        self.multiscale_levels = tuple(multiscale_levels)
        self.caps = caps or FSDV2Caps()
        n_groups = (num_classes if group_names is None
                    else len(self.group_names))
        if len(self.caps.fg_per_class) < n_groups:
            raise ValueError(
                f"caps.fg_per_class has {len(self.caps.fg_per_class)} entries "
                f"but {n_groups} sampling groups are configured — provide "
                f"one fg cap per group")
        self.test_cfg = dict(test_cfg or dict(
            score_thr=0.1, nms_thr=0.25, nms_pre=1024, max_num=500,
            use_rotate_nms=True))
        self.vgrid = grid_shape_zyx(self.point_cloud_range,
                                    self.virtual_voxel_size)

        self.segmentor_mod = VoteSegmentor(
            num_point_features, point_cloud_range=self.point_cloud_range,
            return_multiscale=True, dtype=dtype, **segmentor)
        seg_c = self.segmentor_mod.feat_channels
        # a virtual point's input carries every seg logit (with the
        # background column under group sampling)
        self.virtual_proj = MLP(
            seg_c + 3 + self.segmentor_mod.head_mod.num_classes
            + num_point_features - 3,
            tuple(proj_hidden), norm="ln", dtype=dtype)
        self.ori_proj = MLP(seg_c, tuple(proj_hidden), norm="ln", dtype=dtype)
        self.vfe_mod = DynamicVFE(
            3 + self.ori_proj.out_channels,
            voxel_size=self.virtual_voxel_size,
            point_cloud_range=self.point_cloud_range, dtype=dtype,
            **(vfe or dict(feat_channels=(64, 128), mode="max")))
        dec_widths = self.segmentor_mod.decoder_widths
        self.n_ms = len(ms_projector_hiddens)
        for i, hid in enumerate(ms_projector_hiddens):
            self.add_module(f"ms_projs_{i}", MLP(
                dec_widths[self.multiscale_levels[i]],
                tuple(hid) + (ms_output_dim,), norm="ln", dtype=dtype))
        self.mixer_mod = DenseBEVMixer(self.vfe_mod.out_channels,
                                       nz=self.vgrid[0], dtype=dtype,
                                       **(mixer or {}))
        # configs may repeat num_classes / class_names inside the head dict;
        # the model-level values win
        head_kw = {k: v for k, v in dict(head or {}).items()
                   if k not in ("num_classes", "class_names")}
        self.head_mod = SparseClusterHeadV2(
            num_classes=num_classes, class_names=tuple(class_names),
            dtype=dtype, **head_kw)
        if as_rpn:
            # per-point recovery: the voxel's mixed features and the
            # point's offset from the voxel centre
            self.recover_proj = MLP(self.mixer_mod.out_channels + 3,
                                    (128, 128), norm="ln", dtype=dtype)

    # --------------------------------------------------------------- sampling

    def _clip(self, xyz):
        pcr = self.point_cloud_range
        eps = 1e-5
        return torch.stack(
            [torch.clamp(xyz[:, i], pcr[i] + eps, pcr[i + 3] - eps)
             for i in range(3)], dim=-1)

    def sample_class(self, data: dict, cls: int, thr_extra: float = 0.0,
                     pretrain: bool = False):
        """fg selection for one class: threshold + top-k compaction;
        ``pretrain`` (the detection warm-up) takes the top-k of every valid
        point by score, with no threshold."""
        cap = self.caps.fg_per_class[cls]
        scores = torch.sigmoid(data["seg_logits"][:, cls])
        if pretrain:
            fg = data["valid"]
        else:
            fg = data["valid"] & (scores > self.score_thresh[cls] + thr_extra)
            if data.get("gt_point_labels") is not None:
                fg = fg | (data["valid"] & (data["gt_point_labels"] == cls))
        idx, sel_valid = topk_compact(scores, fg, cap)
        pts = data["seg_points"][idx]
        offsets = data["offsets"][idx].reshape(-1, self.num_classes, 3)[:, cls]
        centers = self._clip(pts[:, :3] + offsets)
        # virtual point features: [seg_feats, offset/10, seg_logits, extras]
        proj_in = torch.cat(
            [data["seg_feats"][idx],
             (centers - pts[:, :3]) / self.offset_normalizer,
             data["seg_logits"][idx], pts[:, 3:]], dim=-1)
        return {"valid": sel_valid, "centers": centers, "proj_in": proj_in,
                "batch_idx": data["batch_idx"][idx]}

    def sample_group(self, data: dict, gi: int, thr_extra: float = 0.0,
                     pretrain: bool = False):
        """fg selection for class group ``gi``: the softmax over the
        background column, a group's score the sum of its members'
        probabilities, its offset the largest-logit member's times
        ``group_offset_scale``; ``pretrain`` as in :meth:`sample_class`."""
        ids = [self.class_names.index(n) for n in self.group_names[gi]]
        cap = self.caps.fg_per_class[gi]
        probs = torch.softmax(data["seg_logits"], dim=-1)
        gscore = probs[:, ids].sum(dim=-1)
        if pretrain:
            fg = data["valid"]
        else:
            fg = data["valid"] & (gscore > self.score_thresh[gi] + thr_extra)
            if data.get("gt_point_labels") is not None:
                member = torch.zeros_like(fg)
                for cid in ids:
                    member = member | (data["gt_point_labels"] == cid)
                fg = fg | (data["valid"] & member)
        idx, sel_valid = topk_compact(gscore, fg, cap)
        pts = data["seg_points"][idx]
        member_logits = data["seg_logits"][idx][:, ids]
        offs = data["offsets"][idx].reshape(idx.shape[0], -1, 3)[:, ids]
        w = F.one_hot(member_logits.argmax(-1), len(ids)).to(offs.dtype)
        offset = (offs * w[..., None]).sum(dim=1) * self.group_offset_scale
        centers = self._clip(pts[:, :3] + offset)
        proj_in = torch.cat(
            [data["seg_feats"][idx],
             (centers - pts[:, :3]) / self.offset_normalizer,
             data["seg_logits"][idx], pts[:, 3:]], dim=-1)
        return {"valid": sel_valid, "centers": centers, "proj_in": proj_in,
                "batch_idx": data["batch_idx"][idx]}

    # ----------------------------------------------------------- feature path

    def _dense_fusion_and_mixer(self, data, vm, voxel_feats, batch_size,
                                train: bool):
        """Every virtual voxel gathers its xy cell from each decoder BEV map
        (NHWC); DenseBEVMixer over the virtual voxels' own slots."""
        vgrid = self.vgrid
        feats_sum = voxel_feats
        n_contrib = 1.0
        vc = vm.voxel_coords
        for i, lvl_idx in enumerate(self.multiscale_levels):
            m = data["decoder_maps"][lvl_idx]
            b, hl, wl, _ = m.shape
            cy = torch.clamp((vc[:, 2] * hl) // vgrid[1], 0, hl - 1)
            cx = torch.clamp((vc[:, 3] * wl) // vgrid[2], 0, wl - 1)
            cell = (torch.clamp(vc[:, 0], min=0) * hl + cy) * wl + cx
            # index_select: its backward adds repeated cells by
            # index_add_ (the invalid voxels all read one cell)
            g = torch.index_select(m.reshape(b * hl * wl, -1), 0,
                                   cell.long())
            feats_sum = feats_sum + getattr(self, f"ms_projs_{i}")(
                g, vm.voxel_valid, train)
            n_contrib += 1.0
        union_feats = feats_sum / n_contrib
        return self.mixer_mod(union_feats, vc, vm.voxel_valid, batch_size,
                              vgrid[1:], train)

    def extract_feat(self, data: dict, batch_size: int, train: bool = False,
                     thr_extra: float = 0.0, pretrain: bool = False):
        caps = self.caps
        if self.group_names is not None:
            samples = [self.sample_group(data, g, thr_extra, pretrain)
                       for g in range(len(self.group_names))]
        else:
            samples = [self.sample_class(data, c, thr_extra, pretrain)
                       for c in range(self.num_classes)]
        vir_xyz = torch.cat([s["centers"] for s in samples])
        vir_in = torch.cat([s["proj_in"] for s in samples])
        vir_valid = torch.cat([s["valid"] for s in samples])
        vir_batch = torch.cat([s["batch_idx"] for s in samples])
        vir_feat = self.virtual_proj(vir_in, vir_valid, train)

        ori_xyz = data["seg_points"][:, :3]
        ori_feat = self.ori_proj(data["seg_feats"], data["valid"], train)

        cat_xyz = torch.cat([ori_xyz, vir_xyz])
        cat_feat = torch.cat([ori_feat, vir_feat])
        cat_batch = torch.cat([data["batch_idx"], vir_batch])
        cat_valid = torch.cat([data["valid"], vir_valid])
        indicator = torch.cat([cat_xyz.new_zeros(ori_xyz.shape[0]),
                               cat_xyz.new_ones(vir_xyz.shape[0])])

        # virtual-grid voxelization + VFE; the indicator sum and the
        # centroid mean ride the VFE's cluster-centre sum pass
        vfe_in = torch.cat([cat_xyz, cat_feat], dim=-1)
        vm = dynamic_voxelize(vfe_in, cat_batch, cat_valid,
                              self.point_cloud_range, self.virtual_voxel_size,
                              caps.voxels, batch_size)
        voxel_feats, vfe_aux = self.vfe_mod(vfe_in, vm, train,
                                            extra_sum=indicator[:, None])
        counts_f = torch.clamp(vm.unique.counts, min=1).float()
        vox_indicator = vfe_aux["extra_sum"][:, 0] / counts_f
        virtual_mask = vm.voxel_valid & (vox_indicator > 0)
        if train and self.centroid_alpha is not None:
            # gt-fg points weigh 1, the others alpha, so the regression
            # anchor leans to the object's surface points: one fused
            # 4-channel sum (weighted xyz and the weight)
            used = cat_valid & vm.valid
            gfg = gt_fg_points_mask(cat_xyz, cat_batch, used,
                                    data["gt_boxes"], data["gt_labels"],
                                    data["gt_valid"])
            w = torch.where(gfg, 1.0, self.centroid_alpha) * used.float()
            swa = segment_reduce(torch.cat([cat_xyz * w[:, None],
                                            w[:, None]], -1),
                                 vm.point_seg_ids, caps.voxels, "sum")
            centroid = swa[:, :3] / torch.clamp(swa[:, 3], min=1e-6)[:, None]
        else:
            centroid = vfe_aux["cluster_mean"]

        vc = vm.voxel_coords
        orig_out = self._dense_fusion_and_mixer(data, vm, voxel_feats,
                                                batch_size, train)

        # compact virtual voxels for the head
        vidx, vvalid = topk_compact(vox_indicator, virtual_mask,
                                    caps.virtual_out)
        vs = torch.tensor(self.virtual_voxel_size, dtype=torch.float32,
                          device=vc.device)
        pcr = torch.tensor(self.point_cloud_range[:3], dtype=torch.float32,
                           device=vc.device)
        vcoords = vc[vidx]
        vcenters = (vcoords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
        out = {
            "virtual_feats": orig_out[vidx],
            "virtual_centers": torch.where(vvalid[:, None], vcenters, 0.0),
            "virtual_batch": torch.clamp(vcoords[:, 0], min=0),
            "virtual_valid": vvalid,
            "virtual_centroid": centroid[vidx],
            "num_virtual": virtual_mask.sum(dtype=torch.int32),
            # union inputs whose voxel fell past the caps.voxels cap
            "num_union_overflow_points": (
                cat_valid & vm.valid
                & (vm.point_seg_ids >= caps.voxels)).sum(dtype=torch.int32),
        }
        if self.as_rpn:
            pt_feat = gather_segments(orig_out, vm.point_seg_ids)
            pt_vc = (vm.coords[:, [3, 2, 1]].float() + 0.5) * vs + pcr
            offset = torch.where(vm.valid[:, None],
                                 (pt_vc - cat_xyz) / vs * 2.0, 0.0)
            out.update(
                pts_feats=self.recover_proj(
                    torch.cat([pt_feat, offset], dim=-1), vm.valid, train),
                pts_xyz=cat_xyz, pts_batch=cat_batch,
                pts_valid=cat_valid & vm.valid)
        return out

    # ---------------------------------------------------------------- wiring

    def run_pipeline(self, batch: PointBatch, train: bool = False,
                     thr_extra: float = 0.0, pretrain: bool = False,
                     detach_seg: bool = True):
        b, p, _ = batch.points.shape
        pts = batch.points.reshape(b * p, -1)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=pts.device).repeat_interleave(p)
        seg_out = self.segmentor_mod(pts, batch_idx, batch.valid.reshape(-1),
                                     b, train)
        data = {k: seg_out[k] for k in (
            "seg_points", "seg_logits", "seg_vote_preds", "offsets",
            "seg_feats", "batch_idx", "valid", "decoder_features",
            "unet_plan", "decoder_maps") if k in seg_out}
        if train:
            data.update(gt_boxes=batch.gt_boxes, gt_labels=batch.gt_labels,
                        gt_valid=batch.gt_valid)
        if train and self.add_gt_fg_points:
            data["gt_point_labels"] = gt_point_class_labels(
                seg_out["seg_points"][:, :3], seg_out["batch_idx"],
                seg_out["valid"], batch.gt_boxes, batch.gt_labels,
                batch.gt_valid)
        if detach_seg:
            for k in ("seg_logits", "seg_vote_preds", "offsets"):
                data[k] = data[k].detach()
        ex = self.extract_feat(data, b, train, thr_extra, pretrain)
        outs = self.head_mod(ex["virtual_feats"], ex["virtual_valid"], train)
        return {"seg_out": seg_out, "data": data, "ex": ex, "outs": outs,
                "batch_size": b}

    def seg_losses(self, batch: PointBatch, seg_out: dict) -> dict:
        """The segmentor's losses against each sample's gt boxes."""
        targets = [seg_targets(batch.points[i, :, :3], batch.valid[i],
                               batch.gt_boxes[i], batch.gt_labels[i],
                               batch.gt_valid[i], self.num_classes)
                   for i in range(batch.points.shape[0])]
        lbl, vt, vmask = (torch.cat(t) for t in zip(*targets))
        return self.segmentor_mod.head_mod.losses(
            seg_out["seg_logits"], seg_out["seg_vote_preds"], lbl, vt, vmask,
            seg_out["valid"])

    def losses_from_pipeline(self, batch: PointBatch, pipe: dict) -> dict:
        losses = self.seg_losses(batch, pipe["seg_out"])
        ex = pipe["ex"]
        losses.update(self.head_mod.loss(
            pipe["outs"], ex["virtual_centers"], ex["virtual_batch"],
            ex["virtual_valid"], batch.gt_boxes, batch.gt_labels,
            batch.gt_valid))
        losses["num_virtual"] = ex["num_virtual"].float()
        losses["num_union_overflow_points"] = (
            ex["num_union_overflow_points"].float())
        return losses

    def loss(self, batch: PointBatch, train: bool = True,
             thr_extra: float = 0.0, pretrain: bool = False) -> dict:
        """The training losses of a labelled batch (``loss*`` keys, summed
        by ``train/step.py``) and two counters, as the JAX model returns
        them. ``pretrain`` and ``thr_extra`` come from
        ``train/schedules.py FSDDetectionSchedule``."""
        pipe = self.run_pipeline(batch, train, thr_extra, pretrain)
        return self.losses_from_pipeline(batch, pipe)

    @torch.inference_mode()
    def predict(self, batch: PointBatch):
        """Boxes for a batch: dict of [B, max_num] boxes, scores, labels and
        valid."""
        pipe = self.run_pipeline(batch, detach_seg=False)
        ex = pipe["ex"]
        return self.head_mod.get_bboxes(
            pipe["outs"], ex["virtual_centers"], ex["virtual_batch"],
            ex["virtual_valid"], pipe["batch_size"], **self.test_cfg)

    def forward(self, batch: PointBatch, train: bool = False):
        return self.run_pipeline(batch, train)["outs"]
