"""SingleStageFSD — the fully-sparse detector (FSD, NeurIPS 2022), predict
and loss (counterpart of ``sst_tpu/models/fsd/single_stage.py``).

VoteSegmentor → 0.1 m pre-voxelization (one wide segment mean) → per-class
fg selection (score threshold + static top-k) → per-class cluster
voxelization → CCL over the cluster-voxel centres → SIR over the (class,
batch, cluster) groups → SparseClusterHeadV2.

Static capacities (``FSDCaps``) replace boolean-mask compaction as in the
JAX package: per-class fg caps, cluster-voxel caps and cluster caps.
``extract`` also returns counters that JAX's does not (``counts``: each
class's fg points, cluster voxels, clusters before the cap and CCL rounds),
read by ``chip_smoke.py``; they cost a few reductions and no host sync.

Training: ``loss`` (``pretrain`` runs the segmentor alone), the segmentor
branch's logits, votes and offsets detached before sampling (its features
keep their gradient), ``add_gt_fg_points`` ORing the points inside a gt box
of the class into its fg, CCL without autograd (its labels are integers).

Group sampling (``group_names``, the Argo2 recipe): sampling and
clustering run per class group instead of per class. The segmentor head
then carries a background column (``num_classes + 1`` logits); a group's
fg score is the softmax sum of its member classes, its vote offset the one
of the member with the largest logit, gt-label membership is per group,
the caps, thresholds and cluster sizes are indexed per group, and the
head's tasks are the groups.

Not ported, raising ``NotImplementedError``: the key-point assigner
(``"ssg"`` in ``assigner_per_class``, built on ``ops/fps.py``), ROADMAP
queue 1 item 7d; a compute dtype other than float32 (JAX's FSD builds are
float32).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from sst_tpu_torch.core.target_assign import gt_point_class_labels
from sst_tpu_torch.models import PointBatch
from sst_tpu_torch.models.fsd.sir import SIR
from sst_tpu_torch.models.fsd.sparse_cluster_head import SparseClusterHeadV2
from sst_tpu_torch.models.fsd.vote_segmentor import (
    VoteSegmentor,
    seg_targets,
)
from sst_tpu_torch.ops.ccl import (
    compact_labels,
    connected_components,
    topk_compact,
)
from sst_tpu_torch.ops.segment import (
    INT_SENTINEL,
    gather_segments,
    segment_reduce,
    unique_segments,
)
from sst_tpu_torch.ops.voxelize import f32_reciprocal, grid_shape_zyx

def _cell_coords(xyz: torch.Tensor, lo, size) -> torch.Tensor:
    """[N, 3] int32 ``floor((xyz - lo) * (1 / size))``, column by column
    with Python scalars (float32 arithmetic, as JAX's float32 arrays, and
    its float32 reciprocal, ``ops/voxelize.py f32_reciprocal``; no small
    tensor copied to the card, which would wait for its queue)."""
    return torch.stack([torch.floor((xyz[:, i] - lo[i])
                                    * f32_reciprocal(size[i]))
                        for i in range(3)], dim=-1).to(torch.int32)


@dataclass(frozen=True)
class FSDCaps:
    """Static capacities for the FSD pipeline."""

    fg_per_class: tuple = (8192, 4096, 4096)
    cluster_voxels_per_class: tuple = (4096, 4096, 4096)
    clusters_per_class: tuple = (512, 512, 512)
    pre_voxels: int = 131072


class SingleStageFSD(nn.Module):
    """``num_point_features`` is the width of the raw point rows (xyz
    first); the JAX module reads it from its input. The head's
    ``in_channel`` is derived from the SIR backbone (the JAX head ignores
    the config's value, which ``configs/fsd/fsd_waymoD1_1x.py`` gives as
    384 where SIR's three blocks give 768)."""

    def __init__(self, num_point_features: int = 5,
                 point_cloud_range: tuple = (-80.0, -80.0, -2.0, 80.0, 80.0,
                                             4.0),
                 num_classes: int = 3,
                 class_names: tuple = ("Car", "Pedestrian", "Cyclist"),
                 group_names: tuple | None = None,
                 score_thresh: tuple = (0.3, 0.25, 0.25),
                 cluster_voxel_size: tuple = ((0.3, 0.3, 6.0),
                                              (0.05, 0.05, 6.0),
                                              (0.2, 0.2, 6.0)),
                 connected_dist: tuple = (0.6, 0.1, 0.4),
                 min_points: int = 2,
                 pre_voxelization_size: tuple | None = (0.1, 0.1, 0.1),
                 add_gt_fg_points: bool = False,
                 assigner_per_class: tuple | None = None,
                 ssg_radius: tuple = (1.0, 0.4, 0.6),
                 ssg_num_fps: tuple = (256, 256, 256),
                 caps: FSDCaps | None = None,
                 segmentor: dict | None = None, backbone: dict | None = None,
                 head: dict | None = None, test_cfg: dict | None = None,
                 dtype=torch.float32):
        super().__init__()
        if assigner_per_class is not None and "ssg" in assigner_per_class:
            raise NotImplementedError(
                "assigner_per_class 'ssg' (the key-point assigner on "
                "ops/fps.py): ROADMAP queue 1 item 7d")
        if dtype != torch.float32:
            raise NotImplementedError(
                f"dtype={dtype}: FSD is ported in float32, as JAX builds it "
                f"(a bf16 FSD: ROADMAP queue 1 item 11)")
        del ssg_radius, ssg_num_fps  # read by the 'ssg' assigner only
        self.group_names = (None if group_names is None
                            else tuple(tuple(g) for g in group_names))
        # sampling and clustering units: the class groups where
        # group_names is set, else one unit per class
        self.num_units = (num_classes if group_names is None
                          else len(self.group_names))
        for name, val in (("score_thresh", score_thresh),
                          ("cluster_voxel_size", cluster_voxel_size),
                          ("connected_dist", connected_dist)):
            if len(val) < self.num_units:
                raise ValueError(
                    f"{name} has {len(val)} entries but {self.num_units} "
                    f"sampling units are configured")
        self.point_cloud_range = tuple(point_cloud_range)
        self.num_classes = num_classes
        self.class_names = tuple(class_names)
        self.score_thresh = tuple(score_thresh)
        self.cluster_voxel_size = tuple(tuple(v) for v in cluster_voxel_size)
        self.connected_dist = tuple(connected_dist)
        self.min_points = min_points
        self.pre_voxelization_size = (None if pre_voxelization_size is None
                                      else tuple(pre_voxelization_size))
        self.add_gt_fg_points = add_gt_fg_points
        self.caps = caps or FSDCaps()
        self.test_cfg = dict(test_cfg or dict(
            score_thr=0.1, nms_thr=0.25, nms_pre=1024, max_num=500,
            use_rotate_nms=True))

        self.segmentor_mod = VoteSegmentor(
            num_point_features, point_cloud_range=self.point_cloud_range,
            dtype=dtype, **(segmentor or {}))
        seg_classes = self.segmentor_mod.head_mod.num_classes
        self.backbone_mod = SIR(
            num_point_features,
            4 * seg_classes + self.segmentor_mod.feat_channels,
            dtype=dtype, **(backbone or {}))
        head_kw = {k: v for k, v in dict(head or {}).items()
                   if k not in ("num_classes", "class_names", "in_channel")}
        if self.group_names is not None:
            head_kw.setdefault("tasks", self.group_names)
        self.head_mod = SparseClusterHeadV2(
            num_classes=num_classes, class_names=self.class_names,
            in_channel=self.backbone_mod.cluster_channels, dtype=dtype,
            **head_kw)

    # ------------------------------------------------------------- pipeline

    def pre_voxelize(self, data: dict, batch_size: int) -> dict:
        """0.1 m dedup: every float field averaged over tiny voxels in ONE
        wide mean pass; batch_idx rides along as a float channel (the
        voxel key includes the batch, so its mean is itself). Keys are
        int32, as in JAX (60 x 1600 x 1600 cells per sample at 0.1 m)."""
        cap = self.caps.pre_voxels
        pts = data["seg_points"]
        c = _cell_coords(pts, self.point_cloud_range,
                         self.pre_voxelization_size)
        nz, ny, nx = grid_shape_zyx(self.point_cloud_range,
                                    self.pre_voxelization_size)
        key = ((data["batch_idx"] * nz + c[:, 2]) * ny + c[:, 1]) * nx \
            + c[:, 0]
        uniq = unique_segments(key, data["valid"], cap)
        names = ("seg_points", "seg_logits", "seg_vote_preds", "offsets",
                 "seg_feats")
        widths = [data[n].shape[-1] for n in names]
        wide = torch.cat([data[n] for n in names]
                         + [data["batch_idx"].float()[:, None]], dim=-1)
        red = segment_reduce(wide, uniq.seg_ids, cap, "mean")
        out = {}
        ofs = 0
        for n, w in zip(names, widths):
            out[n] = red[:, ofs:ofs + w]
            ofs += w
        out["batch_idx"] = torch.round(red[:, ofs]).to(torch.int32)
        out["valid"] = uniq.unique_keys != INT_SENTINEL
        return out

    def sample_class(self, data: dict, cls: int,
                     thr_extra: float = 0.0) -> dict:
        """fg selection for one sampling unit (a class, or a class group
        with ``group_names``): threshold + top-k compaction; in training
        with ``gt_point_labels`` in ``data``, the points inside a gt box of
        a class of the unit are fg too."""
        cap = self.caps.fg_per_class[cls]
        ids = ([cls] if self.group_names is None else
               [self.class_names.index(n) for n in self.group_names[cls]])
        if self.group_names is not None:
            # the background column's softmax; a group's score is the sum
            # of its members' probabilities
            probs = torch.softmax(data["seg_logits"], dim=-1)
            scores = probs[:, ids].sum(dim=-1)
        else:
            scores = torch.sigmoid(data["seg_logits"][:, cls])
        fg = data["valid"] & (scores > self.score_thresh[cls] + thr_extra)
        if data.get("gt_point_labels") is not None:
            member = torch.zeros_like(fg)
            for cid in ids:
                member = member | (data["gt_point_labels"] == cid)
            fg = fg | (data["valid"] & member)
        idx, sel_valid = topk_compact(scores, fg, cap)
        pts = data["seg_points"][idx]
        offs = data["offsets"][idx].reshape(idx.shape[0], -1, 3)
        if len(ids) > 1:
            # 'max' offset weighting: the offset of the member with the
            # largest logit
            member_logits = data["seg_logits"][idx][:, ids]
            w = F.one_hot(member_logits.argmax(-1), len(ids)).to(offs.dtype)
            offsets = (offs[:, ids] * w[..., None]).sum(dim=1)
        else:
            offsets = offs[:, ids[0]]
        return {
            "idx": idx,
            "valid": sel_valid,
            "points": pts,
            "feats": torch.cat([data["seg_logits"][idx],
                                data["seg_vote_preds"][idx],
                                data["seg_feats"][idx]], dim=-1),
            "centers": pts[:, :3] + offsets,
            "batch_idx": data["batch_idx"][idx],
        }

    def cluster_class(self, sample: dict, cls: int, batch_size: int):
        """Cluster voxelization + CCL for one class. Returns the per-point
        cluster slot in [0, clusters_per_class), its validity, and the
        class's counters (cluster voxels, clusters before the cap, CCL
        rounds)."""
        vcap = self.caps.cluster_voxels_per_class[cls]
        ccap = self.caps.clusters_per_class[cls]
        cvs = self.cluster_voxel_size[cls]
        pcr = self.point_cloud_range
        centers = sample["centers"]
        c = _cell_coords(centers, pcr, cvs)
        nx = int(round((pcr[3] - pcr[0]) / cvs[0])) + 2
        ny = int(round((pcr[4] - pcr[1]) / cvs[1])) + 2
        # clusters use xy (the z voxel is full height); clipped for safety
        cx = torch.clamp(c[:, 0], 0, nx - 1)
        cy = torch.clamp(c[:, 1], 0, ny - 1)
        key = (sample["batch_idx"] * ny + cy) * nx + cx
        uniq = unique_segments(key, sample["valid"], vcap)
        in_cap = torch.clamp(uniq.seg_ids.long(), max=vcap - 1)
        pt_valid = (sample["valid"] & (uniq.counts[in_cap] >= self.min_points)
                    & (uniq.seg_ids < vcap))
        vox_valid = ((uniq.unique_keys != INT_SENTINEL)
                     & (uniq.counts >= self.min_points))
        # one fused pass: centre mean + batch (a same-value mean)
        wide = torch.cat([centers, sample["batch_idx"].float()[:, None]], -1)
        red = segment_reduce(wide, uniq.seg_ids, vcap, "mean")
        vox_batch = torch.round(red[:, 3]).to(torch.int32)
        with torch.no_grad():
            labels, rounds = connected_components(
                red[:, :2], vox_batch, vox_valid, self.connected_dist[cls])
        comp_ids, num_clusters = compact_labels(labels, vox_valid, ccap)
        pt_cluster = torch.where(pt_valid, comp_ids[in_cap], ccap)
        pt_valid = pt_valid & (pt_cluster < ccap)
        stats = {"cluster_voxels": vox_valid.sum(dtype=torch.int32),
                 "clusters": num_clusters, "ccl_rounds": rounds}
        return pt_cluster, pt_valid, stats

    def extract(self, data: dict, batch_size: int, train: bool = False,
                thr_extra: float = 0.0) -> dict:
        """sample → cluster → SIR for every sampling unit; cluster-level
        and point-level tensors. A cluster's ``cluster_cls`` is its unit,
        the index of its head task."""
        streams, counts = [], []
        total_clusters = sum(self.caps.clusters_per_class[:self.num_units])
        offset = 0
        for cls in range(self.num_units):
            s = self.sample_class(data, cls, thr_extra)
            pc, pv, stats = self.cluster_class(s, cls, batch_size)
            ccap = self.caps.clusters_per_class[cls]
            streams.append((s, torch.where(pv, pc + offset, total_clusters),
                            pv))
            counts.append(dict(stats, fg=s["valid"].sum(dtype=torch.int32)))
            offset += ccap

        points = torch.cat([s["points"] for s, _, _ in streams])
        feats = torch.cat([s["feats"] for s, _, _ in streams])
        centers = torch.cat([s["centers"] for s, _, _ in streams])
        batch_idx = torch.cat([s["batch_idx"] for s, _, _ in streams])
        seg_ids = torch.cat([sg for _, sg, _ in streams])
        pt_valid = torch.cat([pv for _, _, pv in streams])

        # one fused sum pass: xyz mean (sum / count), batch (same-value),
        # valid (count > 0)
        wide = torch.cat([centers, batch_idx.float()[:, None],
                          centers.new_ones((centers.shape[0], 1))], -1)
        red = segment_reduce(wide, seg_ids, total_clusters, "sum")
        cnt = torch.clamp(red[:, 4], min=1.0)
        cluster_xyz = red[:, :3] / cnt[:, None]
        cluster_batch = torch.round(red[:, 3] / cnt).to(torch.int32)
        cluster_cls = torch.cat([
            torch.full((self.caps.clusters_per_class[c],), c,
                       dtype=torch.int32, device=points.device)
            for c in range(self.num_units)])
        cluster_valid = red[:, 4] > 0

        f_cluster = points[:, :3] - gather_segments(cluster_xyz, seg_ids)
        pt_feats, cluster_feats = self.backbone_mod(
            points, feats, f_cluster, seg_ids, total_clusters, pt_valid,
            train)
        return {
            "cluster_feats": cluster_feats,
            "cluster_xyz": cluster_xyz,
            "cluster_batch": cluster_batch,
            "cluster_cls": cluster_cls,
            "cluster_valid": cluster_valid,
            "pt_feats": pt_feats,
            "points": points,
            "pt_seg_ids": seg_ids,
            "pt_valid": pt_valid,
            "pt_batch_idx": batch_idx,
            "pt_idx": torch.cat([s["idx"] for s, _, _ in streams]),
            "counts": {k: torch.stack([c[k] for c in counts])
                       for k in counts[0]},
        }

    def run_pipeline(self, batch: PointBatch, train: bool = False,
                     thr_extra: float = 0.0, detach_seg: bool = True) -> dict:
        """Segmentor → pre-voxelize → sample/cluster → SIR → head outputs,
        with every intermediate the prediction, the losses and the RoI
        stage read. ``detach_seg`` detaches the segmentor's logits, votes
        and offsets (not its features), as JAX's ``stop_gradient``s."""
        b, p, _ = batch.points.shape
        pts = batch.points.reshape(b * p, -1)
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=pts.device).repeat_interleave(p)
        seg_out = self.segmentor_mod(pts, batch_idx, batch.valid.reshape(-1),
                                     b, train)
        data = {k: seg_out[k] for k in ("seg_points", "seg_logits",
                                        "seg_vote_preds", "offsets",
                                        "seg_feats", "batch_idx", "valid")}
        if detach_seg:
            for k in ("seg_logits", "seg_vote_preds", "offsets"):
                data[k] = data[k].detach()
        if self.pre_voxelization_size is not None:
            data = self.pre_voxelize(data, b)
        if train and self.add_gt_fg_points:
            # the segmentor's misses inside gt boxes, on the (pre-voxelized)
            # points
            data["gt_point_labels"] = gt_point_class_labels(
                data["seg_points"][:, :3], data["batch_idx"], data["valid"],
                batch.gt_boxes, batch.gt_labels, batch.gt_valid)
        ex = self.extract(data, b, train, thr_extra)
        outs = self.head_mod(ex["cluster_feats"], ex["cluster_valid"], train)
        return {"seg_out": seg_out, "data": data, "ex": ex, "outs": outs,
                "batch_size": b}

    def seg_losses(self, batch: PointBatch, seg_out: dict) -> dict:
        """The segmentor head's losses against each sample's gt boxes."""
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
            pipe["outs"], ex["cluster_xyz"], ex["cluster_batch"],
            ex["cluster_valid"], batch.gt_boxes, batch.gt_labels,
            batch.gt_valid))
        losses["num_clusters"] = ex["cluster_valid"].sum().float()
        losses["num_fg_points"] = ex["pt_valid"].sum().float()
        return losses

    def loss(self, batch: PointBatch, train: bool = True,
             thr_extra: float = 0.0, pretrain: bool = False) -> dict:
        """The training losses of a labelled batch (``loss*`` keys, summed
        by ``train/step.py``) and two counters, as the JAX model returns
        them. ``pretrain``: the segmentor alone and its losses (the
        detection schedule's warm-up, and the segmentation pretrain
        recipe); ``pretrain`` and ``thr_extra`` come from
        ``train/schedules.py FSDDetectionSchedule``."""
        if pretrain:
            b, p, _ = batch.points.shape
            batch_idx = torch.arange(
                b, dtype=torch.int32,
                device=batch.points.device).repeat_interleave(p)
            seg_out = self.segmentor_mod(batch.points.reshape(b * p, -1),
                                         batch_idx, batch.valid.reshape(-1),
                                         b, train)
            return self.seg_losses(batch, seg_out)
        return self.losses_from_pipeline(
            batch, self.run_pipeline(batch, train, thr_extra))

    @torch.inference_mode()
    def predict_seg(self, batch: PointBatch, score_thr: float = 0.5) -> dict:
        """Per-point class predictions and box-derived gt labels for the
        seg-eval protocol (``core/eval_seg.py``, ``tools/test.py --eval
        seg``). A point takes the argmax of its per-class sigmoid scores,
        or background (``num_classes``) where the largest is below
        ``score_thr``; its gt label is the seg loss's target
        (``seg_targets``). Returns dict(pred [B, P] int32, gt [B, P] int32,
        valid [B, P])."""
        b, p, _ = batch.points.shape
        batch_idx = torch.arange(b, dtype=torch.int32,
                                 device=batch.points.device).repeat_interleave(p)
        seg_out = self.segmentor_mod(batch.points.reshape(b * p, -1),
                                     batch_idx, batch.valid.reshape(-1), b,
                                     False)
        scores = torch.sigmoid(seg_out["seg_logits"].float())
        best, arg = scores.max(dim=-1)
        pred = torch.where(best >= score_thr, arg, self.num_classes)
        gt = torch.stack([seg_targets(batch.points[i, :, :3], batch.valid[i],
                                      batch.gt_boxes[i], batch.gt_labels[i],
                                      batch.gt_valid[i], self.num_classes)[0]
                          for i in range(b)])
        return {"pred": pred.to(torch.int32).reshape(b, p),
                "gt": gt.to(torch.int32), "valid": batch.valid}

    @torch.inference_mode()
    def predict(self, batch: PointBatch) -> dict:
        """Boxes for a batch: dict of [B, max_num] boxes, scores, labels and
        valid."""
        pipe = self.run_pipeline(batch, detach_seg=False)
        ex = pipe["ex"]
        return self.head_mod.get_bboxes(
            pipe["outs"], ex["cluster_xyz"], ex["cluster_batch"],
            ex["cluster_valid"], pipe["batch_size"], **self.test_cfg)

    def forward(self, batch: PointBatch, train: bool = False):
        return self.run_pipeline(batch, train)["outs"]
