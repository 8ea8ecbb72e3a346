"""FSD two-stage RoI refinement: ``dynamic_point_pool``,
``FullySparseBboxHead`` and ``GroupCorrectionHead`` with its targets and
losses (counterpart of ``sst_tpu/models/fsd/roi_head.py``).

The pooling is a static [R, K] pairing: per roi, the first K in-box points
in ascending point index with their 13-dim geometry, built roi-major
(candidate compaction, a column cumsum of the [M, R] membership, a
per-roi ``searchsorted``), so a point pairs with every roi that contains
it. Pair (r, k) belongs to group r, so the SIR² pooling needs no unique.
The pairs' rows (their points for the geometry, then their points and
features for the head) are read by ``gather_rows``: the empty slots (about
70% of a full-width frame's 65,536) do not all send their zero gradients to
one point's row.

Training: ``assign_and_sample`` (each proposal's best same-sample,
same-class 3D IoU), the IoU-piecewise sampler
(``core/target_assign.py iou_neg_piecewise_sample``), and ``loss``: the
soft-label classification, the L1 of the residuals to the gt in the roi's
canonical frame (``canonical_gt``) and the corner loss against the gt and
its flipped twin.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sst_tpu_torch.core import losses as L
from sst_tpu_torch.core.box_coders import delta_decode, delta_encode
from sst_tpu_torch.core.boxes import corners, rotate_2d
from sst_tpu_torch.core.iou import boxes_iou_3d
from sst_tpu_torch.core.nms import nms_bev, topk_presort
from sst_tpu_torch.core.target_assign import iou_neg_piecewise_sample
from sst_tpu_torch.models.fsd.sir import SIRLayer
from sst_tpu_torch.models.layers import MLP
from sst_tpu_torch.ops.segment import gather_rows, segment_reduce


def _local_frame(points_xyz, pts_rois):
    """Per-row box-local coords (lw: along box w, ll: along l, lz from the
    box's top centre), for points_xyz [N, 3] paired 1:1 with pts_rois
    [N, 7]."""
    relx = points_xyz[:, 0] - pts_rois[:, 0]
    rely = points_xyz[:, 1] - pts_rois[:, 1]
    c, s = torch.cos(pts_rois[:, 6]), torch.sin(pts_rois[:, 6])
    lw = relx * c - rely * s
    ll = relx * s + rely * c
    lz = points_xyz[:, 2] - (pts_rois[:, 2] + pts_rois[:, 5] / 2)
    return lw, ll, lz


def _inside_rois(pts, pv, pb, rois, roi_valid, roi_batch, ex):
    """[M, R] bool: point i inside (extra_wlh-enlarged, batch-matched)
    roi j."""
    cos, sin = torch.cos(rois[:, 6]), torch.sin(rois[:, 6])
    wh = rois[:, 3] / 2 + ex[0]
    lh = rois[:, 4] / 2 + ex[1]
    hh = rois[:, 5] / 2 + ex[2]
    zc = rois[:, 2] + rois[:, 5] / 2
    relx = pts[:, 0, None] - rois[None, :, 0]
    rely = pts[:, 1, None] - rois[None, :, 1]
    lw = relx * cos[None] - rely * sin[None]
    ll = relx * sin[None] + rely * cos[None]
    lz = pts[:, 2, None] - zc[None]
    return ((torch.abs(lw) <= wh[None]) & (torch.abs(ll) <= lh[None])
            & (torch.abs(lz) <= hh[None])
            & pv[:, None] & roi_valid[None] & (pb[:, None] == roi_batch[None]))


def dynamic_point_pool(points_xyz, pts_valid, pts_batch, rois, roi_valid,
                       roi_batch, extra_wlh=(0.5, 0.5, 0.5),
                       max_inbox_point: int = 256,
                       max_paired_points: int = 65536, chunk: int = 16384):
    """[R, K] in-box point pairing + 13-dim geometry.

    A chunked any-membership pass selects the at most ``max_paired_points``
    candidate points inside any roi, in ascending point order (counter
    ``membership_overflow`` for those beyond the cap); a column cumsum over
    the [M, R] candidate membership ranks each point within each roi
    holding it, and a per-roi ``searchsorted`` takes the first K
    (``inbox_overflow`` counts the pairs past the per-roi cap).

    Returns dict: idx [R, K] point indices, valid [R, K], geo [R, K, 13] =
    (local_l, local_w, local_z, off_l-, off_w-, off_z-, off_l+, off_w+,
    off_z+, in_margin, rel_xyz(3)), membership_overflow, inbox_overflow
    (0-dim int32)."""
    r = rois.shape[0]
    n = points_xyz.shape[0]
    k = max_inbox_point
    m = min(max_paired_points, n)
    ex = tuple(float(e) for e in extra_wlh)  # scalars: no copy to the card

    # 1) chunked any-membership pass over all points
    any_in = torch.cat([
        _inside_rois(points_xyz[i:i + chunk], pts_valid[i:i + chunk],
                     pts_batch[i:i + chunk], rois, roi_valid, roi_batch,
                     ex).any(dim=1)
        for i in range(0, n, chunk)])

    # 2) candidates in ascending point order, then the others: JAX's
    # top_k on -index, which has no ties
    _, cand_idx = torch.sort((~any_in).to(torch.uint8), stable=True)
    cand_idx = cand_idx[:m]
    cand_valid = any_in[cand_idx]
    mem_overflow = (any_in.sum(dtype=torch.int32)
                    - cand_valid.sum(dtype=torch.int32))

    # 3) candidate membership + within-roi ranks (column cumsum)
    inside = _inside_rois(points_xyz[cand_idx], cand_valid,
                          pts_batch[cand_idx], rois, roi_valid, roi_batch,
                          ex)  # [M, R]
    # the cumsum runs along rows of the transposed membership: a scan along
    # the outer dim of [M, R] gives each of the R columns one thread on the
    # card, and searchsorted needs the columns contiguous anyway
    csum_t = torch.cumsum(inside.t().contiguous(), dim=1, dtype=torch.int32)
    del inside
    counts = csum_t[:, -1]  # [R] in-roi point counts
    inbox_overflow = torch.clamp(counts - k, min=0).sum(dtype=torch.int32)

    # 4) q-th inside point of roi j = first row where csum[:, j] >= q
    qs = torch.arange(1, k + 1, dtype=torch.int32, device=rois.device)
    pos = torch.searchsorted(csum_t, qs.expand(r, k).contiguous(),
                             side="left")  # [R, K]
    del csum_t
    pv = (qs[None, :] <= counts[:, None]) & roi_valid[:, None]
    idx = torch.where(pv, cand_idx[torch.clamp(pos, max=m - 1)], 0)

    # 13-dim geometry of the selected [R, K] pairs; the empty slots read
    # no point (a gather_rows: they would all send their zero gradients to
    # point 0) and are zeroed below
    pts = gather_rows(points_xyz, torch.where(pv, idx, -1).reshape(-1))
    proi = rois.repeat_interleave(k, dim=0)
    lw, ll, lz = _local_frame(pts, proi)
    w2, l2, h2 = proi[:, 3] / 2, proi[:, 4] / 2, proi[:, 5] / 2
    inside_core = ((torch.abs(lw) <= w2) & (torch.abs(ll) <= l2)
                   & (torch.abs(lz) <= h2))
    geo = torch.stack([ll, lw, lz, l2 - ll, w2 - lw, h2 - lz, l2 + ll,
                       w2 + lw, h2 + lz, (~inside_core).float()], dim=-1)
    geo = torch.cat([geo, pts - proi[:, :3]], dim=-1)
    geo = torch.where(pv.reshape(-1)[:, None], geo, 0.0).reshape(r, k, 13)
    return {"idx": idx.to(torch.int32), "valid": pv, "geo": geo,
            "membership_overflow": mem_overflow,
            "inbox_overflow": inbox_overflow}


def canonical_gt(rois, gts):
    """gt boxes [N, 7] in the canonical frame of their rois [N, 7]: the
    centre offset rotated by the roi's yaw (taken mod 2 pi), the yaw
    difference mod 2 pi with opposite headings flipped, wrapped to
    (-pi, pi] and clipped to [-pi/2, pi/2]."""
    ctr = gts[:, :3] - rois[:, :3]
    roi_ry = rois[:, 6] % (2 * math.pi)
    ang = -(roi_ry + math.pi / 2)
    rot = rotate_2d(ctr[:, :2], -ang)
    ry = (gts[:, 6] - roi_ry) % (2 * math.pi)
    opposite = (ry > math.pi * 0.5) & (ry < math.pi * 1.5)
    ry = torch.where(opposite, (ry + math.pi) % (2 * math.pi), ry)
    ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    ry = torch.clamp(ry, -math.pi / 2, math.pi / 2)
    return torch.cat([rot, ctr[:, 2:3], gts[:, 3:6], ry[:, None]], dim=-1)


def _per_class(values: tuple, labels):
    """``jnp.asarray(values)[minimum(labels, C - 1)]`` for class ids >= 0,
    as float32 ``where``s of Python scalars (no copy to the card)."""
    out = torch.full(labels.shape, values[-1], dtype=torch.float32,
                     device=labels.device)
    for c in range(len(values) - 1):
        out = torch.where(labels == c, values[c], out)
    return out


def decode_rcnn(rois, preds):
    """Inverse of the canonical encode: residuals decoded against the roi at
    the origin (yaw kept), centres rotated by (roi yaw + pi/2) and moved to
    the roi."""
    anchors = rois.clone()
    anchors[:, :3] = 0.0
    local = delta_decode(anchors, preds)
    xy = rotate_2d(local[:, :2], -(rois[:, 6] + math.pi / 2))
    return torch.cat([xy + rois[:, :2], (local[:, 2] + rois[:, 2])[:, None],
                      local[:, 3:]], dim=-1)


class FullySparseBboxHead(nn.Module):
    """SIR² over the pooled points of each roi, then the score and box
    MLPs. ``point_channels`` is the width of a pooled point's row and
    ``feat_channels_in`` that of its features; flax infers both."""

    def __init__(self, point_channels: int, feat_channels_in: int,
                 num_blocks: int = 6,
                 feat_channels: tuple = ((128, 128),) * 6,
                 rel_mlp_hidden: tuple = ((16, 32),) * 6,
                 reg_mlp: tuple = (512, 512), cls_mlp: tuple = (512, 512),
                 xyz_normalizer: tuple = (20.0, 20.0, 4.0),
                 act: str = "gelu", norm: str = "ln", code_size: int = 7,
                 dtype=torch.float32):
        super().__init__()
        self.num_blocks = num_blocks
        c = feat_channels_in
        roi_channels = 0
        for i in range(num_blocks):
            block = SIRLayer(point_channels + c + 13,
                             feat_channels=tuple(feat_channels[i]),
                             rel_mlp_hidden=tuple(rel_mlp_hidden[i]),
                             mode="max", xyz_normalizer=xyz_normalizer,
                             norm=norm, act=act, dtype=dtype)
            self.add_module(f"block_{i}", block)
            c = block.out_channels
            roi_channels += block.cluster_channels
        self.conv_cls = MLP(roi_channels, tuple(cls_mlp) + (1,), act=act,
                            norm=norm, is_head=True, dtype=dtype)
        self.conv_reg = MLP(roi_channels, tuple(reg_mlp) + (code_size,),
                            act=act, norm=norm, is_head=True, dtype=dtype)

    def forward(self, pair_pts, pair_feats, pair_geo, pair_valid,
                num_rois: int, train: bool = False):
        """pair_*: flattened [R*K, ...]; group r = index // K."""
        k = pair_pts.shape[0] // num_rois
        seg_ids = torch.arange(num_rois, dtype=torch.int32,
                               device=pair_pts.device).repeat_interleave(k)
        seg_ids = torch.where(pair_valid, seg_ids, num_rois)
        out_feats = pair_feats
        cluster_list = []
        for i in range(self.num_blocks):
            x = torch.cat([pair_pts, out_feats, pair_geo / 10.0], dim=-1)
            out_feats, cfeat = getattr(self, f"block_{i}")(
                x, pair_geo[:, :3] * 10.0, seg_ids, num_rois, pair_valid,
                train)
            cluster_list.append(cfeat)
        roi_feats = torch.cat(cluster_list, dim=-1)
        nonempty = segment_reduce(pair_valid.float(), seg_ids, num_rois,
                                  "sum") > 0
        cls_score = self.conv_cls(roi_feats, nonempty, train)
        bbox_pred = self.conv_reg(roi_feats, nonempty, train)
        return cls_score[:, 0], bbox_pred, nonempty


def pool_and_refine(head, pts_xyz, pts_feats, pts_valid, pts_group, rois,
                    roi_valid, roi_group, train: bool = False):
    """``dynamic_point_pool`` of the points in each roi of their group, at
    ``head``'s ``extra_wlh``, ``max_inbox_point`` and ``max_paired_points``,
    then ``head.bbox_head_mod`` over the pairs: (cls_score [R], bbox_pred
    [R, 7], nonempty [R], membership_overflow). ``pts_xyz`` rows are the
    pairs' point rows (xyz first)."""
    pool = dynamic_point_pool(
        pts_xyz[:, :3], pts_valid, pts_group, rois, roi_valid, roi_group,
        head.extra_wlh, head.max_inbox_point, head.max_paired_points)
    r, _ = pool["idx"].shape
    pair_valid = pool["valid"].reshape(-1)
    flat_idx = torch.where(pair_valid, pool["idx"].reshape(-1), -1)
    return head.bbox_head_mod(
        gather_rows(pts_xyz, flat_idx), gather_rows(pts_feats, flat_idx),
        pool["geo"].reshape(-1, 13), pair_valid, r,
        train) + (pool["membership_overflow"],)


class GroupCorrectionHead(nn.Module):
    """Assign and sample proposals, pool each one's in-box points and
    refine it with SIR².

    ``sampler``: the IoU-piecewise sampler's ``dict(num, pos_fraction,
    neg_piece_fractions, neg_iou_piece_thrs)``; None keeps every valid
    proposal. ``num_rois`` is read by no layer, as in the JAX module."""

    def __init__(self, point_channels: int, feat_channels_in: int,
                 num_classes: int = 3, extra_wlh: tuple = (0.5, 0.5, 0.5),
                 max_inbox_point: int = 256, max_paired_points: int = 65536,
                 num_rois: int = 256,
                 pos_iou_thr: tuple = (0.45, 0.35, 0.35),
                 cls_pos_thr: tuple = (0.8, 0.65, 0.65),
                 cls_neg_thr: tuple = (0.2, 0.15, 0.15),
                 loss_bbox_weight: float = 2.0, loss_cls_weight: float = 1.0,
                 corner_loss_weight: float = 1.0,
                 corner_loss_only_car: bool = True,
                 sampler: dict | None = None, bbox_head: dict | None = None,
                 dtype=torch.float32):
        super().__init__()
        del num_rois
        self.num_classes = num_classes
        self.extra_wlh = tuple(extra_wlh)
        self.max_inbox_point = max_inbox_point
        self.max_paired_points = max_paired_points
        self.pos_iou_thr = tuple(pos_iou_thr)
        self.cls_pos_thr = tuple(cls_pos_thr)
        self.cls_neg_thr = tuple(cls_neg_thr)
        self.loss_bbox_weight = loss_bbox_weight
        self.loss_cls_weight = loss_cls_weight
        self.corner_loss_weight = corner_loss_weight
        self.corner_loss_only_car = corner_loss_only_car
        self.sampler = None if sampler is None else dict(sampler)
        self.bbox_head_mod = FullySparseBboxHead(
            point_channels, feat_channels_in, dtype=dtype,
            **(bbox_head or {}))

    def pool_and_forward(self, pts_xyz, pts_feats, pts_valid, pts_batch,
                         rois, roi_valid, roi_batch, train: bool = False):
        """(cls_score [R], bbox_pred [R, 7], nonempty [R],
        membership_overflow)."""
        return pool_and_refine(self, pts_xyz, pts_feats, pts_valid,
                               pts_batch, rois, roi_valid, roi_batch, train)

    # -------------------------------------------------------------- training

    def assign_and_sample(self, proposals, prop_labels, prop_valid,
                          prop_batch, gt_boxes, gt_labels, gt_valid):
        """Each proposal's best 3D IoU among the valid gt boxes of its
        sample and class (-1 where there is none), the gt's flat index
        [B * G] (the first best) and whether it reaches its class's
        ``pos_iou_thr``."""
        b, g = gt_boxes.shape[:2]
        gt_flat = gt_boxes.reshape(b * g, -1)
        gt_b = torch.arange(b, dtype=prop_batch.dtype,
                            device=prop_batch.device).repeat_interleave(g)
        iou = boxes_iou_3d(proposals[:, :7], gt_flat[:, :7])  # [P, B*G]
        ok = ((prop_batch[:, None] == gt_b[None, :])
              & (prop_labels[:, None] == gt_labels.reshape(1, -1))
              & gt_valid.reshape(1, -1))
        iou = torch.where(ok, iou, -1.0)
        max_iou, argmax = iou.max(dim=1)
        is_pos = (max_iou >= _per_class(self.pos_iou_thr, prop_labels)) \
            & prop_valid
        return max_iou, argmax, is_pos

    def loss(self, pts_xyz, pts_feats, pts_valid, pts_batch, proposals,
             prop_labels, prop_valid, prop_batch, gt_boxes, gt_labels,
             gt_valid, train: bool = True, generator=None,
             draws=None) -> dict:
        """``loss_rcnn_cls`` (BCE to the IoU's soft label over the sampled
        non-empty proposals), ``loss_rcnn_bbox`` (L1 of the canonical
        residuals) and ``loss_rcnn_corner`` (car only by default) over the
        sampled non-empty positives, ``num_pos_rois`` and
        ``roi_membership_overflow``. ``generator`` / ``draws``: the
        sampler's uniforms (``iou_neg_piecewise_sample``). No host read."""
        max_iou, argmax, is_pos = self.assign_and_sample(
            proposals, prop_labels, prop_valid, prop_batch, gt_boxes,
            gt_labels, gt_valid)
        sampled = prop_valid
        if train and self.sampler is not None:
            sm = self.sampler
            sampled = iou_neg_piecewise_sample(
                max_iou, is_pos, prop_valid, sm["num"], sm["pos_fraction"],
                tuple(sm["neg_piece_fractions"]),
                tuple(sm["neg_iou_piece_thrs"]), generator=generator,
                draws=draws)
        cls_score, bbox_pred, nonempty, mem_overflow = self.pool_and_forward(
            pts_xyz, pts_feats, pts_valid, pts_batch, proposals[:, :7],
            prop_valid, prop_batch, train)
        # soft labels between the class's negative and positive IoUs
        pos_t = _per_class(self.cls_pos_thr, prop_labels)
        neg_t = _per_class(self.cls_neg_thr, prop_labels)
        soft = torch.clamp((max_iou - neg_t) / (pos_t - neg_t), 0.0, 1.0)
        lw = (sampled & nonempty).float()
        loss_cls = L.binary_cross_entropy_loss(
            cls_score, soft, weight=lw,
            avg_factor=torch.clamp(lw.sum(), min=1.0)) * self.loss_cls_weight

        gt_flat = gt_boxes.reshape(-1, gt_boxes.shape[-1])
        matched = gt_flat[argmax]
        # a zero-size padded gt would make delta_encode's log NaN (and
        # 0 * NaN is NaN through the weights): non-positives take a unit box
        unit = torch.zeros_like(matched[0])
        unit[3:6] = 1.0
        matched = torch.where(is_pos[:, None], matched, unit)
        ct = canonical_gt(proposals[:, :7], matched[:, :7])
        anchors = torch.cat([torch.zeros_like(proposals[:, :3]),
                             proposals[:, 3:6],
                             torch.zeros_like(proposals[:, 6:7])], dim=-1)
        targets = delta_encode(anchors, ct)
        rw = (is_pos & sampled & nonempty).float()
        loss_bbox = L.l1_loss(
            bbox_pred, targets, weight=rw,
            avg_factor=torch.clamp(rw.sum(), min=1.0)) * self.loss_bbox_weight

        # corner loss against the gt and its flipped twin
        pred_corners = corners(decode_rcnn(proposals[:, :7], bbox_pred))
        flipped = torch.cat([matched[:, :6], matched[:, 6:7] + math.pi], -1)
        cd = torch.minimum(
            torch.linalg.vector_norm(pred_corners - corners(matched[:, :7]),
                                     dim=-1),
            torch.linalg.vector_norm(pred_corners - corners(flipped), dim=-1))
        huber = torch.where(cd < 1.0, 0.5 * cd**2, cd - 0.5).mean(-1)
        cw = rw
        if self.corner_loss_only_car:
            cw = cw * (gt_labels.reshape(-1)[argmax] == 0).float()
        loss_corner = (huber * cw).sum() / torch.clamp(cw.sum(), min=1.0) \
            * self.corner_loss_weight
        return {
            "loss_rcnn_cls": loss_cls,
            "loss_rcnn_bbox": loss_bbox,
            "loss_rcnn_corner": loss_corner,
            "num_pos_rois": is_pos.sum().float(),
            "roi_membership_overflow": mem_overflow.float(),
        }

    def predict(self, pts_xyz, pts_feats, pts_valid, pts_batch, proposals,
                prop_scores, prop_labels, prop_valid, prop_batch,
                batch_size: int, nms_thr: float = 0.25,
                score_thr: float = 0.1, max_num: int = 500,
                use_rotate_nms: bool = True) -> dict:
        """Refined boxes per sample, padded to [B, min(max_num, R)]: NMS by
        proposal score over the refined boxes; kept rows score the RoI
        head's sigmoid."""
        cls_score, bbox_pred, nonempty, _ = self.pool_and_forward(
            pts_xyz, pts_feats, pts_valid, pts_batch, proposals[:, :7],
            prop_valid, prop_batch, False)
        decoded = decode_rcnn(proposals[:, :7], bbox_pred)
        rcnn_scores = torch.sigmoid(cls_score)
        valid = prop_valid & nonempty
        results = []
        for i in range(batch_size):
            m = valid & (prop_batch == i) & (prop_scores > score_thr)
            idx, sel_valid = topk_presort(prop_scores, m,
                                          min(max_num, decoded.shape[0]))
            keep = nms_bev(decoded[idx], prop_scores[idx], sel_valid,
                           nms_thr, use_rotate_nms)
            results.append({
                "boxes": decoded[idx],
                "scores": torch.where(keep, rcnn_scores[idx], 0.0),
                "labels": prop_labels[idx],
                "valid": keep,
            })
        return {k: torch.stack([r[k] for r in results]) for k in results[0]}
