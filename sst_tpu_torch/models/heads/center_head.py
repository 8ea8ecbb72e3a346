"""CenterHead, CenterPoint's heatmap head over BEV maps (counterpart of
``sst_tpu/models/heads/center_head.py``): the shared conv and one
``SeparateHead`` per task, the dense heatmap targets, the loss, and the
decode (3x3 max-pool peaks, top-k, rotated or circle NMS).

Submodules keep flax's names (``shared_conv``, ``task_{t}``,
``{name}_conv{i}``, ``{name}_out``), so ``convert.py`` maps a flax tree
onto them by name. The convolutions run on NCHW maps; the predictions are
returned as [B, H, W, C] views (channels last), the JAX layout.

Jitted XLA divides by a constant as the product with its float32
reciprocal, and the JAX head's targets and decode are jitted: the port
multiplies by those reciprocals (``ops/voxelize.py f32_reciprocal``) so
that a centre on a pixel edge lands in the same pixel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sst_tpu_torch.core.nms import (
    box3d_multiclass_nms,
    circle_nms,
    topk_presort,
)
from sst_tpu_torch.models.layers import Conv, ConvNormAct
from sst_tpu_torch.ops.ccl import stable_topk
from sst_tpu_torch.ops.voxelize import f32_reciprocal


def gaussian_radius(box_wl, min_overlap: float = 0.1):
    """CornerNet's radius for boxes [..., (w, l)] in pixels. Each of the
    three roots is divided by 2, not by 2a: the historical quirk that the
    reference and the published models keep."""
    w, l = box_wl[..., 0], box_wl[..., 1]
    b1 = l + w
    c1 = w * l * (1 - min_overlap) * f32_reciprocal(1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    a2 = 4.0
    b2 = 2 * (l + w)
    c2 = (1 - min_overlap) * w * l
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (l + w)
    c3 = (min_overlap - 1) * w * l
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def gaussian_focal_loss(pred_sigmoid, gt_heatmap, pos_mask, alpha=2.0,
                        gamma=4.0):
    """CenterNet's penalty-reduced focal loss, elementwise."""
    eps = 1e-6
    pos = -torch.log(pred_sigmoid + eps) * (1 - pred_sigmoid) ** alpha \
        * pos_mask
    neg = (-torch.log(1 - pred_sigmoid + eps) * pred_sigmoid ** alpha
           * (1 - gt_heatmap) ** gamma * (1 - pos_mask))
    return pos + neg


class SeparateHead(nn.Module):
    """One conv branch per attribute: ``heads`` is ((name, out_channels,
    num_convs), ...); ``num_convs - 1`` ConvNormAct, then a 3x3 conv with
    bias (the heatmap's initialised to ``init_bias``)."""

    def __init__(self, in_channels: int, heads: tuple, head_conv: int = 64,
                 init_bias: float = -2.19, dtype=torch.float32):
        super().__init__()
        self.heads = tuple(heads)
        self.init_bias = init_bias
        for name, out_ch, num_convs in self.heads:
            c = in_channels
            for i in range(num_convs - 1):
                self.add_module(f"{name}_conv{i}", ConvNormAct(
                    c, head_conv, 3, dtype=dtype))
                c = head_conv
            conv = Conv(c, out_ch, 3, padding=1, bias=True, dtype=dtype)
            with torch.no_grad():
                conv.bias.fill_(init_bias if name == "heatmap" else 0.0)
            self.add_module(f"{name}_out", conv)

    def forward(self, x, train: bool = False):
        out = {}
        for name, _, num_convs in self.heads:
            h = x
            for i in range(num_convs - 1):
                h = getattr(self, f"{name}_conv{i}")(h, train)
            out[name] = getattr(self, f"{name}_out")(h)
        return out


class CenterHead(nn.Module):
    def __init__(self, tasks: tuple = (("Car",), ("Pedestrian",),
                                       ("Cyclist",)),
                 class_names: tuple = ("Car", "Pedestrian", "Cyclist"),
                 in_channels: int = 384, share_conv_channel: int = 64,
                 head_conv: int = 64,
                 common_heads: tuple = (("reg", 2, 2), ("height", 1, 2),
                                        ("dim", 3, 2), ("rot", 2, 2)),
                 with_velocity: bool = False,
                 point_cloud_range: tuple = (-74.88, -74.88, -2.0, 74.88,
                                             74.88, 4.0),
                 voxel_size: tuple = (0.32, 0.32, 6.0),
                 out_size_factor: int = 1, max_objs: int = 500,
                 gaussian_overlap: float = 0.1, min_radius: float = 2.0,
                 loss_cls_weight: float = 1.0,
                 loss_bbox_weight: float = 0.25,
                 code_weights: tuple = (1.0,) * 8, norm_bbox: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.tasks = tuple(tuple(t) for t in tasks)
        self.class_names = tuple(class_names)
        self.with_velocity = with_velocity
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.out_size_factor = out_size_factor
        self.max_objs = max_objs
        self.gaussian_overlap = gaussian_overlap
        self.min_radius = min_radius
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.code_weights = tuple(code_weights)
        self.norm_bbox = norm_bbox
        self.shared_conv = ConvNormAct(in_channels, share_conv_channel, 3,
                                       dtype=dtype)
        for t, names in enumerate(self.tasks):
            heads = tuple(common_heads) + (("heatmap", len(names), 2),)
            if with_velocity:
                heads = heads + (("vel", 2, 2),)
            self.add_module(f"task_{t}", SeparateHead(
                share_conv_channel, heads, head_conv, dtype=dtype))

    @property
    def stride(self) -> float:
        return self.voxel_size[0] * self.out_size_factor

    def forward(self, bev, train: bool = False):
        """bev: [B, C, H, W] -> per task a dict of [B, H, W, *]."""
        x = self.shared_conv(bev, train)
        return [{k: v.permute(0, 2, 3, 1) for k, v in
                 getattr(self, f"task_{t}")(x, train).items()}
                for t in range(len(self.tasks))]

    # ------------------------------------------------------------- targets

    def _grid(self, shape, device):
        h, w = shape
        vs, pcr = self.voxel_size, self.point_cloud_range
        ar = torch.arange(max(h, w), dtype=torch.float32, device=device)
        xs = (ar[:w] + 0.5) * vs[0] * self.out_size_factor + pcr[0]
        ys = (ar[:h] + 0.5) * vs[1] * self.out_size_factor + pcr[1]
        return xs, ys

    def _pixel(self, coord, lo: float):
        """The float pixel coordinate (coord - lo) / stride."""
        return (coord - lo) * f32_reciprocal(self.stride)

    def heatmap_targets(self, shape, gt_boxes, gt_labels, gt_valid,
                        task_id: int):
        """The dense per-pixel maximum of the task's gt gaussians
        [B, H, W, C_task], and the mask of each gt's centre pixel (the
        focal loss's positives), the same shape."""
        ids = [self.class_names.index(n) for n in self.tasks[task_id]]
        h, w = shape
        xs, ys = self._grid(shape, gt_boxes.device)
        stride = self.stride
        r = gaussian_radius(gt_boxes[..., [3, 4]] * f32_reciprocal(stride),
                            self.gaussian_overlap)
        # int truncation before max(min_radius), sigma = diameter / 6
        r = torch.clamp(torch.floor(r), min=self.min_radius)
        sigma = (2 * r + 1) * f32_reciprocal(6.0) * stride  # [B, G]
        cx, cy = gt_boxes[..., 0], gt_boxes[..., 1]
        pcr = self.point_cloud_range
        px = torch.clamp(torch.floor(self._pixel(cx, pcr[0])), 0, w - 1)
        py = torch.clamp(torch.floor(self._pixel(cy, pcr[1])), 0, h - 1)
        d2 = ((xs[None, None, None, :] - cx[..., None, None]) ** 2
              + (ys[None, None, :, None] - cy[..., None, None]) ** 2)
        gauss = torch.exp(-d2 / (2 * sigma[..., None, None] ** 2))
        ix = torch.arange(w, device=gt_boxes.device)[None, None, None, :]
        iy = torch.arange(h, device=gt_boxes.device)[None, None, :, None]
        is_ctr = (ix == px[..., None, None]) & (iy == py[..., None, None])
        maps, poss = [], []
        for ci in ids:
            m = (gt_valid & (gt_labels == ci))[..., None, None]
            maps.append(torch.where(m, gauss, 0.0).amax(dim=1))
            poss.append((m & is_ctr).any(dim=1))
        return torch.stack(maps, -1), torch.stack(poss, -1)

    def loss(self, outs, gt_boxes, gt_labels, gt_valid) -> dict:
        """Per task the focal heatmap loss over the dense targets and the
        L1 box loss at the gt centre pixels (``loss_heatmap.task{t}``,
        ``loss_bbox.task{t}``)."""
        losses = {}
        pcr = self.point_cloud_range
        for t, names in enumerate(self.tasks):
            ids = torch.tensor([self.class_names.index(n) for n in names],
                               dtype=gt_labels.dtype,
                               device=gt_labels.device)
            pred = outs[t]
            b, h, w, _ = pred["heatmap"].shape
            hm_t, pos_t = self.heatmap_targets((h, w), gt_boxes, gt_labels,
                                               gt_valid, t)
            hm_p = torch.sigmoid(pred["heatmap"].float())
            num_pos = torch.clamp(pos_t.sum().float(), min=1.0)
            losses[f"loss_heatmap.task{t}"] = (
                gaussian_focal_loss(hm_p, hm_t, pos_t.float()).sum()
                / num_pos * self.loss_cls_weight)
            task_gt = gt_valid & torch.isin(gt_labels, ids)
            px = torch.floor(self._pixel(gt_boxes[..., 0], pcr[0]))
            py = torch.floor(self._pixel(gt_boxes[..., 1], pcr[1]))
            inb = (px >= 0) & (px < w) & (py >= 0) & (py < h) & task_gt
            pxc = torch.clamp(px, 0, w - 1).long()
            pyc = torch.clamp(py, 0, h - 1).long()
            bi = torch.arange(b, device=pxc.device)[:, None]

            def gather_at(maps):  # [B, H, W, C] -> [B, G, C]
                return maps.float()[bi, pyc, pxc]

            preds = [gather_at(pred[k]) for k in ("reg", "height", "dim",
                                                  "rot")]
            xs_t = self._pixel(gt_boxes[..., 0], pcr[0]) - (pxc + 0.5)
            ys_t = self._pixel(gt_boxes[..., 1], pcr[1]) - (pyc + 0.5)
            dims = gt_boxes[..., 3:6]
            dim_t = torch.log(torch.clamp(dims, min=1e-3)) \
                if self.norm_bbox else dims
            tgts = [torch.stack([xs_t, ys_t], -1),
                    gt_boxes[..., 2:3] + gt_boxes[..., 5:6] / 2,
                    dim_t,
                    torch.stack([torch.sin(gt_boxes[..., 6]),
                                 torch.cos(gt_boxes[..., 6])], -1)]
            if self.with_velocity:
                preds.append(gather_at(pred["vel"]))
                tgts.append(gt_boxes[..., 7:9])
            pred_cat = torch.cat(preds, -1)
            tgt_cat = torch.cat(tgts, -1)
            cw = torch.tensor(self.code_weights[:pred_cat.shape[-1]],
                              device=pred_cat.device)
            nb = torch.clamp(inb.sum().float(), min=1.0)
            lb = (torch.abs(pred_cat - tgt_cat) * cw
                  * inb[..., None]).sum() / nb
            losses[f"loss_bbox.task{t}"] = lb * self.loss_bbox_weight
        return losses

    # ------------------------------------------------------------- decode

    def get_bboxes(self, outs, nms_pre: int = 1024, score_thr: float = 0.1,
                   nms_thr: float = 0.25, max_num: int = 500,
                   use_rotate_nms: bool = True, use_circle_nms: bool = False,
                   circle_thresh: float = 4.0) -> dict:
        """Per task the heatmap peaks that survive a 3x3 max pool, the top
        ``nms_pre`` over H * W * C, decoded; then per sample the classes'
        rotated NMS or one circle NMS. Returns a dict of [B, max_num]
        boxes, scores, labels and valid."""
        all_boxes, all_scores, all_valid = [], [], []
        stride = self.stride
        pcr = self.point_cloud_range
        ncls = len(self.class_names)
        for t, names in enumerate(self.tasks):
            ids = torch.tensor([self.class_names.index(n) for n in names],
                               dtype=torch.int64,
                               device=outs[t]["heatmap"].device)
            pred = outs[t]
            hm = torch.sigmoid(pred["heatmap"].float())
            b, h, w, c = hm.shape
            # the max pool pads with -inf, as XLA's SAME reduce_window
            pooled = F.max_pool2d(hm.permute(0, 3, 1, 2), 3, stride=1,
                                  padding=1).permute(0, 2, 3, 1)
            hm = torch.where(hm == pooled, hm, 0.0)
            scores, inds = stable_topk(hm.reshape(b, h * w * c), nms_pre)
            cls = inds % c
            pix = inds // c
            xi, yi = pix % w, pix // w
            bi = torch.arange(b, device=hm.device)[:, None]

            def dec(key):
                return pred[key].float()[bi, yi, xi]

            reg, dim, rot = dec("reg"), dec("dim"), dec("rot")
            hgt = dec("height")[..., 0]
            x = (xi + 0.5 + reg[..., 0]) * stride + pcr[0]
            y = (yi + 0.5 + reg[..., 1]) * stride + pcr[1]
            dims = torch.exp(dim) if self.norm_bbox else dim
            yaw = torch.atan2(rot[..., 0], rot[..., 1])
            z = hgt - dims[..., 2] / 2  # back to the bottom centre
            boxes = torch.cat([torch.stack([x, y, z], -1), dims,
                               yaw[..., None]], -1)
            if self.with_velocity:
                boxes = torch.cat([boxes, dec("vel")], -1)
            glb = ids[cls]
            all_boxes.append(boxes)
            all_scores.append(F.one_hot(glb, ncls).float()
                              * scores[..., None])
            all_valid.append(scores > score_thr)
        boxes = torch.cat(all_boxes, dim=1)
        scores = torch.cat(all_scores, dim=1)
        valid = torch.cat(all_valid, dim=1)
        k = min(nms_pre, boxes.shape[1])

        results = []
        for i in range(boxes.shape[0]):
            if use_circle_nms:
                best_all, lbl_all = scores[i].max(-1)
                order, sv = topk_presort(best_all, valid[i], k)
                bsorted = boxes[i][order]
                best, lbl = best_all[order], lbl_all[order]
                keep = circle_nms(bsorted[:, :2], best, sv, circle_thresh)
                top, ti = stable_topk(torch.where(keep, best, -torch.inf),
                                      max_num)
                finite = torch.isfinite(top)
                results.append({"boxes": bsorted[ti],
                                "scores": torch.where(finite, top, 0.0),
                                "labels": lbl[ti].to(torch.int32),
                                "valid": finite})
            else:
                results.append(box3d_multiclass_nms(
                    boxes[i], scores[i], valid[i], num_classes=ncls,
                    score_thr=score_thr, nms_thr=nms_thr, nms_pre=k,
                    max_num=max_num, use_rotate_nms=use_rotate_nms))
        return {key: torch.stack([r[key] for r in results])
                for key in results[0]}
