"""Greedy rotated / nearest BEV NMS with static output shapes (counterpart
of ``sst_tpu/core/nms.py``: ``nms_bev``, CenterPoint's ``circle_nms``, the
axis-aligned ``aligned_3d_nms``, the weighted NMS and both multiclass
paths).

Candidates are score-sorted and statically capped; the [K, K] IoU matrix is
computed once and greedy suppression is solved as a fixed point (see
:func:`_suppress_fixpoint`). Top-k selections use a stable descending sort so
that ties keep ``jax.lax.top_k``'s order.
"""

from __future__ import annotations

import torch

from portbench.ref.core.iou import boxes_iou_bev, nearest_iou
from portbench.ref.ops.ccl import stable_topk


def _suppress_fixpoint(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy suppression by Jacobi fixed-point iteration.

    ``sup[..., i, j]``: box i, if kept, suppresses box j (strictly upper
    triangular; rows are score-descending). The greedy sweep solves
    ``keep[j] = valid[j] & ~any_{i<j}(keep[i] & sup[i, j])``; iterating the
    update from ``keep = valid`` reaches its unique solution in (longest
    suppression chain + 1) rounds. Leading dims are batched."""
    k = sup.shape[-1]
    supf = sup.float()
    keep = valid
    for _ in range(k + 1):
        dead = (keep.float()[..., None, :] @ supf)[..., 0, :] > 0.5
        new = valid & ~dead
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     thr: float) -> torch.Tensor:
    """Greedy NMS keep-mask over score-descending sets [..., K]."""
    k = iou.shape[-1]
    later = torch.arange(k, device=iou.device)
    sup = (iou > thr) & (later[:, None] < later[None, :]) & valid[..., :, None]
    return _suppress_fixpoint(sup, valid)


def _pairwise_chunked(fn, boxes: torch.Tensor, chunk: int) -> torch.Tensor:
    """[K, K] pairwise matrix computed over row chunks, which bounds the
    live polygon-clipping intermediates to chunk * K."""
    return torch.cat([fn(boxes[i:i + chunk], boxes)
                      for i in range(0, boxes.shape[0], chunk)])


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
            thr: float, use_rotate_nms: bool = True,
            chunk: int = 256) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes [K, 7+]; returns the keep mask
    [K]. The caller passes the boxes sorted by descending score, padding
    rows masked by ``valid`` (:func:`topk_presort`); ``scores`` is not
    read, as in the JAX package. ``use_rotate_nms`` picks the rotated BEV
    IoU, else the axis-aligned one of the nearest-90-degree boxes."""
    fn = boxes_iou_bev if use_rotate_nms else nearest_iou
    iou = _pairwise_chunked(fn, boxes[:, :7], chunk)
    return _greedy_suppress(iou, valid, thr)


def _greedy_suppress_mask(sup_mat: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Greedy sweep where ``sup_mat[i, j]`` means "i suppresses j"."""
    k = sup_mat.shape[-1]
    later = torch.arange(k, device=sup_mat.device)
    sup = sup_mat & (later[:, None] < later[None, :]) & valid[..., :, None]
    return _suppress_fixpoint(sup, valid)


def circle_nms(centers: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """CenterPoint's circular NMS: a centre is suppressed where a kept
    centre of higher score lies within BEV distance sqrt(``thresh``).
    Inputs score-sorted descending; returns the keep mask. ``scores`` is
    not read, as in the JAX package."""
    d2 = ((centers[:, None, :2] - centers[None, :, :2]) ** 2).sum(-1)
    return _greedy_suppress_mask(d2 <= thresh, valid)


def aligned_3d_nms(boxes_xyzxyz: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, valid: torch.Tensor,
                   thresh: float) -> torch.Tensor:
    """Axis-aligned 3D NMS, class-gated: a box is suppressed by a kept box
    of higher score and the same class whose 3D IoU exceeds ``thresh``.
    Boxes [K, 6] (x1, y1, z1, x2, y2, z2), score-sorted descending;
    ``scores`` is not read, as in the JAX package. Returns the keep mask."""
    lt = torch.maximum(boxes_xyzxyz[:, None, :3], boxes_xyzxyz[None, :, :3])
    rb = torch.minimum(boxes_xyzxyz[:, None, 3:], boxes_xyzxyz[None, :, 3:])
    inter = torch.clamp(rb - lt, min=0.0).prod(-1)
    vol = (boxes_xyzxyz[:, 3:] - boxes_xyzxyz[:, :3]).prod(-1)
    iou = inter / torch.clamp(vol[:, None] + vol[None, :] - inter, min=1e-6)
    iou = iou * (classes[:, None] == classes[None, :])
    return _greedy_suppress_mask(iou > thresh, valid)


def weighted_nms_bev(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, thr_lo: float, thr_hi: float,
                     use_rotate_nms: bool = True, chunk: int = 256):
    """Weighted NMS (RangeDet's ``wnms_4c``) over score-sorted boxes
    [K, 7]: greedy suppression at IoU > ``thr_lo``; each kept box becomes
    the score-weighted mean of every valid candidate with IoU > ``thr_hi``
    (itself included): centre and dims directly, yaw through its sine and
    cosine; its score the same weighted mean of the members' scores.
    Returns (boxes [K, 7], scores [K], keep [K])."""
    fn = boxes_iou_bev if use_rotate_nms else nearest_iou
    iou = _pairwise_chunked(fn, boxes, chunk)
    keep = _greedy_suppress(iou, valid, thr_lo)
    k = iou.shape[0]
    member = ((iou > thr_hi) & valid[None, :]) | torch.eye(
        k, dtype=torch.bool, device=iou.device)
    w = member.to(scores.dtype) * torch.clamp(scores, min=1e-6)[None, :]
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    lin = torch.cat([boxes[:, :6], torch.sin(boxes[:, 6:7]),
                     torch.cos(boxes[:, 6:7])], dim=-1)
    # JAX promotes a bfloat16 weight against the float32 boxes
    wide = torch.promote_types(w.dtype, lin.dtype)
    merged = (w.to(wide) @ lin.to(wide)) / wsum.to(wide)
    yaw = torch.atan2(merged[:, 6], merged[:, 7])
    out = torch.cat([merged[:, :6], yaw[:, None]], dim=-1)
    out = torch.where(keep[:, None], out, boxes[:, :7])
    mscores = (w @ scores) / wsum[:, 0]
    return out, torch.where(keep, mscores, scores), keep


def topk_presort(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k indices by score among valid rows (padding scores → -inf)."""
    top, idx = stable_topk(torch.where(valid, scores, -torch.inf), k)
    return idx, torch.isfinite(top)


def multiclass_nms_preselected(cand_boxes, cand_scores, sels, nms_thr: float,
                               max_num: int, use_rotate_nms: bool = True):
    """NMS over per-class preselected candidates.

    Args: cand_boxes [C, K, D] score-descending per class; cand_scores
    [C, K]; sels [C, K] bool. Returns the padded [max_num] result dict."""
    c, k, _ = cand_boxes.shape
    fn = boxes_iou_bev if use_rotate_nms else nearest_iou
    iou = torch.stack([_pairwise_chunked(fn, b[:, :7], 256)
                       for b in cand_boxes])
    keep = _greedy_suppress(iou, sels, nms_thr)
    all_boxes = cand_boxes.reshape(c * k, -1)
    all_scores = torch.where(keep, cand_scores, -torch.inf).reshape(c * k)
    all_labels = torch.arange(c, dtype=torch.int32,
                              device=cand_boxes.device).repeat_interleave(k)
    return _top_results(all_boxes, all_scores, all_labels,
                        keep.reshape(c * k), max_num)


def _top_results(all_boxes, all_scores, all_labels, all_valid,
                 max_num: int) -> dict:
    """The global top ``max_num`` of per-class results (suppressed rows
    scored -inf), padded."""
    top_scores, top_idx = stable_topk(all_scores, max_num)
    finite = torch.isfinite(top_scores)
    return {
        "boxes": all_boxes[top_idx],
        "scores": torch.where(finite, top_scores, 0.0),
        "labels": all_labels[top_idx],
        "valid": all_valid[top_idx] & finite,
    }


def box3d_multiclass_nms(boxes, scores, valid, num_classes: int,
                         score_thr: float, nms_thr: float, nms_pre: int,
                         max_num: int, use_rotate_nms: bool = True,
                         use_wnms: bool = False, wnms_thr_lo: float = 0.1,
                         wnms_thr_hi: float = 0.7):
    """Per-class NMS with a static output size.

    Args:
      boxes: [N, 7+] decoded boxes (shared across classes).
      scores: [N, num_classes] sigmoid class scores (no background column).
      valid: [N] bool.
      use_wnms: per class, :func:`weighted_nms_bev` at (``wnms_thr_lo``,
        ``wnms_thr_hi``) over its top ``nms_pre`` in place of greedy NMS at
        ``nms_thr``; the merged boxes and scores are returned.

    Returns a dict of padded [max_num] results: boxes, scores, labels, valid.
    """
    k = min(nms_pre, boxes.shape[0])
    if use_wnms:
        out_boxes, out_scores, out_labels, out_valid = [], [], [], []
        for c in range(num_classes):
            s = scores[:, c]
            idx, sel_valid = topk_presort(s, valid & (s > score_thr), k)
            cand_boxes = boxes[idx]
            cand7, cand_scores, keep = weighted_nms_bev(
                cand_boxes[:, :7], s[idx], sel_valid, wnms_thr_lo,
                wnms_thr_hi, use_rotate_nms)
            out_boxes.append(torch.cat([cand7, cand_boxes[:, 7:]], dim=-1))
            out_scores.append(torch.where(keep, cand_scores, -torch.inf))
            out_labels.append(torch.full_like(idx, c, dtype=torch.int32))
            out_valid.append(keep)
        return _top_results(torch.cat(out_boxes), torch.cat(out_scores),
                            torch.cat(out_labels), torch.cat(out_valid),
                            max_num)
    sel = [topk_presort(scores[:, c], valid & (scores[:, c] > score_thr), k)
           for c in range(num_classes)]
    idxs = torch.stack([s[0] for s in sel])  # [C, K]
    sels = torch.stack([s[1] for s in sel])
    cand_boxes = boxes[idxs]  # [C, K, D]
    cand_scores = torch.gather(scores.t(), 1, idxs)
    return multiclass_nms_preselected(cand_boxes, cand_scores, sels, nms_thr,
                                      max_num, use_rotate_nms)
