"""Official-protocol KITTI 3D/BEV evaluation (easy/moderate/hard, R40).

The port's copy of ``sst_tpu/core/eval_kitti.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the reference's numba protocol
(mmdet3d/core/evaluation/kitti_utils/eval.py): same difficulty definitions
(2D-bbox min height / max occlusion / max truncation), same neighboring-class
ignore semantics (Van for Car, Person_sitting for Pedestrian), same R40
recall-sampled threshold selection (get_thresholds, eval.py:8-25), camera
frame BEV/3D overlaps — redesigned around one vectorized IoU matrix per
image (core/evaluation.rotated_iou_matrix) instead of numba kernels, with
score-greedy matching replacing the per-threshold gt-major loops (the one
documented deviation; identical on NMS'd detections in practice).

Anno dicts are KITTI format per image: name, truncated, occluded,
bbox [N, 4], dimensions [N, 3] (l, h, w), location [N, 3] (camera),
rotation_y [N]; detections additionally carry score [N].
"""

from __future__ import annotations

import numpy as np

from sst_tpu_torch.core.evaluation import greedy_match, rotated_iou_matrix

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist")
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
DIFFICULTY_NAMES = ("easy", "moderate", "hard")
# strict min_overlap row of eval.py:666 (Car 0.7, Ped/Cyc 0.5)
DEFAULT_MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# neighboring classes scored as "ignore", not FP (clean_data, eval.py:43-51)
SIMILAR = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}


def _pseudo_boxes(anno):
    """Camera-frame KITTI annos → 7-dof rows for rotated_iou_matrix.

    Footprint lives in the camera x-z plane ((l, w) at ry=0 along (x, z));
    vertical extent converted to bottom+height in a +up axis (camera y points
    down, the box origin sits at the bottom face). The rotation sense flip
    between conventions is a global reflection, which leaves IoU invariant.
    """
    loc = np.asarray(anno["location"], np.float64).reshape(-1, 3)
    dim = np.asarray(anno["dimensions"], np.float64).reshape(-1, 3)  # l, h, w
    ry = np.asarray(anno["rotation_y"], np.float64).reshape(-1)
    out = np.zeros((len(ry), 7))
    out[:, 0] = loc[:, 0]  # x
    out[:, 1] = loc[:, 2]  # z
    out[:, 2] = -loc[:, 1]  # bottom in +up coords
    out[:, 3] = dim[:, 0]  # l in the w slot: along x at yaw 0
    out[:, 4] = dim[:, 2]  # w in the l slot: along z at yaw 0
    out[:, 5] = dim[:, 1]  # h
    out[:, 6] = ry
    return out


def _clean(gt, dt, cls, difficulty):
    """Difficulty/ignore flags (clean_data, eval.py:28-80).

    gt flag: 0 counted, 1 ignored (similar class or out-of-difficulty), -1
    skip. det flag: 0 valid, 1 ignored (too small in image), -1 other class.
    """
    names_g = np.asarray(gt["name"]).reshape(-1)
    num_gt = len(names_g)
    bbox = np.asarray(gt.get("bbox", np.zeros((num_gt, 4)))).reshape(-1, 4)
    height = bbox[:, 3] - bbox[:, 1]
    occl = np.asarray(gt.get("occluded", np.zeros(num_gt))).reshape(-1)
    trunc = np.asarray(gt.get("truncated", np.zeros(num_gt))).reshape(-1)

    same = np.char.lower(names_g.astype(str)) == cls.lower()
    similar = np.isin(
        np.char.lower(names_g.astype(str)),
        [s.lower() for s in SIMILAR.get(cls, ())])
    hard = ((occl > MAX_OCCLUSION[difficulty])
            | (trunc > MAX_TRUNCATION[difficulty])
            | (height <= MIN_HEIGHT[difficulty]))
    gt_flag = np.full(num_gt, -1, np.int32)
    gt_flag[same & ~hard] = 0
    gt_flag[similar | (same & hard)] = 1

    names_d = np.asarray(dt["name"]).reshape(-1)
    num_dt = len(names_d)
    dbox = np.asarray(dt.get("bbox", np.zeros((num_dt, 4)))).reshape(-1, 4)
    dheight = np.abs(dbox[:, 3] - dbox[:, 1]) if len(dbox) else np.zeros(0)
    d_same = np.char.lower(names_d.astype(str)) == cls.lower()
    dt_flag = np.full(num_dt, -1, np.int32)
    dt_flag[d_same] = 0
    if len(dbox) and dbox.any():
        dt_flag[dheight < MIN_HEIGHT[difficulty]] = 1
    return gt_flag, dt_flag


def get_thresholds(scores, num_gt, num_sample_pts: int = 41):
    """R40 recall-sampled score thresholds (eval.py:8-25 semantics)."""
    scores = np.sort(np.asarray(scores))[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(float(score))
        current_recall += 1.0 / (num_sample_pts - 1)
    return thresholds


def _match_image(iou, scores, gt_flag, dt_flag, min_overlap):
    """Score-greedy matching over one image's precomputed IoU matrix.

    Returns (tp_scores, fp_scores): det scores that are true positives
    (matched a counted gt) and false-positive candidates (valid class, not
    size-ignored, unmatched or matched nothing). Dets matched to ignored gts
    contribute to neither.
    """
    order = np.argsort(-scores, kind="stable")
    order = order[dt_flag[order] != -1]  # other-class dets never participate
    match = greedy_match(iou, order, min_overlap, gt_eligible=gt_flag != -1)
    matched = match >= 0
    mj = np.maximum(match, 0)
    counted_det = dt_flag == 0
    # matches to ignored gts / by ignored dets: neither tp nor fp
    tp = matched & counted_det & (gt_flag[mj] == 0 if len(gt_flag)
                                  else False)
    fp = ~matched & counted_det & (dt_flag != -1)
    return scores[tp], scores[fp]


def kitti_eval(gt_annos, dt_annos, classes=CLASS_NAMES,
               eval_types=("bev", "3d"), min_overlaps=None,
               num_sample_pts: int = 41):
    """Returns {'{cls}_{metric}_{difficulty}_R40': AP%} + per-metric
    'mAP_{metric}_{difficulty}_R40' means, matching the reference's
    kitti_eval output values (eval.py:707-795)."""
    assert len(gt_annos) == len(dt_annos)
    min_overlaps = dict(DEFAULT_MIN_OVERLAP, **(min_overlaps or {}))
    out = {}

    # precompute per-image pseudo boxes once
    gt_boxes = [_pseudo_boxes(g) if len(np.asarray(g["name"]).reshape(-1))
                else np.zeros((0, 7)) for g in gt_annos]
    dt_boxes = [_pseudo_boxes(d) if len(np.asarray(d["name"]).reshape(-1))
                else np.zeros((0, 7)) for d in dt_annos]

    for metric in eval_types:
        mode = "bev" if metric == "bev" else "3d"
        ious = [rotated_iou_matrix(db, gb, mode=mode)
                for db, gb in zip(dt_boxes, gt_boxes)]
        for cls in classes:
            thr = min_overlaps.get(cls, 0.5)
            for diff in range(3):
                flags = [_clean(g, d, cls, diff)
                         for g, d in zip(gt_annos, dt_annos)]
                num_valid_gt = sum(int((gf == 0).sum()) for gf, _ in flags)
                per_img = []
                for (gf, df), iou, dt in zip(flags, ious, dt_annos):
                    sc = np.asarray(dt.get("score", np.zeros(0))).reshape(-1)
                    per_img.append(_match_image(iou, sc, gf, df, thr))
                if num_valid_gt == 0:
                    key = f"{cls}_{metric}_{DIFFICULTY_NAMES[diff]}_R40"
                    out[key] = 0.0
                    continue
                tp_all = np.concatenate([t for t, _ in per_img]) \
                    if per_img else np.zeros(0)
                fp_all = np.concatenate([f for _, f in per_img]) \
                    if per_img else np.zeros(0)
                thresholds = get_thresholds(tp_all, num_valid_gt,
                                            num_sample_pts)
                precisions = np.zeros(num_sample_pts)
                for k, t in enumerate(thresholds):
                    tp = int((tp_all >= t).sum())
                    fp = int((fp_all >= t).sum())
                    precisions[k] = tp / max(tp + fp, 1)
                # official R40: mean of samples 1..40 of the monotone
                # precision envelope
                precisions = np.maximum.accumulate(precisions[::-1])[::-1]
                ap = float(precisions[1:].sum() / (num_sample_pts - 1)) * 100
                key = f"{cls}_{metric}_{DIFFICULTY_NAMES[diff]}_R40"
                out[key] = round(ap, 4)
        for diff in DIFFICULTY_NAMES:
            vals = [out[f"{c}_{metric}_{diff}_R40"] for c in classes]
            out[f"mAP_{metric}_{diff}_R40"] = round(float(np.mean(vals)), 4)
    return out
