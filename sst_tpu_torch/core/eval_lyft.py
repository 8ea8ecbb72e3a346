"""Lyft L5 detection metric: class-mean mAP averaged over 3D-IoU
thresholds 0.5:0.05:0.95.

The port's copy of ``sst_tpu/core/eval_lyft.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the reference's mmdet3d/core/evaluation/lyft_eval.py:89
``lyft_eval`` (which drives the lyft_dataset_sdk mAP_evaluation module).
Protocol, matching the devkit exactly on lidar-frame 7-dof boxes:

- predictions and gts grouped per class, then per sample
  (lyft_eval.py:183-195, 213-215);
- predictions sorted by descending score; each is matched greedily to the
  single highest-3D-IoU gt in its sample — if that IoU clears a threshold
  and the gt is unclaimed AT that threshold, TP, else FP
  (lyft_eval.py:229-261; note the devkit picks argmax over ALL gts, taken
  or not, and FPs a duplicate match rather than re-matching);
- per-threshold AP = all-point area under the precision/recall curve with
  the precision envelope (the devkit's ``get_ap``: sentinel-padded,
  monotone-decreasing precision, sum of Δrecall × precision);
- final mAP = mean over classes and the 10 thresholds (lyft_eval.py:117-119).

3D IoU here is rotated-BEV intersection × z-overlap over volume union
(``core/iou.py boxes_iou_3d``, torch on the CPU) where the devkit
intersects shapely ground polygons × height — identical geometry for
upright boxes.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def _ap_from_pr(recalls, precisions):
    """Devkit get_ap: VOC-style all-point AP with the precision envelope."""
    r = np.concatenate(([0.0], recalls, [1.0]))
    p = np.concatenate(([0.0], precisions, [0.0]))
    for i in range(p.size - 1, 0, -1):
        p[i - 1] = max(p[i - 1], p[i])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def _single_class_aps(preds, gts, iou_thresholds):
    """preds: list over samples of (boxes [N,7], scores [N]); gts: list of
    boxes [M,7]. Returns [T] AP per threshold (lyft_eval.py:198-283)."""
    import torch

    from sst_tpu_torch.core.iou import boxes_iou_3d

    num_gts = int(sum(len(g) for g in gts))
    t = len(iou_thresholds)
    rows = []  # (score, sample, jmax, max_iou)
    gt_checked = [np.zeros((len(g), t)) for g in gts]
    for si, (pb, ps) in enumerate(preds):
        for i in range(len(pb)):
            rows.append((float(ps[i]), si, i))
    rows.sort(key=lambda x: -x[0])

    tps = np.zeros((len(rows), t))
    fps = np.zeros((len(rows), t))
    iou_cache = {}
    for ri, (_, si, i) in enumerate(rows):
        gb = gts[si]
        if len(gb) == 0:
            fps[ri] = 1.0
            continue
        if si not in iou_cache:
            iou_cache[si] = boxes_iou_3d(
                torch.from_numpy(np.asarray(preds[si][0], np.float32)),
                torch.from_numpy(np.asarray(gb, np.float32))).numpy()
        overlaps = iou_cache[si][i]
        jmax = int(np.argmax(overlaps))
        max_overlap = overlaps[jmax]
        for ti, thr in enumerate(iou_thresholds):
            if max_overlap > thr:
                if gt_checked[si][jmax, ti] == 0:
                    tps[ri, ti] = 1.0
                    gt_checked[si][jmax, ti] = 1.0
                else:
                    fps[ri, ti] = 1.0
            else:
                fps[ri, ti] = 1.0

    if num_gts == 0 or len(rows) == 0:
        return np.zeros(t)
    fps = np.cumsum(fps, axis=0)
    tps = np.cumsum(tps, axis=0)
    recalls = tps / float(num_gts)
    precisions = tps / np.maximum(tps + fps, np.finfo(np.float64).eps)
    return np.array([
        _ap_from_pr(recalls[:, ti], precisions[:, ti]) for ti in range(t)])


def lyft_eval(predictions, ground_truths, classes,
              iou_thresholds=IOU_THRESHOLDS):
    """predictions[i]: {'boxes': [N,7], 'scores': [N], 'labels': [N]};
    ground_truths[i]: {'boxes': [M,7], 'labels': [M]} — lidar frame.

    Returns {'{cls}_mAP', 'mAPs_per_threshold', 'Final mAP'} with the
    devkit's averaging (lyft_eval.py:113-125).
    """
    aps = np.zeros((len(classes), len(iou_thresholds)))
    for ci in range(len(classes)):
        preds_c, gts_c = [], []
        for pred, gt in zip(predictions, ground_truths):
            pm = np.asarray(pred["labels"]) == ci
            gm = np.asarray(gt["labels"]) == ci
            preds_c.append((np.asarray(pred["boxes"], np.float32)[pm],
                            np.asarray(pred["scores"], np.float32)[pm]))
            gts_c.append(np.asarray(gt["boxes"], np.float32)[gm])
        aps[ci] = _single_class_aps(preds_c, gts_c, iou_thresholds)

    out = {f"{c}_mAP": round(float(aps[ci].mean()), 4)
           for ci, c in enumerate(classes)}
    out["mAPs_per_threshold"] = [round(float(v), 4) for v in aps.mean(0)]
    out["Final mAP"] = round(float(aps.mean()), 4)
    return out
