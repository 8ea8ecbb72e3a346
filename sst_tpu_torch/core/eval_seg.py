"""Point-cloud semantic-segmentation metrics (the port's copy of
``sst_tpu/core/eval_seg.py``): per-class IoU, mIoU, overall and
class-mean accuracy.

Counterpart of the reference's mmdet3d/core/evaluation/seg_eval.py:69
(confusion-matrix protocol): gt labels equal to ``ignore_index`` are
remapped to -1 on BOTH gt and pred (so they fall outside the valid bincount
range), the per-frame confusion matrices are summed, and

  iou[c]  = diag / (row-sum + col-sum - diag)        (seg_eval.py:38)
  miou    = nanmean(iou)                             (classes never seen = nan)
  acc     = sum(diag) / sum(hist)
  acc_cls = nanmean(diag / row-sum)

Used by the VoteSegmentor / seg-pretrain configs
(configs/argo2/argo_segmentation_pretrain.py) to report seg quality beyond
loss values.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(preds, labels, num_classes: int) -> np.ndarray:
    """[C, C] confusion matrix, rows = gt, cols = pred; entries with gt or
    pred outside [0, C) are dropped (seg_eval.py:6 fast_hist)."""
    preds = np.asarray(preds).reshape(-1).astype(np.int64)
    labels = np.asarray(labels).reshape(-1).astype(np.int64)
    k = (labels >= 0) & (labels < num_classes) \
        & (preds >= 0) & (preds < num_classes)
    binc = np.bincount(num_classes * labels[k] + preds[k],
                       minlength=num_classes ** 2)
    return binc[:num_classes ** 2].reshape(num_classes, num_classes)


def seg_eval(gt_labels, seg_preds, classes, ignore_index: int | None = None):
    """Evaluate per-point segmentation.

    Args:
      gt_labels: list of [P_i] int arrays.
      seg_preds: list of [P_i] int arrays.
      classes: sequence of class names (label i → classes[i]).
      ignore_index: gt label excluded from scoring (both sides masked,
        seg_eval.py:93-95).

    Returns {cls: iou, 'miou', 'acc', 'acc_cls'}.
    """
    assert len(gt_labels) == len(seg_preds)
    num_classes = len(classes)
    hist = np.zeros((num_classes, num_classes), np.int64)
    for gt, pred in zip(gt_labels, seg_preds):
        gt = np.asarray(gt).reshape(-1).copy()
        pred = np.asarray(pred).reshape(-1).copy()
        if ignore_index is not None:
            drop = gt == ignore_index
            pred[drop] = -1
            gt[drop] = -1
        hist += confusion_matrix(pred, gt, num_classes)
    diag = np.diag(hist).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = diag / (hist.sum(1) + hist.sum(0) - diag)
        acc_per = diag / hist.sum(1)
    out = {str(c): float(iou[i]) for i, c in enumerate(classes)}
    out["miou"] = float(np.nanmean(iou))
    out["acc"] = float(diag.sum() / max(hist.sum(), 1))
    out["acc_cls"] = float(np.nanmean(acc_per))
    return out
