"""Self-contained nuScenes detection metrics: per-class AP (center-distance
matching), TP error metrics, and the NDS composite.

The port's copy of ``sst_tpu/core/eval_nuscenes.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the reference's external nuscenes-devkit invocation
(mmdet3d/datasets/nuscenes_dataset.py _evaluate_single): reimplements the
published protocol in numpy so a real NDS exists without the devkit:

- matching by BEV center distance at thresholds {0.5, 1, 2, 4} m, greedy in
  score order, per class;
- AP = area under the precision-recall curve with the sub-10% recall and
  precision region removed and renormalized (the devkit's clipping);
- TP metrics over matches at the 2.0 m threshold: ATE (BEV center distance),
  ASE (1 - aligned-box 3D IoU = 1 - prod(min(dim)/max(dim))), AOE (abs yaw
  diff, barrier modulo pi, traffic_cone excluded), AVE (velocity L2,
  cone/barrier excluded);
- NDS = (5*mAP + sum(1 - min(1, mTP))) / (5 + #TP-metrics). The devkit
  divides by 10 with 5 TP metrics including AAE (attribute error); this
  pipeline carries no attributes, so AAE is excluded and the denominator
  renormalized — documented deviation.
"""

from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1

# devkit conventions
NO_VELOCITY = ("traffic_cone", "barrier")
NO_ORIENTATION = ("traffic_cone",)
YAW_PERIOD_PI = ("barrier",)


def _wrap(a, period=2 * np.pi):
    d = np.mod(np.abs(a), period)
    return np.minimum(d, period - d)


def _match_class(preds, gts, dist_thr):
    """Greedy center-distance matching for one class across all frames.

    Returns (scores, tp_flags, err_rows or None per pred, total_gt):
    err_rows[i] = (ate, ase, aoe, ave) for TPs.
    """
    all_scores, all_tp, all_err = [], [], []
    total_gt = 0
    for pred, gt in zip(preds, gts):
        pb, ps = pred["boxes"], pred["scores"]
        gb = gt["boxes"]
        total_gt += len(gb)
        if len(pb) == 0:
            continue
        order = np.argsort(-ps, kind="stable")
        pb, ps = pb[order], ps[order]
        taken = np.zeros(len(gb), bool)
        tp = np.zeros(len(pb), bool)
        err = np.zeros((len(pb), 4), np.float32)
        if len(gb):
            d = np.linalg.norm(
                pb[:, None, :2] - gb[None, :, :2], axis=-1)
            for i in range(len(pb)):
                row = np.where(taken, np.inf, d[i])
                j = int(np.argmin(row))
                if row[j] < dist_thr:
                    taken[j] = True
                    tp[i] = True
                    ate = row[j]
                    dims_p, dims_g = pb[i, 3:6], gb[j, 3:6]
                    ase = 1.0 - float(np.prod(
                        np.minimum(dims_p, dims_g)
                        / np.maximum(np.maximum(dims_p, dims_g), 1e-6)))
                    aoe = float(_wrap(pb[i, 6] - gb[j, 6]))
                    ave = float(np.linalg.norm(pb[i, 7:9] - gb[j, 7:9])) \
                        if pb.shape[1] >= 9 and gb.shape[1] >= 9 else 0.0
                    err[i] = (ate, ase, aoe, ave)
        all_scores.append(ps)
        all_tp.append(tp)
        all_err.append(err)
    if not all_scores:
        return (np.zeros(0), np.zeros(0, bool), np.zeros((0, 4)), total_gt)
    return (np.concatenate(all_scores), np.concatenate(all_tp),
            np.concatenate(all_err), total_gt)


def _clipped_ap(scores, tps, total_gt):
    """Devkit AP: PR area with recall < 0.1 and precision < 0.1 removed,
    renormalized by (1-0.1)^2 over a 101-point recall interpolation."""
    if total_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tps[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    recall = cum_tp / total_gt
    prec = cum_tp / np.arange(1, len(tp) + 1)
    # devkit: interpolate precision to 101 recall points, keep the points
    # with recall > MIN_RECALL, subtract MIN_PRECISION (clamped at 0), mean,
    # renormalize by (1 - MIN_PRECISION)
    r_interp = np.linspace(0, 1, 101)
    p_interp = np.interp(r_interp, recall, prec, right=0)
    p = p_interp[int(round(100 * MIN_RECALL)) + 1:]
    p = np.clip(p - MIN_PRECISION, 0.0, None)
    return float(np.mean(p)) / (1.0 - MIN_PRECISION)


def nusc_eval(predictions, ground_truths, classes,
              dist_thresholds=DIST_THRESHOLDS):
    """predictions[i]: {'boxes': [N,7 or 9], 'scores': [N], 'labels': [N]}
    ground_truths[i]: {'boxes': [M,7 or 9], 'labels': [M]} (cols 7:9 = vx,vy)

    Returns {'{cls}_AP_dist_{t}', 'mAP', 'mATE', 'mASE', 'mAOE', 'mAVE',
    'NDS'} with the devkit's value conventions.
    """
    out = {}
    ap_all = []
    tp_metrics = {"trans_err": {}, "scale_err": {}, "orient_err": {},
                  "vel_err": {}}
    for ci, cname in enumerate(classes):
        preds_c, gts_c = [], []
        for pred, gt in zip(predictions, ground_truths):
            pm = np.asarray(pred["labels"]) == ci
            gm = np.asarray(gt["labels"]) == ci
            preds_c.append({"boxes": np.asarray(pred["boxes"])[pm],
                            "scores": np.asarray(pred["scores"])[pm]})
            gts_c.append({"boxes": np.asarray(gt["boxes"])[gm]})
        for t in dist_thresholds:
            sc, tp, err, n_gt = _match_class(preds_c, gts_c, t)
            ap = _clipped_ap(sc, tp, n_gt)
            out[f"{cname}_AP_dist_{t}"] = round(ap, 4)
            ap_all.append(ap)
            if t == TP_DIST and tp.any():
                e = err[tp]
                tp_metrics["trans_err"][cname] = float(e[:, 0].mean())
                tp_metrics["scale_err"][cname] = float(e[:, 1].mean())
                if cname not in NO_ORIENTATION:
                    aoe = e[:, 2]
                    if cname in YAW_PERIOD_PI:
                        aoe = np.minimum(aoe, np.abs(np.pi - aoe))
                    tp_metrics["orient_err"][cname] = float(aoe.mean())
                if cname not in NO_VELOCITY:
                    tp_metrics["vel_err"][cname] = float(e[:, 3].mean())

    out["mAP"] = round(float(np.mean(ap_all)) if ap_all else 0.0, 4)
    m_names = {"trans_err": "mATE", "scale_err": "mASE",
               "orient_err": "mAOE", "vel_err": "mAVE"}
    composite = 5.0 * out["mAP"]
    denom = 5.0
    for k, label in m_names.items():
        vals = list(tp_metrics[k].values())
        # classes never matched contribute the worst value (devkit: 1.0)
        mval = float(np.mean(vals)) if vals else 1.0
        out[label] = round(mval, 4)
        composite += 1.0 - min(1.0, mval)
        denom += 1.0
    out["NDS"] = round(composite / denom, 4)
    return out
