"""Argoverse 2 detection: feather-format results + self-contained CDS eval.

The port's copy of ``sst_tpu/core/eval_argo2.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Counterpart of the reference's Argo2Dataset.format_results / evaluate
(mmdet3d/datasets/argo2_dataset.py:374-520), which serializes to the av2
feather schema and calls the external av2 evaluation package. Here:

- format_results_feather writes the same schema (tx_m..height_m, quaternion,
  score, log_id, timestamp_ns, category) via pandas/pyarrow;
- argo2_eval reimplements the av2 protocol in numpy: 3D center-distance
  matching at {0.5, 1, 2, 4} m, all-point AP, TP errors at 2 m (ATE, ASE,
  AOE), and CDS = mAP * mean(1 - normalized error) with av2's normalization
  bounds (ATE / tp_threshold_m = 2 m, ASE / 1, AOE / pi) — the devkit's own
  composite (av2 evaluation summarize());
- prune_frames_to_roi applies DetectionCfg(eval_only_roi_instances=True)
  semantics (argo2_dataset.py:509-519) via the self-contained HD-map reader
  in core/av2_map.py: a cuboid survives iff any of its 8 vertices lies in
  the 5 m-dilated drivable-area (ROI) raster and its ego-range is within
  max_range_m. Run it over predictions and ground truths before argo2_eval
  to reproduce the official ROI-filtered protocol.
"""

from __future__ import annotations

import numpy as np

LABEL_ATTR = ("tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m",
              "qw", "qx", "qy", "qz")
DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST = 2.0


def lidar_to_argo2_cuboids(boxes):
    """[N, 7+] lidar boxes (bottom-center origin, sst_tpu yaw) → [N, 10]
    av2 cuboid rows (gravity center, lwh, yaw quaternion) — the
    lidar_box_to_argo2 conversion (argo2_dataset.py:444-459)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, boxes.shape[-1]
                                                  if len(boxes) else 7)
    n = len(boxes)
    out = np.zeros((n, 10))
    out[:, 0:2] = boxes[:, 0:2]
    out[:, 2] = boxes[:, 2] + boxes[:, 5] / 2  # gravity center z
    out[:, 3] = boxes[:, 4]  # length
    out[:, 4] = boxes[:, 3]  # width
    out[:, 5] = boxes[:, 5]  # height
    yaw = -boxes[:, 6] - 0.5 * np.pi
    yaw = np.mod(yaw + np.pi, 2 * np.pi) - np.pi
    out[:, 6] = np.cos(yaw / 2)  # qw
    out[:, 9] = np.sin(yaw / 2)  # qz
    return out


def format_results_feather(results, infos, classes, path: str):
    """results[i]: dict(boxes_3d, scores_3d, labels_3d); infos[i] carries
    'uuid' = 'log_id/timestamp_ns'. Writes an av2-schema feather file."""
    import pandas as pd

    rows = []
    for res, info in zip(results, infos):
        log_id, ts = str(info["uuid"]).split("/")
        boxes = np.asarray(res["boxes_3d"])
        labels = np.asarray(res["labels_3d"]).astype(np.int64)
        df = pd.DataFrame(lidar_to_argo2_cuboids(boxes),
                          columns=list(LABEL_ATTR))
        df["score"] = np.asarray(res["scores_3d"], np.float32)
        df["log_id"] = log_id
        df["timestamp_ns"] = int(ts)
        df["category"] = [classes[i].upper() for i in labels]
        rows.append(df)
    dts = (pd.concat(rows).sort_values("score", ascending=False)
           .reset_index(drop=True))
    if not path.endswith(".feather"):
        path += ".feather"
    dts.to_feather(path)
    return path


def prune_frames_to_roi(predictions, ground_truths, infos, dataset_dir,
                        max_range_m=200.0):
    """ROI + range pruning of per-frame prediction/gt dicts, reproducing
    DetectionCfg(eval_only_roi_instances=True, max_range_m=200) in the av2
    evaluator (reference call site argo2_dataset.py:509-519).

    predictions[i]/ground_truths[i] hold ego(lidar)-frame bottom-center
    boxes [x y z dx dy dz yaw ...]; infos[i]['uuid'] = 'log_id/timestamp_ns';
    dataset_dir is the av2 sensor-split directory holding per-log map/ and
    ego-pose files. Returns filtered (predictions, ground_truths)."""
    from .av2_map import (box_corners_3d, load_mapped_avm_and_egoposes)

    log_ids = sorted({str(i["uuid"]).split("/")[0] for i in infos})
    log_to_avm, log_to_pose = load_mapped_avm_and_egoposes(
        log_ids, dataset_dir)

    def keep_mask(boxes, avm, se3):
        boxes = np.asarray(boxes, np.float64)
        if boxes.size == 0:
            return np.zeros(0, bool)
        grav = boxes[:, :7].copy()
        grav[:, 2] += boxes[:, 5] / 2
        rng = np.linalg.norm(grav[:, :3], axis=1) <= max_range_m
        corners = box_corners_3d(grav).reshape(-1, 3)
        corners_city = se3.transform_point_cloud(corners)
        in_roi = avm.get_raster_layer_points_boolean(corners_city, "roi")
        return rng & in_roi.reshape(-1, 8).any(axis=1)

    preds_out, gts_out = [], []
    for pred, gt, info in zip(predictions, ground_truths, infos):
        log_id, ts = str(info["uuid"]).split("/")
        avm, se3 = log_to_avm[log_id], log_to_pose[log_id][int(ts)]
        pk = keep_mask(pred["boxes"], avm, se3)
        gk = keep_mask(gt["boxes"], avm, se3)
        preds_out.append({
            "boxes": np.asarray(pred["boxes"])[pk],
            "scores": np.asarray(pred["scores"])[pk],
            "labels": np.asarray(pred["labels"])[pk]})
        gts_out.append({"boxes": np.asarray(gt["boxes"])[gk],
                        "labels": np.asarray(gt["labels"])[gk]})
    return preds_out, gts_out


def _center3d(boxes):
    c = np.asarray(boxes, np.float64)[:, :3].copy()
    c[:, 2] += np.asarray(boxes)[:, 5] / 2
    return c


def argo2_eval(predictions, ground_truths, classes,
               dist_thresholds=DIST_THRESHOLDS):
    """predictions[i]: {'boxes': [N,7], 'scores': [N], 'labels': [N]}
    ground_truths[i]: {'boxes': [M,7], 'labels': [M]}

    Returns {'{cls}_AP', 'mAP', 'mATE', 'mASE', 'mAOE', 'CDS'}."""
    out = {}
    ap_per_class = []
    ate, ase, aoe = {}, {}, {}
    for ci, cname in enumerate(classes):
        aps = []
        for t in dist_thresholds:
            sc, tp, err, n_gt = [], [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                pm = np.asarray(pred["labels"]) == ci
                gm = np.asarray(gt["labels"]) == ci
                pb = np.asarray(pred["boxes"])[pm]
                ps = np.asarray(pred["scores"])[pm]
                gb = np.asarray(gt["boxes"])[gm]
                n_gt += len(gb)
                if not len(pb):
                    continue
                order = np.argsort(-ps, kind="stable")
                pb, ps = pb[order], ps[order]
                taken = np.zeros(len(gb), bool)
                f_tp = np.zeros(len(pb), bool)
                f_err = np.zeros((len(pb), 3), np.float64)
                if len(gb):
                    d = np.linalg.norm(
                        _center3d(pb)[:, None] - _center3d(gb)[None], axis=-1)
                    for i in range(len(pb)):
                        row = np.where(taken, np.inf, d[i])
                        j = int(np.argmin(row))
                        if row[j] < t:
                            taken[j] = True
                            f_tp[i] = True
                            dims_p, dims_g = pb[i, 3:6], gb[j, 3:6]
                            s_iou = float(np.prod(
                                np.minimum(dims_p, dims_g)
                                / np.maximum(np.maximum(dims_p, dims_g),
                                             1e-6)))
                            dy = np.abs(pb[i, 6] - gb[j, 6]) % (2 * np.pi)
                            f_err[i] = (row[j], 1.0 - s_iou,
                                        min(dy, 2 * np.pi - dy))
                sc.append(ps)
                tp.append(f_tp)
                err.append(f_err)
            if n_gt == 0 or not sc:
                aps.append(0.0)
                continue
            scores = np.concatenate(sc)
            tps = np.concatenate(tp)
            errs = np.concatenate(err)
            order = np.argsort(-scores, kind="stable")
            tps_s = tps[order].astype(np.float64)
            cum = np.cumsum(tps_s)
            recall = cum / n_gt
            prec = cum / np.arange(1, len(tps_s) + 1)
            p_env = np.maximum.accumulate(prec[::-1])[::-1]
            dr = np.diff(np.concatenate([[0.0], recall]))
            aps.append(float(np.sum(p_env * dr)))
            if t == TP_DIST and tps.any():
                e = errs[tps]
                ate[cname] = float(e[:, 0].mean())
                ase[cname] = float(e[:, 1].mean())
                aoe[cname] = float(e[:, 2].mean())
        ap_c = float(np.mean(aps))
        out[f"{cname}_AP"] = round(ap_c, 4)
        ap_per_class.append(ap_c)

    m_ap = float(np.mean(ap_per_class)) if ap_per_class else 0.0
    m_ate = float(np.mean(list(ate.values()))) if ate else 2.0
    m_ase = float(np.mean(list(ase.values()))) if ase else 1.0
    m_aoe = float(np.mean(list(aoe.values()))) if aoe else np.pi
    out["mAP"] = round(m_ap, 4)
    out["mATE"] = round(m_ate, 4)
    out["mASE"] = round(m_ase, 4)
    out["mAOE"] = round(m_aoe, 4)
    norm = np.mean([1 - min(1.0, m_ate / 2.0), 1 - min(1.0, m_ase),
                    1 - min(1.0, m_aoe / np.pi)])
    out["CDS"] = round(m_ap * float(norm), 4)
    return out
