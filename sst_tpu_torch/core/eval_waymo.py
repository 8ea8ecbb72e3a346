"""Self-contained Waymo Open Dataset detection metrics: L1/L2 mAP + mAPH
(the port's copy of ``sst_tpu/core/eval_waymo.py``).

Counterpart of the reference's external metric binary invocation
(mmdet3d/datasets/waymo_dataset.py:411-470 parses the
compute_detection_metrics_main table); this module computes the same table
shape — {Class}/L{1,2} mAP and mAPH keys plus Overall rows — in vectorized
numpy so a real number exists even without the Waymo C++ toolkit.
:func:`parse_metrics_stdout` reads the official binary's table where it
runs, on the Objects bins ``core/waymo_bin.py`` writes.

Protocol (per the Waymo OD metric definitions):
- difficulty: a gt is LEVEL_2 if labeler-marked difficulty==2 OR it has
  <= 5 lidar points; gts with 0 points are ignored entirely.
- the L1 metric scores only L1 gts (L2 gts are "ignore": predictions
  matched to them are dropped, not false positives); the L2 metric scores
  all non-empty gts.
- mAPH weights each true positive by (1 - |Δheading|/pi), Δheading wrapped
  into [-pi, pi]; the weight enters both the precision and recall
  numerators.
- AP integrates the monotone precision envelope over all recall points.

Two matchers:
- ``matcher='greedy'`` (default): score-ordered greedy matching, one match
  pass shared by the L1 and L2 tables (the ignore flags only affect
  post-match classification, never match priority). The per-prediction
  python loop runs only over predictions that have at least one candidate
  gt, so evaluating 10k+ frames is seconds, not hours.
- ``matcher='hungarian'``: per-score-cutoff maximum-IoU bipartite matching
  (scipy linear_sum_assignment), the official metric's matching scheme.
  Slower; used to quantify the greedy deviation
  (tests/test_eval_protocols.py asserts the greedy−Hungarian gap).

The per-(frame, class) IoU matrix is computed ONCE and sliced for both
levels and every range breakdown.
"""

from __future__ import annotations

import numpy as np

from sst_tpu_torch.core.evaluation import greedy_match, rotated_iou_matrix

# repo class names (KITTI-format infos) → Waymo metric table names
_WAYMO_NAME = {"Car": "Vehicle", "Vehicle": "Vehicle",
               "Pedestrian": "Pedestrian", "Cyclist": "Cyclist",
               "Sign": "Sign"}

DEFAULT_IOU = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5,
               "Sign": 0.5}

RANGE_BREAKDOWNS = ((0.0, 30.0), (30.0, 50.0), (50.0, np.inf))


def _heading_weight(dyaw):
    d = np.abs(np.mod(np.abs(dyaw), 2 * np.pi))
    d = np.minimum(d, 2 * np.pi - d)
    return np.maximum(1.0 - d / np.pi, 0.0)


def _ap_from_matches(scores, tps, weights, total_gt):
    """(AP, APH) from pooled matches via the monotone precision envelope."""
    if total_gt == 0 or len(scores) == 0:
        return 0.0, 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tps[order].astype(np.float64)
    w = weights[order].astype(np.float64)
    cum_tp = np.cumsum(tp)
    cum_w = np.cumsum(w)
    npred = np.arange(1, len(tp) + 1)
    recall = cum_tp / total_gt
    prec = cum_tp / npred
    recall_h = cum_w / total_gt
    prec_h = cum_w / npred

    def integrate(r, p):
        # monotone non-increasing precision envelope, then sum p * dr
        p_env = np.maximum.accumulate(p[::-1])[::-1]
        dr = np.diff(np.concatenate([[0.0], r]))
        return float(np.sum(p_env * dr))

    return integrate(recall, prec), integrate(recall_h, prec_h)


def _gt_flags(num_pts, labeled, level):
    """ignore mask over a frame's gts for an eval level."""
    empty = num_pts <= 0
    is_l2 = (labeled >= 2) | (num_pts <= 5)
    if level == 1:
        return empty | is_l2
    return empty


def _frame_arrays(pred, gt, ci):
    """Per-class slices of one frame: (pb, ps, gb, num_pts, labeled)."""
    pm = np.asarray(pred["labels"]) == ci
    gm = np.asarray(gt["labels"]) == ci
    pb = np.asarray(pred["boxes"])[pm] if len(pred["boxes"]) \
        else np.zeros((0, 7))
    ps = np.asarray(pred["scores"])[pm]
    gb = np.asarray(gt["boxes"])[gm] if len(gt["boxes"]) \
        else np.zeros((0, 7))
    m = len(gb)
    num_pts = np.asarray(gt.get("num_points", np.full(len(gm), 99)))[gm] \
        if m else np.zeros(0)
    labeled = np.asarray(gt.get("difficulty", np.zeros(len(gm), np.int32)))[gm] \
        if m else np.zeros(0, np.int32)
    return pb, ps, gb, num_pts, labeled


def _greedy_levels(frames, thr, pred_sel=None, gt_sel=None):
    """One greedy match per frame (shared by both levels); returns
    {level: (scores, tp, hweight, gt_count)} pooled over frames.

    frames: list of (pb, ps, gb, num_pts, labeled, iou). pred_sel/gt_sel
    optionally sub-select (range breakdowns) — the IoU matrix is sliced,
    never recomputed."""
    acc = {lv: {"s": [], "t": [], "w": [], "g": 0} for lv in (1, 2)}
    for fi, (pb, ps, gb, num_pts, labeled, iou) in enumerate(frames):
        if pred_sel is not None:
            pmask, gmask = pred_sel[fi], gt_sel[fi]
            pb, ps = pb[pmask], ps[pmask]
            gb, num_pts, labeled = gb[gmask], num_pts[gmask], labeled[gmask]
            iou = iou[np.ix_(pmask, gmask)]
        order = np.argsort(-ps, kind="stable")
        match = greedy_match(iou, order, thr)
        matched = match >= 0
        mj = np.maximum(match, 0)
        hw_all = np.where(
            matched,
            _heading_weight(pb[:, 6] - gb[mj, 6]) if len(gb) else 0.0,
            0.0)
        for lv in (1, 2):
            ignore = _gt_flags(num_pts, labeled, lv)
            ign_pred = matched & (ignore[mj] if len(gb) else False)
            keep = ~ign_pred
            tp = matched & keep & (~ignore[mj] if len(gb) else False)
            acc[lv]["s"].append(ps[keep])
            acc[lv]["t"].append(tp[keep])
            acc[lv]["w"].append(np.where(tp, hw_all, 0.0)[keep])
            acc[lv]["g"] += int((~ignore).sum())
    out = {}
    for lv in (1, 2):
        a = acc[lv]
        out[lv] = (
            np.concatenate(a["s"]) if a["s"] else np.zeros(0),
            np.concatenate(a["t"]) if a["t"] else np.zeros(0, bool),
            np.concatenate(a["w"]) if a["w"] else np.zeros(0),
            a["g"])
    return out


def _hungarian_levels(frames, thr, num_cutoffs=51,
                      pred_sel=None, gt_sel=None):
    """Official-style per-score-cutoff Hungarian matching.

    For each cutoff c: per frame, predictions with score >= c are matched
    to gts by maximum-total-IoU bipartite assignment (pairs below the IoU
    threshold forbidden); TP / heading-weighted TP / counted predictions
    accumulate into one precision-recall point per cutoff. Returns
    {level: (ap, aph)} directly (PR points, not pooled matches)."""
    from scipy.optimize import linear_sum_assignment

    sel = []
    for fi, f in enumerate(frames):
        pb, ps, gb, num_pts, labeled, iou = f
        if pred_sel is not None:
            pmask, gmask = pred_sel[fi], gt_sel[fi]
            pb, ps = pb[pmask], ps[pmask]
            gb, num_pts, labeled = gb[gmask], num_pts[gmask], labeled[gmask]
            iou = iou[np.ix_(pmask, gmask)]
        sel.append((pb, ps, gb, num_pts, labeled, iou))

    all_scores = np.concatenate([f[1] for f in sel]) if sel else np.zeros(0)
    if len(all_scores) == 0:
        return {1: (0.0, 0.0), 2: (0.0, 0.0)}
    qs = np.linspace(0.0, 1.0, num_cutoffs)
    cutoffs = np.unique(np.quantile(all_scores, qs))

    gt_counts = {1: 0, 2: 0}
    for _, _, gb, num_pts, labeled, _ in sel:
        for lv in (1, 2):
            gt_counts[lv] += int((~_gt_flags(num_pts, labeled, lv)).sum())

    # per cutoff accumulators per level: tp, tph, counted_preds
    stats = {lv: np.zeros((len(cutoffs), 3)) for lv in (1, 2)}
    for pb, ps, gb, num_pts, labeled, iou in sel:
        ignore = {lv: _gt_flags(num_pts, labeled, lv) for lv in (1, 2)}
        for k, c in enumerate(cutoffs):
            pm = ps >= c
            if not pm.any():
                continue
            sub = iou[pm]
            n, m = sub.shape
            if m:
                cost = np.where(sub >= thr, -sub, 1.0)
                ri, cj = linear_sum_assignment(cost)
                ok = sub[ri, cj] >= thr
                ri, cj = ri[ok], cj[ok]
                hw = _heading_weight(pb[pm][ri, 6] - gb[cj, 6])
            else:
                ri = cj = np.zeros(0, np.int64)
                hw = np.zeros(0)
            for lv in (1, 2):
                ign = ignore[lv]
                match_ign = ign[cj] if m else np.zeros(0, bool)
                tp = int((~match_ign).sum())
                tph = float(hw[~match_ign].sum())
                counted = int(pm.sum()) - int(match_ign.sum())
                stats[lv][k] += (tp, tph, counted)

    out = {}
    for lv in (1, 2):
        tg = gt_counts[lv]
        if tg == 0:
            out[lv] = (0.0, 0.0)
            continue
        tp, tph, counted = stats[lv].T
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = np.where(counted > 0, tp / np.maximum(counted, 1), 0.0)
            prech = np.where(counted > 0, tph / np.maximum(counted, 1), 0.0)
        recall = tp / tg
        recallh = tph / tg
        # high cutoff → low recall; integrate over increasing recall
        o = np.argsort(recall, kind="stable")

        def integrate(r, p):
            p_env = np.maximum.accumulate(p[::-1])[::-1]
            dr = np.diff(np.concatenate([[0.0], r]))
            return float(np.sum(p_env * dr))

        out[lv] = (integrate(recall[o], prec[o]),
                   integrate(recallh[o], prech[o]))
    return out


def waymo_eval(predictions, ground_truths, classes=("Car", "Pedestrian",
                                                    "Cyclist"),
               iou_thresholds=None, range_breakdowns=False,
               matcher: str = "greedy", num_cutoffs: int = 51):
    """predictions[i]: {'boxes': [N,7+], 'scores': [N], 'labels': [N]}
    ground_truths[i]: {'boxes': [M,7+], 'labels': [M],
                       'num_points': [M] (optional), 'difficulty': [M]
                       (optional labeler-marked, 2 = LEVEL_2)}

    Returns the reference's ap_dict key schema:
    '{WaymoName}/L{1,2} mAP[H]' + 'Overall/L{1,2} mAP[H]', and when
    range_breakdowns also '{WaymoName}/L2 mAP[H] [{lo}, {hi})'.
    """
    assert matcher in ("greedy", "hungarian"), matcher
    iou_thresholds = dict(DEFAULT_IOU, **(iou_thresholds or {}))
    out = {}
    for ci, cname in enumerate(classes):
        wname = _WAYMO_NAME.get(cname, cname)
        thr = iou_thresholds.get(wname, 0.5)

        # one IoU matrix per frame, reused by both levels + all breakdowns
        frames = []
        for pred, gt in zip(predictions, ground_truths):
            pb, ps, gb, num_pts, labeled = _frame_arrays(pred, gt, ci)
            iou = rotated_iou_matrix(pb[:, :7], gb[:, :7], mode="3d")
            frames.append((pb, ps, gb, num_pts, labeled, iou))

        def emit(prefix, pred_sel=None, gt_sel=None):
            if matcher == "greedy":
                levels = _greedy_levels(frames, thr, pred_sel, gt_sel)
                for lv in (1, 2):
                    ap, aph = _ap_from_matches(*levels[lv])
                    out[f"{prefix}/L{lv} mAP"] = round(100 * ap, 4)
                    out[f"{prefix}/L{lv} mAPH"] = round(100 * aph, 4)
            else:
                levels = _hungarian_levels(frames, thr, num_cutoffs,
                                           pred_sel, gt_sel)
                for lv in (1, 2):
                    ap, aph = levels[lv]
                    out[f"{prefix}/L{lv} mAP"] = round(100 * ap, 4)
                    out[f"{prefix}/L{lv} mAPH"] = round(100 * aph, 4)

        emit(wname)

        if range_breakdowns:
            pr = [np.linalg.norm(f[0][:, :2], axis=1) if len(f[0])
                  else np.zeros(0) for f in frames]
            gr = [np.linalg.norm(f[2][:, :2], axis=1) if len(f[2])
                  else np.zeros(0) for f in frames]
            for lo, hi in RANGE_BREAKDOWNS:
                pred_sel = [(r >= lo) & (r < hi) for r in pr]
                gt_sel = [(r >= lo) & (r < hi) for r in gr]
                hi_s = "inf" if np.isinf(hi) else f"{int(hi)}"
                saved = dict(out)
                emit(wname, pred_sel, gt_sel)
                for lv in (1, 2):
                    for met in ("mAP", "mAPH"):
                        k = f"{wname}/L{lv} {met}"
                        out[f"{k} [{int(lo)}, {hi_s})"] = out[k]
                        out[k] = saved[k]

    overall = [c for c in classes if _WAYMO_NAME.get(c, c) != "Sign"]
    for level in (1, 2):
        for met in ("mAP", "mAPH"):
            vals = [out[f"{_WAYMO_NAME.get(c, c)}/L{level} {met}"]
                    for c in overall]
            out[f"Overall/L{level} {met}"] = round(float(np.mean(vals)), 4) \
                if vals else 0.0
    return out


# ------------------------------------------------------------------ binary
# adapter: parse compute_detection_metrics_main stdout into the ap_dict


def parse_metrics_stdout(text: str) -> dict:
    """Parse the official WOD metric binary's stdout table into the
    repo's ap_dict schema (reference behavior:
    mmdet3d/datasets/waymo_dataset.py:416-470, which splits on 'mAP '
    tokens in fixed order; this parser keys on the printed breakdown
    labels instead, so reordered or partial tables still parse).

    Binary lines look like
      OBJECT_TYPE_TYPE_VEHICLE_LEVEL_1: [mAP 0.713] [mAPH 0.705]
      RANGE_TYPE_VEHICLE_[0, 30)_LEVEL_2: [mAP 0.82] [mAPH 0.81]
    Values are fractions; they are converted to percent to match the
    internal waymo_eval convention. Overall rows = mean of
    Vehicle/Pedestrian/Cyclist (Sign excluded), as in the reference.
    """
    import re

    pat = re.compile(
        r"^\s*(OBJECT_TYPE_TYPE|RANGE_TYPE)_([A-Z_]+?)"
        r"(?:_\[(\d+), (\d+|INF)\))?_LEVEL_(\d)\s*:"
        r"\s*\[mAP ([0-9.eE+-]+)\]\s*\[mAPH ([0-9.eE+-]+)\]",
        re.MULTILINE)
    name_map = {"VEHICLE": "Vehicle", "PEDESTRIAN": "Pedestrian",
                "CYCLIST": "Cyclist", "SIGN": "Sign"}
    out = {}
    for kind, name, lo, hi, lvl, ap, aph in pat.findall(text):
        cname = name_map.get(name, name.title())
        suffix = ""
        if kind == "RANGE_TYPE" and lo:
            hi_s = "inf" if hi == "INF" else hi
            suffix = f" [{lo}, {hi_s})"
        out[f"{cname}/L{lvl} mAP{suffix}"] = round(float(ap) * 100, 4)
        out[f"{cname}/L{lvl} mAPH{suffix}"] = round(float(aph) * 100, 4)
    for lvl in (1, 2):
        for met in ("mAP", "mAPH"):
            keys = [f"{c}/L{lvl} {met}"
                    for c in ("Vehicle", "Pedestrian", "Cyclist")]
            vals = [out[k] for k in keys if k in out]
            if vals:
                out[f"Overall/L{lvl} {met}"] = round(float(np.mean(vals)), 4)
    return out
