"""Calibrate the synthetic quality protocol (counterpart of the JAX
package's ``tools/analysis_tools/calibrate_synthetic.py``).

The A/B quality numbers of ``tools/ab_dense_vs_sparse.py`` are measured on
held-out scenes from ``flagship.synthetic_labeled_batch`` (bit-identical to
the JAX package's) with ``core/eval_waymo.py``'s protocol. This
tool quantifies, per class, what those absolute numbers can and cannot
mean, by evaluating *synthetic detectors* — ground truth perturbed with
controlled error — on the exact val pool the A/B harness uses:

- oracle (gt as predictions)          -> protocol ceiling (sanity: ~100)
- center noise sigma in {0.1,0.3,0.5} m -> mAP sensitivity to localization
- yaw noise sigma in {0.1, 0.3} rad   -> the mAPH-vs-mAP heading margin
- 20% dropped boxes                   -> recall floor (mAP ~ recall)
- +25% random false positives at random scores -> precision behavior

plus per-class scene statistics (boxes/frame, points-per-box deciles,
range distribution). The output JSON says how to read an A/B: a delta
smaller than the oracle-to-mild-noise drop for that class is inside the
protocol's insensitive band and must not be read as a model-quality
difference. Conversely Pedestrian's tiny boxes make its mAP
saturate under the 0.5-IoU threshold: its calibration rows carry that
ceiling explicitly.

Host code (numpy scene generation and evaluation); no model and no card.

Usage:
  python -m sst_tpu_torch.tools.analysis_tools.calibrate_synthetic \\
      --val-scenes 24 --out CALIBRATION_r05.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np

CLASSES = ("Car", "Pedestrian", "Cyclist")


def perturb(gts, rng, sigma_xyz=0.0, sigma_yaw=0.0, drop=0.0, fp_rate=0.0,
            pcr_half=79.8):
    """Ground truth -> synthetic detector output with controlled error."""
    preds = []
    for gt in gts:
        boxes = np.asarray(gt["boxes"], np.float64).copy()
        labels = np.asarray(gt["labels"]).copy()
        n = len(boxes)
        keep = rng.rand(n) >= drop
        boxes, labels = boxes[keep], labels[keep]
        boxes[:, :3] += rng.randn(len(boxes), 3) * sigma_xyz
        boxes[:, 6] += rng.randn(len(boxes)) * sigma_yaw
        scores = np.clip(rng.uniform(0.5, 1.0, len(boxes)), 0, 1)
        if fp_rate > 0:
            nfp = int(round(fp_rate * n))
            fp_labels = rng.randint(0, 3, nfp)
            # plausible sizes for the fp class, random free placement
            from sst_tpu_torch.flagship import _CLASS_SIZE_PRIORS
            fp = np.zeros((nfp, 7))
            for k in range(nfp):
                lo = _CLASS_SIZE_PRIORS[fp_labels[k]]
                fp[k] = [rng.uniform(-pcr_half, pcr_half),
                         rng.uniform(-pcr_half, pcr_half), -0.9,
                         rng.uniform(lo[2], lo[3]), rng.uniform(lo[0], lo[1]),
                         rng.uniform(lo[4], lo[5]),
                         rng.uniform(-np.pi, np.pi)]
            boxes = np.concatenate([boxes, fp])
            labels = np.concatenate([labels, fp_labels])
            scores = np.concatenate(
                [scores, rng.uniform(0.0, 1.0, nfp)])
        preds.append(dict(boxes=boxes.astype(np.float32), scores=scores,
                          labels=labels))
    return preds


def class_rows(res):
    waymo = {"Car": "Vehicle", "Pedestrian": "Pedestrian",
             "Cyclist": "Cyclist"}
    return {c: dict(L1_mAP=round(res[f"{waymo[c]}/L1 mAP"], 2),
                    L1_mAPH=round(res[f"{waymo[c]}/L1 mAPH"], 2),
                    L2_mAP=round(res[f"{waymo[c]}/L2 mAP"], 2))
            for c in CLASSES}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--val-scenes", type=int, default=24)
    ap.add_argument("--num-points", type=int, default=196608)
    ap.add_argument("--out", default="CALIBRATION_r05.json")
    args = ap.parse_args(argv)

    from sst_tpu_torch.core.eval_waymo import waymo_eval
    from sst_tpu_torch.flagship import synthetic_labeled_batch

    # the A/B harness's val pool: seeds 10000..10000+n (ab_dense_vs_sparse
    # get_pools), same scene_kw as the full-size arms
    gts = []
    for v in range(args.val_scenes):
        _, meta = synthetic_labeled_batch(
            batch_size=1, num_points=args.num_points, seed=10_000 + v)
        gts.extend(meta)

    # ---- scene statistics per class -------------------------------------
    stats = {}
    for ci, cname in enumerate(CLASSES):
        npts, rngs, per_frame = [], [], []
        for gt in gts:
            m = np.asarray(gt["labels"]) == ci
            per_frame.append(int(m.sum()))
            npts.extend(np.asarray(gt["num_points"])[m].tolist())
            b = np.asarray(gt["boxes"])[m]
            rngs.extend(np.hypot(b[:, 0], b[:, 1]).tolist())
        npts, rngs = np.asarray(npts), np.asarray(rngs)
        stats[cname] = dict(
            boxes_per_frame=round(float(np.mean(per_frame)), 2),
            points_per_box_p10_p50_p90=[int(np.percentile(npts, p))
                                        for p in (10, 50, 90)],
            range_m_p10_p50_p90=[round(float(np.percentile(rngs, p)), 1)
                                 for p in (10, 50, 90)],
            l2_fraction=round(float((npts < 5).mean()), 3),
        )

    # ---- perturbation arms ----------------------------------------------
    arms = [
        ("oracle", dict()),
        ("xyz_0.1m", dict(sigma_xyz=0.1)),
        ("xyz_0.3m", dict(sigma_xyz=0.3)),
        ("xyz_0.5m", dict(sigma_xyz=0.5)),
        ("yaw_0.1rad", dict(sigma_yaw=0.1)),
        ("yaw_0.3rad", dict(sigma_yaw=0.3)),
        ("drop_20pct", dict(drop=0.2)),
        ("fp_25pct", dict(fp_rate=0.25)),
        ("realistic_mix", dict(sigma_xyz=0.15, sigma_yaw=0.1, drop=0.1,
                               fp_rate=0.15)),
    ]
    results = {}
    for name, kw in arms:
        rng = np.random.RandomState(7)
        res = waymo_eval(perturb(gts, rng, **kw), gts, classes=CLASSES)
        results[name] = class_rows(res)
        results[name]["Overall_L1_mAP"] = round(res["Overall/L1 mAP"], 2)
        print(f"[{name:14s}] " + "  ".join(
            f"{c}: {results[name][c]['L1_mAP']:5.1f}" for c in CLASSES),
            flush=True)

    # ---- interpretation bands -------------------------------------------
    # the insensitive band: by how little a class's mAP moves under mild
    # (0.1 m) localization noise — deltas below this are protocol noise;
    # the saturation ceiling: oracle-arm value (100 = fully separable).
    interp = {}
    for c in CLASSES:
        interp[c] = dict(
            ceiling_L1_mAP=results["oracle"][c]["L1_mAP"],
            insensitive_band_mAP=round(
                results["oracle"][c]["L1_mAP"]
                - results["xyz_0.1m"][c]["L1_mAP"], 2),
            mAP_drop_at_0p3m=round(
                results["oracle"][c]["L1_mAP"]
                - results["xyz_0.3m"][c]["L1_mAP"], 2),
            heading_margin_mAPH_at_0p3rad=round(
                results["yaw_0.3rad"][c]["L1_mAP"]
                - results["yaw_0.3rad"][c]["L1_mAPH"], 2),
        )

    out = dict(
        protocol="flagship.synthetic_labeled_batch val pool seeds 10000+, "
                 "core/eval_waymo.py greedy matcher, L1/L2 by points-in-box",
        val_scenes=args.val_scenes,
        scene_stats=stats,
        arms=results,
        interpretation=interp,
        note="A/B deltas smaller than a class's insensitive_band are "
             "within protocol noise; classes whose realistic_mix mAP "
             "stays near the ceiling (small boxes vs their IoU threshold "
             "rarely fail matching under moderate noise) saturate and "
             "should be read on mAPH / L2 or ignored for ranking.",
    )
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
