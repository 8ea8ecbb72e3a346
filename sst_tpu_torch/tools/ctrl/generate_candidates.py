"""CTRL offline step 2: the gt candidate of each tracklet frame
(counterpart of the JAX package's ``tools/ctrl/generate_candidates.py``).

For every tracklet and frame, the gt box of the same frame and type with
the highest BEV IoU against the tracker box, where it reaches
``--iou-thr``: the one-to-one training target. Reads tracklet pickles of
the port's or the JAX package's ``tools/ctrl``.

    python -m sst_tpu_torch.tools.ctrl.generate_candidates \\
        --tracklets tracklets.pkl --gt-bin gt.bin --out candidates.pkl \\
        [--iou-thr 0.3]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracklets", required=True)
    ap.add_argument("--gt-bin", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--iou-thr", type=float, default=0.3)
    args = ap.parse_args(argv)

    from sst_tpu_torch.core.evaluation import rotated_iou_matrix
    from sst_tpu_torch.core.waymo_bin import read_waymo_bin, waymo_box_to_lidar
    from sst_tpu_torch.data.tracklet_dataset import load_tracklets

    trks = load_tracklets(args.tracklets)
    by_frame: dict = {}
    for g in read_waymo_bin(args.gt_bin):
        by_frame.setdefault(
            (g["context_name"], g["timestamp_micros"], g.get("type", 0)), []
        ).append(waymo_box_to_lidar(g["box"]))

    candidates = []
    n_matched = 0
    for t in trks:
        cand_boxes = np.zeros((len(t), 7), np.float32)
        cand_valid = np.zeros(len(t), bool)
        for i, ts in enumerate(t.timestamps):
            pool = by_frame.get((t.context_name, ts, t.type_id))
            if not pool:
                continue
            pool = np.stack(pool)
            iou = rotated_iou_matrix(t.boxes[i:i + 1], pool, mode="bev")[0]
            j = int(np.argmax(iou))
            if iou[j] >= args.iou_thr:
                cand_boxes[i] = pool[j]
                cand_valid[i] = True
                n_matched += 1
        candidates.append(dict(boxes=cand_boxes, valid=cand_valid))
    with open(args.out, "wb") as f:
        pickle.dump(candidates, f)
    print(f"wrote candidates for {len(trks)} tracklets "
          f"({n_matched} matched frames) to {args.out}")


if __name__ == "__main__":
    main()
