"""CTRL offline step 2: the gt candidate of each tracklet frame
(counterpart of the JAX package's ``tools/ctrl/generate_candidates.py``).

For every tracklet and frame, the gt box of the same frame and type with
the highest BEV IoU against the tracker box, where it reaches
``--iou-thr``: the one-to-one training target. Reads tracklet pickles of
the port's or the JAX package's ``tools/ctrl``.

The gt bin's boxes are in each frame's ego frame. Tracklets made by
``generate_track_input --poses`` are in the world frame: give the same
``--poses`` file here, and each frame's gt boxes are moved into the world
frame by that frame's pose (as ``LiDARTracklet.to_world`` moves the
tracker's) before the IoU. Without it the boxes are compared as they are,
as the JAX package's tool does.

    python -m sst_tpu_torch.tools.ctrl.generate_candidates \\
        --tracklets tracklets.pkl --gt-bin gt.bin --out candidates.pkl \\
        [--poses poses_by_context.pkl] [--iou-thr 0.3]
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
    ap.add_argument("--poses", default=None,
                    help="pkl: {context_name: {timestamp: 4x4 pose}}, the "
                         "file the tracklets were moved to the world by")
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
    by_frame = {k: np.stack(v) for k, v in by_frame.items()}
    if args.poses:
        import torch

        from sst_tpu_torch.ops.incremental import box_frame_transform

        with open(args.poses, "rb") as f:
            poses = pickle.load(f)
        # each frame's gt boxes into the world frame by the float32
        # transform LiDARTracklet.to_world moves the tracker's boxes by;
        # frames without a pose cannot be matched
        by_frame = {k: box_frame_transform(
            torch.from_numpy(v),
            torch.as_tensor(np.asarray(poses[k[0]][k[1]], np.float32)),
            torch.eye(4)).numpy()
            for k, v in by_frame.items() if k[1] in poses.get(k[0], {})}

    candidates = []
    n_matched = 0
    for t in trks:
        cand_boxes = np.zeros((len(t), 7), np.float32)
        cand_valid = np.zeros(len(t), bool)
        for i, ts in enumerate(t.timestamps):
            pool = by_frame.get((t.context_name, ts, t.type_id))
            if pool is None:
                continue
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
