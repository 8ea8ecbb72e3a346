"""Predicted boxes that hold no LiDAR point dropped (counterpart of the
JAX package's ``tools/ctrl/remove_empty.py``, one process, numpy): per
frame, each box's bottom raised by ``--bottom-lift`` of its height, its
footprint optionally widened by ``--extra-hw``, and only boxes with at
least ``--min-points`` points inside kept.

    python -m sst_tpu_torch.tools.ctrl.remove_empty --bin preds.bin \\
        --kitti-root data/waymo/kitti_format --split training \\
        [--bottom-lift 0.2 --extra-hw 0.1 --out cleaned.bin]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def points_in_boxes_np(xyz, boxes):
    """[M] count of points in each box; boxes [M, 7] LiDAR rows (bottom
    z)."""
    if len(boxes) == 0 or len(xyz) == 0:
        return np.zeros(len(boxes), np.int64)
    rel = xyz[:, None, :2] - boxes[None, :, :2]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    lx = rel[..., 0] * c[None] - rel[..., 1] * s[None]
    ly = rel[..., 0] * s[None] + rel[..., 1] * c[None]
    inz = (xyz[:, None, 2] >= boxes[None, :, 2]) & (
        xyz[:, None, 2] <= boxes[None, :, 2] + boxes[None, :, 5])
    inside = ((np.abs(lx) <= boxes[None, :, 3] / 2)
              & (np.abs(ly) <= boxes[None, :, 4] / 2) & inz)
    return inside.sum(0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bin", required=True)
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--split", default="training")
    p.add_argument("--bottom-lift", type=float, default=0.2,
                   help="raise box bottom by this fraction of height "
                        "(ignores ground returns)")
    p.add_argument("--extra-hw", type=float, default=0.0)
    p.add_argument("--min-points", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from sst_tpu_torch.core.waymo_bin import read_bin_as_frames, write_waymo_bin
    from sst_tpu_torch.tools.ctrl.utils import get_pc_from_time_stamp

    with open(os.path.join(args.kitti_root, "idx2timestamp.pkl"), "rb") as f:
        idx2ts = pickle.load(f)
    ts2idx = {v: k for k, v in idx2ts.items()}

    frames_in = read_bin_as_frames(args.bin)
    frames_out = []
    kept = total = 0
    for (cx, ts), fr in frames_in.items():
        pc = get_pc_from_time_stamp(ts, ts2idx, args.kitti_root,
                                    split=args.split)[:, :3]
        boxes = fr["boxes"].copy()
        boxes[:, 2] += boxes[:, 5] * args.bottom_lift
        boxes[:, 5] *= (1.0 - args.bottom_lift)
        if args.extra_hw:
            boxes[:, 3:5] += 2 * args.extra_hw
        cnt = points_in_boxes_np(pc, boxes)
        keep = cnt >= args.min_points
        total += len(boxes)
        kept += int(keep.sum())
        frames_out.append(dict(
            boxes=fr["boxes"][keep], scores=fr["scores"][keep],
            labels=fr["labels"][keep],
            obj_ids=[o for o, k in zip(fr["obj_ids"], keep) if k],
            context_name=cx, timestamp_micros=ts,
        ))

    save = args.out or args.bin.replace(".bin", "_nonempty.bin")
    write_waymo_bin(save, frames_out)
    print(f"kept {kept}/{total} boxes -> {save}")


if __name__ == "__main__":
    main()
