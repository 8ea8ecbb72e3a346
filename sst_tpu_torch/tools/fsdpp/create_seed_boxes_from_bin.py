"""FSD++ seeds from a Waymo Objects bin, keyed by image index (counterpart
of the JAX package's ``tools/fsdpp/create_seed_boxes_from_bin.py``): the
seed source for tracking or ensemble outputs. Each Waymo box goes back to
the LiDAR 7-dof row (``waymo_box_to_lidar``), and frames are keyed by the
index the converter's ``idx2timestamp.pkl`` gives their timestamp.

    python -m sst_tpu_torch.tools.fsdpp.create_seed_boxes_from_bin \\
        --bin work_dirs/fsd/results_val.bin \\
        --idx2ts data/waymo/kitti_format/idx2timestamp.pkl --out seeds.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bin", required=True, help="metrics_pb2.Objects bin")
    ap.add_argument("--idx2ts", required=True,
                    help="idx2timestamp.pkl from the Waymo converter")
    ap.add_argument("--out", required=True)
    ap.add_argument("--score-thr", type=float, default=0.0)
    args = ap.parse_args(argv)
    if os.path.exists(args.out):
        raise FileExistsError(f"{args.out} exists")

    from sst_tpu_torch.core.waymo_bin import read_bin_as_frames

    with open(args.idx2ts, "rb") as f:
        idx2ts = pickle.load(f)
    ts2idx = {ts: idx for idx, ts in idx2ts.items()}

    seeds = {}
    skipped = 0
    frames = read_bin_as_frames(args.bin)
    for (_, ts), fr in sorted(frames.items(), key=lambda kv: kv[0][1]):
        idx = ts2idx.get(ts)
        if idx is None:
            skipped += 1
            continue
        keep = fr["scores"] >= args.score_thr
        if not keep.any():
            continue
        seeds[str(idx)] = dict(
            boxes=fr["boxes"][keep].astype(np.float32),
            labels=fr["labels"][keep].astype(np.int32),
            scores=fr["scores"][keep].astype(np.float32),
        )

    with open(args.out, "wb") as f:
        pickle.dump(seeds, f)
    print(f"wrote bin seeds for {len(seeds)} frames -> {args.out}"
          + (f" ({skipped} frames not in idx2ts map)" if skipped else ""))


if __name__ == "__main__":
    main()
