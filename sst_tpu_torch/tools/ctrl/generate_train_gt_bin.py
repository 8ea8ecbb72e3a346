"""The ground-truth labels of Waymo tfrecords as one Objects bin with
object ids, the matching target of CTRL's candidates (counterpart of the
JAX package's ``tools/ctrl/generate_train_gt_bin.py``), on the port's
devkit-free tfrecord parser (``data/waymo_proto.py``).

    python -m sst_tpu_torch.tools.ctrl.generate_train_gt_bin \\
        --data-folder data/waymo/waymo_format/training \\
        --output data/waymo/waymo_format/train_gt.bin
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

TYPE2LABEL = {1: 0, 2: 1, 4: 2}  # vehicle / pedestrian / cyclist


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-folder", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    from sst_tpu_torch.core.waymo_bin import write_waymo_bin
    from sst_tpu_torch.data import waymo_proto as wp

    paths = sorted(glob.glob(os.path.join(args.data_folder, "*.tfrecord")))
    frames_out = []
    for path in paths:
        for rec in wp.read_tfrecord(path):
            frame = wp.parse_frame(rec)
            ctx_name = frame["context_name"]
            ts = frame["timestamp_micros"]
            boxes, labels, ids = [], [], []
            for lab in frame["laser_labels"]:
                if lab["type"] not in TYPE2LABEL:
                    continue
                # label.proto's box (cx, cy, cz, length, width, height,
                # heading) → the LiDAR row [x, y, z_bottom, w, l, h, yaw]
                bx, by, bz, length, width, height, heading = lab["box"]
                boxes.append([bx, by, bz - height / 2,
                              width, length, height,
                              -heading - 0.5 * np.pi])
                labels.append(TYPE2LABEL[lab["type"]])
                ids.append(lab["id"])
            if boxes:
                frames_out.append(dict(
                    boxes=np.asarray(boxes, np.float32),
                    scores=np.ones(len(boxes), np.float32),
                    labels=np.asarray(labels, np.int32),
                    obj_ids=ids, context_name=ctx_name, timestamp_micros=ts,
                ))

    write_waymo_bin(args.output, frames_out)
    n = sum(len(f["boxes"]) for f in frames_out)
    print(f"wrote {n} gt objects over {len(frames_out)} frames "
          f"-> {args.output}")


if __name__ == "__main__":
    main()
