"""FSD++ seeds from a base detector's Objects bin (counterpart of the JAX
package's ``tools/fsdpp/generate_seeds.py``): the detections grouped by
frame into the seed dict ``IncrementalWaymoDataset`` reads (``boxes``,
``labels``, ``scores`` per (context_name, timestamp)).

    python -m sst_tpu_torch.tools.fsdpp.generate_seeds --bin dets.bin \\
        --out seeds.pkl [--score-thr 0.3]
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bin", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--score-thr", type=float, default=0.0)
    args = ap.parse_args(argv)

    from sst_tpu_torch.core.waymo_bin import read_waymo_bin, waymo_box_to_lidar

    frames: dict = {}
    type2label = {1: 0, 2: 1, 4: 2}
    for o in read_waymo_bin(args.bin):
        if o["score"] < args.score_thr:
            continue
        key = (o["context_name"], o["timestamp_micros"])
        fr = frames.setdefault(key, dict(boxes=[], labels=[], scores=[]))
        fr["boxes"].append(waymo_box_to_lidar(o["box"]))
        fr["labels"].append(type2label.get(o.get("type", 0), 0))
        fr["scores"].append(o["score"])
    out = {
        k: dict(
            boxes=np.stack(v["boxes"]) if v["boxes"] else
            np.zeros((0, 7), np.float32),
            labels=np.asarray(v["labels"], np.int32),
            scores=np.asarray(v["scores"], np.float32),
        )
        for k, v in frames.items()
    }
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote seeds for {len(out)} frames to {args.out}")


if __name__ == "__main__":
    main()
