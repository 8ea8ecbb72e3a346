"""FSD++ seeds from a raw prediction dump (``tools.test --out``; counterpart
of the JAX package's ``tools/fsdpp/create_seed_boxes_from_raw_output.py``):
the inference seed source where no tracking bin exists. The dump follows
the dataset's order, so the info pkl gives each result's ``%07d`` key.

    python -m sst_tpu_torch.tools.fsdpp.create_seed_boxes_from_raw_output \\
        --raw work_dirs/fsd/preds.pkl \\
        --info data/waymo/kitti_format/waymo_infos_val.pkl --out seeds.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--raw", required=True)
    ap.add_argument("--info", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--score-thr", type=float, default=0.0)
    args = ap.parse_args(argv)
    if os.path.exists(args.out):
        raise FileExistsError(f"{args.out} exists")

    with open(args.raw, "rb") as f:
        raw = pickle.load(f)
    with open(args.info, "rb") as f:
        infos = pickle.load(f)
    if len(raw) != len(infos):
        raise ValueError(
            f"{len(raw)} results vs {len(infos)} infos: the dump must cover "
            f"the whole split in dataset order")

    seeds = {}
    for result, info in zip(raw, infos):
        boxes = np.asarray(result["boxes"], np.float32)
        if len(boxes) == 0:
            continue
        scores = np.asarray(result["scores"], np.float32)
        keep = scores >= args.score_thr
        if not keep.any():
            continue
        key = f"{info['image']['image_idx']:07d}"
        seeds[key] = dict(
            boxes=boxes[keep, :7], labels=np.asarray(
                result["labels"], np.int32)[keep],
            scores=scores[keep],
        )

    with open(args.out, "wb") as f:
        pickle.dump(seeds, f)
    print(f"wrote prediction seeds for {len(seeds)} frames -> {args.out}")


if __name__ == "__main__":
    main()
