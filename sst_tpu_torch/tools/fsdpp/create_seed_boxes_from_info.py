"""FSD++ oracle seeds from the gt annotations (counterpart of the JAX
package's ``tools/fsdpp/create_seed_boxes_from_info.py``): frame t's seeds
are frame t's gt boxes at score 1.0, keyed by the ``%07d`` image index, the
training-time seed source.

    python -m sst_tpu_torch.tools.fsdpp.create_seed_boxes_from_info \\
        --info data/waymo/kitti_format/waymo_infos_train.pkl --out seeds.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

CLASSES = ("Car", "Pedestrian", "Cyclist")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--info", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if os.path.exists(args.out):
        raise FileExistsError(f"{args.out} exists")

    from sst_tpu_torch.data.datasets import camera_to_lidar_boxes

    with open(args.info, "rb") as f:
        infos = pickle.load(f)

    seeds = {}
    for info in infos:
        annos = info.get("annos")
        if annos is None or len(annos.get("name", [])) == 0:
            continue
        keep = np.isin(annos["name"], CLASSES)
        if not keep.any():
            continue
        sub = {k: np.asarray(v)[keep] for k, v in annos.items()
               if k in ("location", "dimensions", "rotation_y")}
        boxes = camera_to_lidar_boxes(
            sub, info.get("calib", {}).get("R0_rect"),
            info.get("calib", {}).get("Tr_velo_to_cam"),
        )
        labels = np.asarray(
            [CLASSES.index(n) for n in annos["name"][keep]], np.int32)
        key = f"{info['image']['image_idx']:07d}"
        seeds[key] = dict(boxes=boxes.astype(np.float32), labels=labels,
                          scores=np.ones(len(boxes), np.float32))

    with open(args.out, "wb") as f:
        pickle.dump(seeds, f)
    print(f"wrote gt seeds for {len(seeds)} frames -> {args.out}")


if __name__ == "__main__":
    main()
