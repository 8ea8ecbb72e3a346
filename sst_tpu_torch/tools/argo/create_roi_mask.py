"""Precompute per-point [ROI, ground, drivable] masks for Argoverse 2
(counterpart of the JAX package's ``tools/argo/create_roi_mask.py``, after
the reference's): one ``mask/{sample_idx}.bin`` per frame holding an [N, 3]
bool array stacked as [roi_mask, ground_mask, drivable_mask], with the av2
devkit replaced by ``core/av2_map.py`` (whose ego poses need pandas and
pyarrow) and the paths given as arguments. ``--num-process`` workers
share the frames.

Usage:
  python -m sst_tpu_torch.tools.argo.create_roi_mask --argo2-root data/argo2 \\
      --infos data/argo2/kitti_format/argo2_infos_train.pkl --split train
"""

import argparse
import multiprocessing as mp
import os
from os import path as osp
from pathlib import Path
import pickle as pkl

import numpy as np

from sst_tpu_torch.core.av2_map import load_mapped_avm_and_egoposes


def process_single_frame(info, log_to_avm, log_to_pose, output_dir,
                         argo2_root):
    log_id, ts = info["uuid"].split("/")
    ts = int(ts)

    bin_path = info["point_cloud"]["velodyne_path"]
    bin_path = osp.join(argo2_root, "kitti_format", bin_path)
    points = np.fromfile(bin_path, dtype=np.float32)
    points = points.reshape(-1, 4)[:, :3]

    se3 = log_to_pose[log_id][ts]
    transformed_pts = se3.transform_point_cloud(points)

    avm = log_to_avm[log_id]
    roi_mask = avm.get_raster_layer_points_boolean(transformed_pts, "roi")
    ground_mask = avm.get_ground_points_boolean(transformed_pts)
    drivable_mask = avm.get_raster_layer_points_boolean(
        transformed_pts, "drivable_area")

    cat = np.stack([roi_mask, ground_mask, drivable_mask], axis=1)
    save_path = osp.join(output_dir, info["sample_idx"] + ".bin")
    cat.tofile(save_path)


def run(infos, log_to_avm, log_to_pose, output_dir, argo2_root, token,
        num_process):
    total = len(infos)
    for i, info in enumerate(infos):
        if i % num_process != token:
            continue
        if i % 100 == 0:
            print(f"{i} / {total}", flush=True)
        process_single_frame(info, log_to_avm, log_to_pose, output_dir,
                             argo2_root)


def prepare(infos, dataset_dir):
    log_ids = sorted({info["uuid"].split("/")[0] for info in infos})
    print(f"Got {len(log_ids)} logs")
    return load_mapped_avm_and_egoposes(log_ids, dataset_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--argo2-root", required=True,
                    help="root holding kitti_format/ and argo2_format/")
    ap.add_argument("--infos", required=True,
                    help="argo2_infos_{split}.pkl path")
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test"])
    ap.add_argument("--num-process", type=int, default=5)
    args = ap.parse_args(argv)

    dataset_dir = Path(args.argo2_root) / "argo2_format" / "sensor" / args.split
    kitti_split_dir = "testing" if args.split == "test" else "training"
    output_dir = osp.join(args.argo2_root, "kitti_format", kitti_split_dir,
                          "mask")
    os.makedirs(output_dir, exist_ok=True)

    with open(args.infos, "rb") as f:
        infos = pkl.load(f)

    log_to_avm, log_to_pose = prepare(infos, dataset_dir)

    if args.num_process > 1:
        pool = mp.Pool(args.num_process)
        for token in range(args.num_process):
            pool.apply_async(run, args=(infos, log_to_avm, log_to_pose,
                                        output_dir, args.argo2_root, token,
                                        args.num_process))
        pool.close()
        pool.join()
    else:
        run(infos, log_to_avm, log_to_pose, output_dir, args.argo2_root, 0, 1)
    return output_dir


if __name__ == "__main__":
    main()
