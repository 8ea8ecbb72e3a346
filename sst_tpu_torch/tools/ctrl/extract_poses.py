"""CTRL's pose and timestamp tables from converted Waymo infos
(counterpart of the JAX package's ``tools/ctrl/extract_poses.py``).

Reads the kitti-format infos and the converter's ``idx2timestamp.pkl`` /
``idx2contextname.pkl`` under ``--kitti-root`` and writes there

  poses.pkl              {timestamp: 4x4 ego → world}
  context2timestamp.pkl  {context_name: sorted [timestamps]}
  poses_by_context.pkl   {context_name: {timestamp: pose}} (the layout
                         ``WaymoTrackletDataset`` reads)
  frame_index.pkl        {(context_name, timestamp): velodyne path}

    python -m sst_tpu_torch.tools.ctrl.extract_poses \\
        --kitti-root data/waymo/kitti_format \\
        [--infos waymo_infos_train.pkl waymo_infos_val.pkl]
"""

from __future__ import annotations

import argparse
import os
import pickle
from collections import defaultdict


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--infos", nargs="+", default=None,
                   help="info pkl names under kitti-root (default: every "
                        "waymo_infos_*.pkl present)")
    args = p.parse_args(argv)
    root = args.kitti_root

    with open(os.path.join(root, "idx2timestamp.pkl"), "rb") as f:
        idx2ts = pickle.load(f)
    with open(os.path.join(root, "idx2contextname.pkl"), "rb") as f:
        idx2cx = pickle.load(f)

    names = args.infos or sorted(
        n for n in os.listdir(root)
        if n.startswith("waymo_infos_") and n.endswith(".pkl")
    )
    pose_dict = {}
    context2ts = defaultdict(list)
    by_context = defaultdict(dict)
    frame_index = {}
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            velo = info["point_cloud"]["velodyne_path"]
            idx_str = os.path.basename(velo).split(".")[0]
            ts = idx2ts[idx_str]
            cx = idx2cx[idx_str]
            pose = info["pose"]
            pose_dict[ts] = pose
            context2ts[cx].append(ts)
            by_context[cx][ts] = pose
            frame_index[(cx, ts)] = velo

    for k in context2ts:
        context2ts[k] = sorted(context2ts[k])

    for fname, obj in (
        ("poses.pkl", pose_dict),
        ("context2timestamp.pkl", dict(context2ts)),
        ("poses_by_context.pkl", dict(by_context)),
        ("frame_index.pkl", frame_index),
    ):
        with open(os.path.join(root, fname), "wb") as f:
            pickle.dump(obj, f)
    print(f"wrote pose tables for {len(pose_dict)} frames, "
          f"{len(context2ts)} sequences")


if __name__ == "__main__":
    main()
