"""Argoverse 2 sensor dataset → KITTI-style infos and point bins
(counterpart of the JAX package's ``tools/argo/argo2_converter.py``, after
the reference's argo2mmdet.py, utils.py and SO3.py), with no devkit: the
lidar and annotation feathers are read with pyarrow and pandas, imported
when a feather is read; the quaternion → yaw math is inlined. The layout is
the one the port's ``data/datasets.py Argo2Dataset`` reads:

  <out>/training/velodyne/XXXXXXX.bin   float32 [N, 4] (x y z intensity)
  <out>/testing/velodyne/XXXXXXX.bin
  <out>/argo2_infos_{train,val,test}.pkl
  <out>/ts2idx.pkl                      {"segname/timestamp": sample_idx}

sample_idx prefix: 0 train / 1 val / 2 test (reference prepare(), one
sequence = 1000 ids, frame index in the low digits).

Usage:
  python -m sst_tpu_torch.tools.argo.argo2_converter --root <av2>/sensor \\
      --out data/argo2 [--splits train val] [--no-bin]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

LABEL_ATTR = ("tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m",
              "qw", "qx", "qy", "qz")
SPLIT_PREFIX = {"train": 0, "val": 1, "test": 2}
SPLIT_DIR = {"train": "training", "val": "training", "test": "testing"}


def read_feather(path):
    import pyarrow.feather as feather

    return feather.read_table(path).to_pandas()


def quat_to_yaw(qw, qx, qy, qz):
    """Scalar-first quaternion → rotation about +z (SO3.py:82)."""
    siny_cosp = 2 * (qw * qz + qx * qy)
    cosy_cosp = 1 - 2 * (qy**2 + qz**2)
    return np.arctan2(siny_cosp, cosy_cosp)


def convert_frame(lidar_path, anno, segname, sample_idx, out_root, split,
                  save_bin=True):
    ts = int(os.path.basename(lidar_path).split(".")[0])
    rel = os.path.join(SPLIT_DIR[split], "velodyne", f"{sample_idx}.bin")
    if save_bin:
        df = read_feather(lidar_path)
        pts = df.loc[:, ["x", "y", "z", "intensity"]].to_numpy(np.float32)
        os.makedirs(os.path.dirname(os.path.join(out_root, rel)),
                    exist_ok=True)
        pts.tofile(os.path.join(out_root, rel))

    info = dict(
        uuid=f"{segname}/{ts}",
        sample_idx=sample_idx,
        image=dict(image_idx=int(sample_idx)),
        point_cloud=dict(num_features=4, velodyne_path=rel),
        calib=dict(), pose=dict(), sweeps=[],
        annos=dict(name=np.zeros(0, "<U32"),
                   dimensions=np.zeros((0, 3)), location=np.zeros((0, 3)),
                   rotation_y=np.zeros(0), num_points_in_gt=np.zeros(0, np.int32)),
    )
    if anno is not None:
        fa = anno[anno["timestamp_ns"] == ts]
        fa = fa[fa["num_interior_pts"] > 0]
        if len(fa):
            cub = fa.loc[:, list(LABEL_ATTR)].to_numpy(np.float64)
            yaw = quat_to_yaw(cub[:, 6], cub[:, 7], cub[:, 8], cub[:, 9])
            yaw = -yaw - 0.5 * np.pi
            yaw = (yaw + np.pi) % (2 * np.pi) - np.pi
            names = np.asarray(
                [c.lower().capitalize() for c in fa["category"]], "<U32")
            info["annos"] = dict(
                name=names,
                # (w, l, h) — argo2mmdet.py:69 wlh = params[:, [4, 3, 5]]
                dimensions=cub[:, [4, 3, 5]],
                location=cub[:, :3],
                rotation_y=yaw,
                num_points_in_gt=fa["num_interior_pts"].to_numpy(np.int32),
                track_uuid=fa["track_uuid"].to_numpy(),
            )
    return info


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", required=True, help="<av2>/sensor directory")
    p.add_argument("--out", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--no-bin", action="store_true")
    args = p.parse_args(argv)

    ts2idx = {}
    for split in args.splits:
        seg_paths = sorted(glob.glob(os.path.join(args.root, split, "*")))
        infos = []
        for seg_i, seg in enumerate(seg_paths):
            segname = os.path.basename(seg)
            anno_path = os.path.join(seg, "annotations.feather")
            anno = read_feather(anno_path) if os.path.exists(anno_path) \
                else None
            frames = sorted(glob.glob(
                os.path.join(seg, "sensors", "lidar", "*.feather")))
            for fi, fp in enumerate(frames):
                sample_idx = f"{SPLIT_PREFIX[split]}{seg_i:03d}{fi:03d}"
                info = convert_frame(fp, anno, segname, sample_idx, args.out,
                                     split, save_bin=not args.no_bin)
                ts2idx[info["uuid"]] = sample_idx
                infos.append(info)
        with open(os.path.join(args.out, f"argo2_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump(infos, f)
        print(f"{split}: {len(infos)} frames from {len(seg_paths)} segments")

    with open(os.path.join(args.out, "ts2idx.pkl"), "wb") as f:
        pickle.dump(ts2idx, f)
    return ts2idx


if __name__ == "__main__":
    main()
