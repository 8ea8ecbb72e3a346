"""Offline dataset preparation (counterpart of the JAX package's
``tools/create_data.py``). Four subcommands:

  gt_db     the gt database ``ObjectSample`` pastes from: every annotated
            object of a dataset's info pkl, its interior points in the
            object's frame as a ``.bin``, and a dbinfos pkl {class: [{path,
            box3d_lidar, name, num_points_in_gt, difficulty, image_idx,
            gt_idx}]}
  kitti     raw KITTI label_2 / calib text → a kitti-format info pkl
  waymo     tfrecords → the kitti format, infos and gt.bin
            (``data_converter/waymo_converter.py``)
  nuscenes  nuScenes JSON tables → train / val info pkls
            (``data_converter/nuscenes_converter.py``)

    python -m sst_tpu_torch.tools.create_data gt_db --dataset WaymoDataset \\
        --data-root data/waymo/kitti --info-path \\
        data/waymo/kitti/waymo_infos_train.pkl --out-dir data/waymo/kitti

Host code: numpy on the CPU, no model and no card.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _points_in_rotated_box(pts, box):
    """[N] mask of points inside ``box`` (x, y, z_bottom, w, l, h, yaw),
    faces included, in the points' dtype."""
    rel = pts[:, :2] - box[:2]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    lx = rel[:, 0] * c - rel[:, 1] * s
    ly = rel[:, 0] * s + rel[:, 1] * c
    return (
        (np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2)
        & (pts[:, 2] >= box[2]) & (pts[:, 2] <= box[2] + box[5])
    )


def create_gt_database(args) -> dict:
    """Writes the database under ``args.out_dir``; returns it."""
    from sst_tpu_torch.data import datasets  # noqa: F401 (registers them)
    from sst_tpu_torch.utils.registry import DATASETS

    ds = DATASETS.build(dict(
        type=args.dataset, data_root=args.data_root,
        info_path=args.info_path,
    ))
    out_dir = os.path.join(args.out_dir, f"{args.dataset.lower()}_gt_database")
    os.makedirs(out_dir, exist_ok=True)
    db: dict = {}
    n_obj = 0
    for i in range(len(ds)):
        s = ds.get_sample(i)
        boxes = s.get("gt_boxes")
        if boxes is None or not len(boxes):
            continue
        names = s.get("gt_names", [ds.classes[int(l)] for l in s["gt_labels"]])
        pts = s["points"]
        for j, (box, name) in enumerate(zip(boxes, names)):
            m = _points_in_rotated_box(pts, box[:7])
            obj = pts[m].copy()
            if len(obj) < args.min_points:
                continue
            obj[:, :3] -= box[:3]  # object frame (ObjectSample adds it back)
            rel = f"{args.dataset.lower()}_gt_database/{i}_{name}_{j}.bin"
            obj.astype(np.float32).tofile(os.path.join(args.out_dir, rel))
            db.setdefault(name, []).append(dict(
                path=rel, box3d_lidar=np.asarray(box[:7], np.float32),
                name=name, num_points_in_gt=int(len(obj)), difficulty=0,
                image_idx=i, gt_idx=j,
            ))
            n_obj += 1
    out_pkl = os.path.join(args.out_dir,
                           f"{args.dataset.lower()}_dbinfos_train.pkl")
    with open(out_pkl, "wb") as f:
        pickle.dump(db, f)
    print(f"wrote {n_obj} objects ({ {k: len(v) for k, v in db.items()} }) "
          f"to {out_pkl}")
    return db


def _parse_kitti_calib(path):
    out = {}
    for line in open(path):
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        out[k.strip()] = np.asarray([float(x) for x in v.split()], np.float32)
    calib = {}
    if "R0_rect" in out:
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = out["R0_rect"].reshape(3, 3)
        calib["R0_rect"] = r0
    if "Tr_velo_to_cam" in out:
        tr = np.eye(4, dtype=np.float32)
        tr[:3, :4] = out["Tr_velo_to_cam"].reshape(3, 4)
        calib["Tr_velo_to_cam"] = tr
    for k in ("P0", "P1", "P2", "P3"):
        if k in out:
            calib[k] = out[k].reshape(3, 4)
    return calib


def convert_waymo(args):
    from sst_tpu_torch.tools.data_converter import waymo_converter

    conv = waymo_converter.convert(args)
    print(f"converted {len(conv.infos)} frames from {len(conv.paths)} "
          f"tfrecords → {args.save_dir}")
    return conv


def convert_nuscenes(args):
    from sst_tpu_torch.tools.data_converter.nuscenes_converter import (
        create_nuscenes_infos,
    )

    val_names = None
    if args.val_scenes:
        val_names = {ln.strip() for ln in open(args.val_scenes) if ln.strip()}
    return create_nuscenes_infos(args.root_path, args.info_prefix,
                                 args.version, args.max_sweeps, val_names,
                                 args.val_ratio, args.out_dir)


def create_kitti_infos(args):
    split_file = os.path.join(args.data_root, "ImageSets", f"{args.split}.txt")
    ids = [l.strip() for l in open(split_file) if l.strip()]
    infos = []
    for sid in ids:
        info = dict(
            point_cloud=dict(
                velodyne_path=f"training/velodyne/{sid}.bin", num_features=4),
            image=dict(image_idx=int(sid)),
            calib=_parse_kitti_calib(
                os.path.join(args.data_root, "training", "calib", f"{sid}.txt")),
        )
        label_path = os.path.join(args.data_root, "training", "label_2",
                                  f"{sid}.txt")
        if os.path.exists(label_path):
            rows = [l.split() for l in open(label_path) if l.strip()]
            rows = [r for r in rows if r[0] != "DontCare"]
            annos = dict(
                name=np.asarray([r[0] for r in rows]),
                truncated=np.asarray([float(r[1]) for r in rows], np.float32),
                occluded=np.asarray([int(r[2]) for r in rows], np.int32),
                alpha=np.asarray([float(r[3]) for r in rows], np.float32),
                bbox=np.asarray([[float(x) for x in r[4:8]] for r in rows],
                                np.float32).reshape(-1, 4),
                dimensions=np.asarray(
                    [[float(r[10]), float(r[8]), float(r[9])] for r in rows],
                    np.float32).reshape(-1, 3),  # (l, h, w) camera convention
                location=np.asarray([[float(x) for x in r[11:14]] for r in rows],
                                    np.float32).reshape(-1, 3),
                rotation_y=np.asarray([float(r[14]) for r in rows], np.float32),
            )
            info["annos"] = annos
        infos.append(info)
    out = os.path.join(args.out_dir, f"kitti_infos_{args.split}.pkl")
    os.makedirs(args.out_dir, exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos to {out}")
    return infos


def main(argv=None):
    from sst_tpu_torch.tools.data_converter import waymo_converter

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gt_db")
    g.add_argument("--dataset", default="WaymoDataset")
    g.add_argument("--data-root", required=True)
    g.add_argument("--info-path", required=True)
    g.add_argument("--out-dir", required=True)
    g.add_argument("--min-points", type=int, default=5)
    g.set_defaults(func=create_gt_database)

    k = sub.add_parser("kitti")
    k.add_argument("--data-root", required=True)
    k.add_argument("--out-dir", required=True)
    k.add_argument("--split", default="train")
    k.set_defaults(func=create_kitti_infos)

    w = sub.add_parser(
        "waymo", help="tfrecords → KITTI-format dirs + infos pkl + gt.bin "
        "(devkit-free; data_converter/waymo_converter.py)")
    waymo_converter.add_arguments(w)
    w.set_defaults(func=convert_waymo)

    n = sub.add_parser(
        "nuscenes", help="nuScenes JSON tables → train/val info pkls "
        "(devkit-free; data_converter/nuscenes_converter.py)")
    n.add_argument("--root-path", required=True)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--info-prefix", default="nuscenes")
    n.add_argument("--max-sweeps", type=int, default=10)
    n.add_argument("--val-scenes", default=None)
    n.add_argument("--val-ratio", type=float, default=0.0)
    n.add_argument("--out-dir", default=None)
    n.set_defaults(func=convert_nuscenes)

    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    main()
