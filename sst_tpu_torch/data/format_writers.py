"""Seeded scenes written in the nuScenes, Argo2 and KITTI dataset formats
(info ``.pkl`` files, ``.bin`` point files, past sweeps) and a gt database
for ``ObjectSample``: small datasets made from a seed, for the CPU tests,
``chip_smoke.py`` and smoke runs of the CLIs where no real data is at hand.

Each scene holds ``boxes`` objects with about half of its points inside
them and the rest spread over a square of half-width ``half``. The info
schemas are the ones ``tools/data_converter`` writes (nuScenes: lidar path,
µs timestamps, sweeps with ``sensor2lidar_rotation`` / ``_translation``,
LiDAR-frame ``gt_boxes``, ``gt_names``, ``gt_velocity`` with a NaN row,
``num_lidar_pts`` and ``valid_flag``), Argo2's the nuScenes layout with a
``uuid`` of ``log_id/timestamp_ns``, KITTI's the Waymo layout's
camera-frame annos with ``calib`` and ``image``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from sst_tpu_torch.data.datasets import (
    Argo2Dataset,
    KittiDataset,
    LyftDataset,
    NuScenesDataset,
)

NUSC_CLASSES = NuScenesDataset.CLASSES
ARGO2_CLASSES = Argo2Dataset.CLASSES
LYFT_CLASSES = LyftDataset.CLASSES
KITTI_CLASSES = KittiDataset.CLASSES


def scene(rng: np.random.RandomState, points: int, boxes: int, half: float,
          width: int = 5):
    """One scene: points [points, width] float32 (x, y, z, intensity, then
    zeros), boxes [boxes, 7] (bottom centre, w, l, h, yaw)."""
    b = np.concatenate([
        rng.uniform(-0.8 * half, 0.8 * half, (boxes, 2)),
        rng.uniform(-1.8, -1.2, (boxes, 1)),
        rng.uniform(0.6, 2.5, (boxes, 1)), rng.uniform(0.6, 5.0, (boxes, 1)),
        rng.uniform(1.0, 2.5, (boxes, 1)),
        rng.uniform(-np.pi, np.pi, (boxes, 1))], -1).astype(np.float32)
    n_obj = points // 2 if boxes else 0
    which = rng.randint(0, max(boxes, 1), n_obj)
    local = rng.uniform(-0.5, 0.5, (n_obj, 3)) * b[which, 3:6]
    c, s = np.cos(b[which, 6]), np.sin(b[which, 6])
    obj = np.stack([local[:, 0] * c - local[:, 1] * s + b[which, 0],
                    local[:, 0] * s + local[:, 1] * c + b[which, 1],
                    local[:, 2] + b[which, 2] + b[which, 5] / 2], -1)
    n_bg = points - n_obj
    bg = np.stack([rng.uniform(-half, half, n_bg),
                   rng.uniform(-half, half, n_bg),
                   rng.uniform(-2.0, 2.0, n_bg)], -1)
    pts = np.zeros((points, width), np.float32)
    pts[:, :3] = np.concatenate([obj, bg])
    pts[:, 3] = rng.rand(points)
    return pts, b


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _dump(infos: list, path: str) -> str:
    with open(path, "wb") as f:
        pickle.dump(dict(infos=infos, metadata=dict(version="synthetic")), f)
    return path


def _names_and_flags(rng, g: int, classes) -> dict:
    names = np.asarray([classes[i] for i in rng.randint(0, len(classes), g)])
    num_pts = rng.randint(0, 200, g)
    num_pts[: min(g, 2)] = (0, 50)[: min(g, 2)]
    return dict(gt_names=names, num_lidar_pts=num_pts,
                num_radar_pts=np.zeros(g, np.int64),
                valid_flag=num_pts > 0)


def write_nuscenes_set(root: str, seed: int = 0, frames: int = 4,
                       points: int = 2048, sweeps: int = 2,
                       sweep_points: int | None = None, boxes: int = 6,
                       half: float = 20.0, classes=NUSC_CLASSES,
                       info_name: str = "nuscenes_infos.pkl") -> str:
    """``frames`` keyframes of ``points`` five-channel points and
    ``sweeps`` past sweeps each (``sweep_points`` points, 50 ms apart,
    each moved by a small ``sensor2lidar`` rotation and translation), with
    ``boxes`` gt boxes of ``classes``; returns the info pkl's path
    (``root/info_name``). Lidar paths are relative to ``root``, sweep paths
    absolute, as the converter writes them."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
    sweep_points = points if sweep_points is None else sweep_points
    infos = []
    for f in range(frames):
        pts, b = scene(rng, points, boxes, half)
        pts[:, 4] = rng.randint(0, 32, points)  # the ring index
        rel = os.path.join("samples", f"{seed}_{f:04d}.bin")
        pts.tofile(os.path.join(root, rel))
        ts = 1_533_151_603_547_590 + f * 500_000
        sw = []
        for k in range(sweeps):
            sp, _ = scene(rng, sweep_points, boxes, half)
            path = os.path.abspath(os.path.join(
                root, "sweeps", f"{seed}_{f:04d}_{k}.bin"))
            sp.tofile(path)
            r = _rot_z(rng.uniform(-0.02, 0.02))
            sw.append(dict(
                data_path=path, type="lidar",
                sample_data_token=f"{seed}-{f}-{k}",
                timestamp=ts - (k + 1) * 50_000,
                sensor2lidar_rotation=r.T.astype(np.float32),
                sensor2lidar_translation=rng.uniform(
                    -0.5, 0.5, 3).astype(np.float32)))
        vel = rng.randn(boxes, 2)
        if boxes:
            vel[-1] = np.nan  # an annotation without velocity
        infos.append(dict(lidar_path=rel, token=f"{seed}-{f}", timestamp=ts,
                          sweeps=sw, gt_boxes=b, gt_velocity=vel,
                          **_names_and_flags(rng, boxes, classes)))
    return _dump(infos, os.path.join(root, info_name))


def write_argo2_set(root: str, seed: int = 0, frames: int = 4,
                    points: int = 2048, boxes: int = 6, half: float = 40.0,
                    log_id: str = "11111111-2222-3333-4444-555555555555",
                    info_name: str = "argo2_infos.pkl") -> str:
    """``frames`` Argo2 frames of one log (five-channel points, LiDAR-frame
    gt boxes of the 26 classes, ``uuid`` = ``log_id/timestamp_ns``);
    returns the info pkl's path."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "lidar"), exist_ok=True)
    infos = []
    for f in range(frames):
        pts, b = scene(rng, points, boxes, half)
        rel = os.path.join("lidar", f"{seed}_{f:04d}.bin")
        pts.tofile(os.path.join(root, rel))
        ts = 315_969_904_359_876_000 + f * 100_000_000
        infos.append(dict(lidar_path=rel, uuid=f"{log_id}/{ts}",
                          timestamp=ts, gt_boxes=b,
                          **_names_and_flags(rng, boxes, ARGO2_CLASSES)))
    return _dump(infos, os.path.join(root, info_name))


def write_kitti_set(root: str, seed: int = 0, frames: int = 4,
                    points: int = 2048, boxes: int = 6, half: float = 30.0,
                    info_name: str = "kitti_infos.pkl") -> str:
    """``frames`` KITTI frames: four-channel points, camera-frame annos
    (location, dimensions l-h-w, rotation_y, image bbox, occlusion,
    truncation) under a ``calib`` of R0_rect, Tr_velo_to_cam and P2;
    returns the info pkl's path."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    rect = np.eye(4, dtype=np.float32)
    trv2c = np.array([[0, -1, 0, 0], [0, 0, -1, -0.08], [1, 0, 0, -0.27],
                      [0, 0, 0, 1]], np.float32)
    p2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                   [0, 0, 1, 0.003], [0, 0, 0, 1]], np.float32)
    infos = []
    for f in range(frames):
        pts, b = scene(rng, points, boxes, half, width=4)
        b[:, 0] = np.abs(b[:, 0]) + 5.0  # in front of the camera
        pts[: points // 2, 0] = np.abs(pts[: points // 2, 0]) + 5.0
        rel = os.path.join("velodyne", f"{seed}_{f:06d}.bin")
        pts.tofile(os.path.join(root, rel))
        hom = np.concatenate([b[:, :3], np.ones((boxes, 1), np.float32)], 1)
        loc = (hom @ (rect @ trv2c).T)[:, :3]
        height = rng.uniform(20.0, 80.0, boxes)
        x1 = rng.uniform(0, 1000, boxes)
        y1 = rng.uniform(0, 250, boxes)
        annos = dict(
            name=np.asarray([KITTI_CLASSES[i] for i in
                             rng.randint(0, 3, boxes)]),
            location=loc.astype(np.float32),
            dimensions=b[:, [4, 5, 3]].astype(np.float32),
            rotation_y=(-b[:, 6] - np.pi / 2).astype(np.float32),
            bbox=np.stack([x1, y1, x1 + height, y1 + height],
                          -1).astype(np.float32),
            occluded=rng.randint(0, 3, boxes),
            truncated=rng.uniform(0, 0.4, boxes).astype(np.float32),
            num_points_in_gt=rng.randint(1, 100, boxes))
        infos.append(dict(
            point_cloud=dict(velodyne_path=rel, num_features=4),
            image=dict(image_idx=f, image_shape=np.array([375, 1242])),
            calib=dict(R0_rect=rect, Tr_velo_to_cam=trv2c, P2=p2),
            annos=annos))
    return _dump(infos, os.path.join(root, info_name))


def write_gt_database(root: str, classes, seed: int = 0, per_class: int = 8,
                      points: int = 64, width: int = 5,
                      info_name: str = "dbinfos.pkl") -> str:
    """A gt database for ``ObjectSample``: ``per_class`` objects of each
    class, their points (``width`` channels) in the object's frame (origin
    at the box centre) under ``root/gt_database``; returns the db pkl's
    path (class name → infos with ``path`` relative to ``root``,
    ``box3d_lidar``, ``name``, ``num_points_in_gt``, ``difficulty``)."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    db = {}
    for name in classes:
        db[name] = []
        for i in range(per_class):
            dims = rng.uniform(0.6, 4.0, 3).astype(np.float32)
            box = np.concatenate([rng.uniform(-30, 30, 2), [-1.5], dims,
                                  [rng.uniform(-np.pi, np.pi)]])
            n = rng.randint(points // 4, points + 1)
            obj = np.zeros((n, width), np.float32)
            obj[:, :3] = rng.uniform(-0.5, 0.5, (n, 3)) * dims
            obj[:, 3] = rng.rand(n)
            rel = os.path.join("gt_database", f"{name}_{i}.bin")
            obj.tofile(os.path.join(root, rel))
            db[name].append(dict(path=rel, name=name,
                                 box3d_lidar=box.astype(np.float32),
                                 num_points_in_gt=n,
                                 difficulty=int(rng.randint(0, 3))))
    path = os.path.join(root, info_name)
    with open(path, "wb") as f:
        pickle.dump(db, f)
    return path
