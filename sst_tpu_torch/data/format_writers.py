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

:func:`write_waymo_set` writes Waymo's kitti format as the converter
(``tools/data_converter/waymo_converter.py``) lays it out: sequences of
frames whose ego moves, six-channel points, camera-frame annos, ego poses,
``idx2timestamp.pkl`` / ``idx2contextname.pkl`` and a tfrecord of the
frames' labels (``data/waymo_proto.py``). :func:`assign_track_ids` links a
detector's boxes over each sequence into tracks, a tracker's output.
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


def _random_boxes(rng: np.random.RandomState, boxes: int, half: float):
    return np.concatenate([
        rng.uniform(-0.8 * half, 0.8 * half, (boxes, 2)),
        rng.uniform(-1.8, -1.2, (boxes, 1)),
        rng.uniform(0.6, 2.5, (boxes, 1)), rng.uniform(0.6, 5.0, (boxes, 1)),
        rng.uniform(1.0, 2.5, (boxes, 1)),
        rng.uniform(-np.pi, np.pi, (boxes, 1))], -1).astype(np.float32)


def scene(rng: np.random.RandomState, points: int, boxes: int, half: float,
          width: int = 5):
    """One scene: points [points, width] float32 (x, y, z, intensity, then
    zeros), boxes [boxes, 7] (bottom centre, w, l, h, yaw)."""
    b = _random_boxes(rng, boxes, half)
    return scene_points(rng, b, points, half, width), b


def scene_points(rng: np.random.RandomState, b: np.ndarray, points: int,
                 half: float, width: int = 5) -> np.ndarray:
    """[points, width] float32: half of them inside the boxes ``b`` [M, 7],
    the rest over the square of half-width ``half``, z in [-2, 2]."""
    boxes = len(b)
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
    return pts


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


WAYMO_CLASSES = ("Car", "Pedestrian", "Cyclist")
WAYMO_TYPES = {"Car": 1, "Pedestrian": 2, "Cyclist": 4}  # label.proto Type
# the kitti-format calibration the Waymo layout's infos carry
_WAYMO_RECT = np.eye(4)
_WAYMO_VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                               [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def _ego_pose(seq: int, frame: int) -> np.ndarray:
    """The ego → world pose of a frame: 1 m forward and a 0.02 rad turn per
    frame from a start that differs per sequence."""
    pose = np.eye(4)
    pose[:3, :3] = _rot_z(0.3 * seq + 0.02 * frame)
    pose[:3, 3] = (100.0 * seq + 1.0 * frame, -50.0 * seq + 0.2 * frame, 0.0)
    return pose


def write_waymo_set(root: str, seed: int = 0, train_sequences: int = 2,
                    val_sequences: int = 2, frames: int = 4,
                    points: int = 2048, boxes: int = 12,
                    half: float = 30.0,
                    train_frames: int | None = None) -> dict:
    """A Waymo set in the converter's kitti format under ``root``:
    ``train_sequences`` sequences of ``train_frames`` (default
    ``frames``) frames and ``val_sequences`` of ``frames``, each frame of
    ``points`` six-channel points (x, y, z, intensity, elongation,
    0) with ``boxes`` objects of the three classes that move at constant
    velocity in the world while the ego drives (``info["pose"]``). Frame f
    of sequence q has ``image_idx = split * 1_000_000 + q * 1000 + f``
    (split 0 training, 1 validation), its points at
    ``{training,validation}/velodyne/%07d.bin``, camera-frame annos with
    ``num_points_in_gt``, ``difficulty`` and ``obj_ids``, a ``calib`` and
    a timestamp 0.1 s after the one before. Writes
    ``waymo_infos_train.pkl``, ``waymo_infos_val.pkl``,
    ``idx2timestamp.pkl``, ``idx2contextname.pkl`` and
    ``tfrecords/segments.tfrecord`` (every frame's context, timestamp,
    pose and labels); returns their paths."""
    import torch

    from sst_tpu_torch.core.boxes import points_in_boxes
    from sst_tpu_torch.core.waymo_bin import lidar_to_waymo_heading
    from sst_tpu_torch.data import waymo_proto as wp
    from sst_tpu_torch.data.incremental_dataset import box_frame_transform_np

    rng = np.random.RandomState(seed)
    cam = _WAYMO_RECT @ _WAYMO_VELO_TO_CAM
    idx2ts, idx2ctx, records, out = {}, {}, [], {"root": root}
    for split, (name, n_seq, n_frames, info_name) in enumerate((
            ("training", train_sequences, train_frames or frames,
             "waymo_infos_train.pkl"),
            ("validation", val_sequences, frames, "waymo_infos_val.pkl"))):
        os.makedirs(os.path.join(root, name, "velodyne"), exist_ok=True)
        infos = []
        for q in range(n_seq):
            ctx = f"seg-{seed}-{name}-{q:03d}"
            world = box_frame_transform_np(
                _random_boxes(rng, boxes, half), _ego_pose(q, 0),
                np.eye(4))
            velo = rng.uniform(-1.0, 1.0, (boxes, 2))
            names = [WAYMO_CLASSES[i] for i in rng.randint(0, 3, boxes)]
            ids = [f"{ctx}-obj{k}" for k in range(boxes)]
            for f in range(n_frames):
                image_idx = split * 1_000_000 + q * 1000 + f
                key = f"{image_idx:07d}"
                ts = 1_550_000_000_000_000 + (split * 100 + q) * 10**9 \
                    + f * 100_000
                pose = _ego_pose(q, f)
                wb = world.copy()
                wb[:, :2] += velo * 0.1 * f
                b = box_frame_transform_np(wb, np.eye(4), np.linalg.inv(pose))
                # scene_points turns a box's points by the yaw's opposite
                # sign to core/boxes.py points_in_boxes, the containment
                # the models and tools test: given -yaw, they lie in b
                pts = scene_points(rng, b * np.float32([1] * 6 + [-1]),
                                   points, half, width=6)
                pts[:, 4] = rng.rand(points)  # elongation
                rel = os.path.join(name, "velodyne", f"{key}.bin")
                pts.tofile(os.path.join(root, rel))
                num_pts = points_in_boxes(
                    torch.from_numpy(pts[:, :3]),
                    torch.from_numpy(b)).sum(0).int().numpy()
                hom = np.concatenate([b[:, :3], np.ones((boxes, 1))], 1)
                annos = dict(
                    name=np.asarray(names),
                    location=(hom @ cam.T)[:, :3].astype(np.float32),
                    dimensions=b[:, [4, 5, 3]].astype(np.float32),
                    rotation_y=(-b[:, 6] - np.pi / 2).astype(np.float32),
                    truncated=np.zeros(boxes, np.float32),
                    occluded=np.zeros(boxes, np.int32),
                    alpha=np.full(boxes, -10.0, np.float32),
                    bbox=np.tile(np.array([[0.0, 0.0, 100.0, 100.0]],
                                          np.float32), (boxes, 1)),
                    num_points_in_gt=num_pts,
                    difficulty=rng.randint(1, 3, boxes).astype(np.int32),
                    obj_ids=np.asarray(ids))
                infos.append(dict(
                    point_cloud=dict(velodyne_path=rel, num_features=6),
                    image=dict(image_idx=image_idx), pose=pose,
                    calib=dict(R0_rect=_WAYMO_RECT.copy(),
                               Tr_velo_to_cam=_WAYMO_VELO_TO_CAM.copy()),
                    timestamp=ts, context=ctx, annos=annos))
                idx2ts[key] = ts
                idx2ctx[key] = ctx
                labels = [wp.enc_label(
                    (box[0], box[1], box[2] + box[5] / 2, box[4], box[3],
                     box[5], lidar_to_waymo_heading(float(box[6]))),
                    WAYMO_TYPES[n], oid, int(c), difficulty=int(d))
                    for box, n, oid, c, d in zip(
                        b.astype(np.float64), names, ids, num_pts,
                        annos["difficulty"])]
                records.append(wp.enc_frame(ctx, ts, pose, b"", [], labels))
        out[name] = os.path.join(root, info_name)
        with open(out[name], "wb") as fh:
            pickle.dump(infos, fh)
    for fname, obj in (("idx2timestamp.pkl", idx2ts),
                       ("idx2contextname.pkl", idx2ctx)):
        with open(os.path.join(root, fname), "wb") as fh:
            pickle.dump(obj, fh)
    os.makedirs(os.path.join(root, "tfrecords"), exist_ok=True)
    out["tfrecord"] = os.path.join(root, "tfrecords", "segments.tfrecord")
    wp.write_tfrecord(out["tfrecord"], records)
    return out


def assign_track_ids(frames: dict, poses: dict, max_dist: float = 3.0,
                     per_frame: int | None = None) -> dict:
    """A tracker's output made from per-frame detections: ``frames``
    {(context, timestamp): dict(boxes [N, 7+] in the frame's ego frame,
    scores, labels)}, ``poses`` {context: {timestamp: 4x4 ego → world}}.
    Over each sequence in time order, a box of the same label within
    ``max_dist`` m (world frame) of a track's last box continues the track
    (greedy, highest score first), else starts one. ``per_frame`` keeps
    each frame's highest-scoring boxes only. Returns the frames in
    ``write_waymo_bin``'s layout with ``obj_ids``, ``context_name`` and
    ``timestamp_micros``."""
    from sst_tpu_torch.data.incremental_dataset import box_frame_transform_np

    out, n_tracks = [], 0
    by_ctx: dict = {}
    for (ctx, ts) in frames:
        by_ctx.setdefault(ctx, []).append(ts)
    for ctx in sorted(by_ctx):
        last: list = []  # (track id, label, world xy)
        for ts in sorted(by_ctx[ctx]):
            fr = frames[(ctx, ts)]
            order = np.argsort(-np.asarray(fr["scores"]), kind="stable")
            order = order[:per_frame]
            boxes = np.asarray(fr["boxes"], np.float32)[order, :7]
            labels = np.asarray(fr["labels"])[order]
            world = box_frame_transform_np(boxes, poses[ctx][ts], np.eye(4))
            ids, free, now = [], list(range(len(last))), []
            for b, lab in zip(world, labels):
                d = [np.hypot(*(b[:2] - last[j][2])) if last[j][1] == lab
                     else np.inf for j in free]
                if d and min(d) <= max_dist:
                    j = free.pop(int(np.argmin(d)))
                    tid = last[j][0]
                else:
                    tid = f"{ctx}-trk{n_tracks}"
                    n_tracks += 1
                ids.append(tid)
                now.append((tid, lab, b[:2]))
            last = now
            out.append(dict(boxes=boxes,
                            scores=np.asarray(fr["scores"],
                                              np.float32)[order],
                            labels=labels, obj_ids=ids, context_name=ctx,
                            timestamp_micros=ts))
    return out
