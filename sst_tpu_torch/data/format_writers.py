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
    # box frame to LiDAR frame: the inverse of the turn by -yaw that
    # core/boxes.py points_in_boxes takes a point into the box frame by
    c, s = np.cos(b[which, 6]), np.sin(b[which, 6])
    obj = np.stack([local[:, 0] * c + local[:, 1] * s + b[which, 0],
                    -local[:, 0] * s + local[:, 1] * c + b[which, 1],
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
# (l_lo, l_hi, w_lo, w_hi, h_lo, h_hi) per class, as flagship.py's priors
_CLASS_PRIORS = ((3.8, 5.5, 1.7, 2.2, 1.5, 2.0), (0.6, 1.0, 0.6, 1.0, 1.6, 1.9),
                 (1.6, 2.0, 0.6, 0.9, 1.5, 1.9))
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
                pts = scene_points(rng, b, points, half, width=6)
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


# Waymo's five lidars as the public dataset's vehicles mount them: name,
# extrinsic translation (m) and yaw (rad). TOP lists its 64 beams' angles;
# the four short-range lidars give only a min and a max.
WAYMO_TOP = (1, (1.43, 0.0, 2.184), 0.0148)
WAYMO_SIDES = ((2, (4.07, 0.0, 0.691), 0.0), (3, (3.245, 1.025, 0.981),
                                                np.pi / 2),
               (4, (3.245, -1.025, 0.981), -np.pi / 2),
               (5, (-1.154, 0.0, 0.466), np.pi))
WAYMO_TOP_INCLINATION = (-0.3075, 0.0416)  # rad, -17.6 and +2.4 degrees
WAYMO_SIDE_INCLINATION = (-1.5708, 0.5236)  # rad, -90 and +30 degrees
WAYMO_FRAME_S = 0.1  # s per frame (and per sweep of the TOP lidar)
WAYMO_SIDE_SHARE = 0.25  # of a frame's points, from the short-range lidars
WAYMO_SECOND_SHARE = 0.1  # of each lidar's points, from its second return


def _extrinsic(t, yaw) -> np.ndarray:
    e = np.eye(4)
    e[:3, :3] = _rot_z(yaw)
    e[:3, 3] = t
    return e


def _pixel_azimuth_col(az, az_corr, w):
    """The range-image column whose azimuth (``range_image_to_points``'
    ``((w - col - 0.5) / w * 2 - 1) * pi - az_corr``) is nearest ``az``."""
    a = (az + az_corr + np.pi) % (2 * np.pi) - np.pi
    return np.round(w - 0.5 - (a / np.pi + 1) * w / 2).astype(np.int64) % w


def _pixel_pose(pose: np.ndarray, w: int, speed: float) -> np.ndarray:
    """[w, 6] per-column vehicle poses of one sweep (roll, pitch, yaw, x,
    y, z): the frame's pose moved along its heading by ``speed`` times the
    column's time offset, column 0 at -half a sweep."""
    dt = ((np.arange(w) + 0.5) / w - 0.5) * WAYMO_FRAME_S
    yaw = np.arctan2(pose[1, 0], pose[0, 0])
    out = np.zeros((w, 6))
    out[:, 2] = yaw
    out[:, 3:6] = pose[:3, 3] + np.outer(dt * speed, pose[:3, 0])
    return out


def _fill_background(rng, img, free, n, incl_rows, height, far):
    """``n`` of the ``free`` [H, W] pixels of ``img`` [H, W, 4] get a
    return: the ground (z = 0 below a sensor at ``height``) where the beam
    meets it within ``far`` m, else a wall between 2 and ``far`` m; random
    intensity and elongation, not in a no-label zone."""
    rows, cols = np.nonzero(free)
    pick = rng.choice(len(rows), n, replace=False)
    rows, cols = rows[pick], cols[pick]
    sin_i = np.sin(incl_rows[rows])
    ground = height / np.maximum(-sin_i, 1e-6)
    on_ground = (sin_i < -0.02) & (ground < far) & (rng.rand(n) < 0.7)
    r = np.where(on_ground, ground * rng.uniform(0.98, 1.02, n),
                 rng.uniform(2.0, far, n))
    img[rows, cols] = np.stack([r, rng.rand(n), rng.uniform(0, 0.5, n),
                                np.full(n, -1.0)], -1)


def _second_returns(rng, img1, img2, n):
    """``n`` pixels holding a first return and no second one get a second
    one behind it."""
    rows, cols = np.nonzero((img1[..., 0] > 0) & (img2[..., 0] == 0))
    pick = rng.choice(len(rows), min(n, len(rows)), replace=False)
    rows, cols = rows[pick], cols[pick]
    img2[rows, cols] = img1[rows, cols]
    img2[rows, cols, 0] += rng.uniform(0.5, 5.0, len(rows))
    img2[rows, cols, 1] = rng.rand(len(rows))


def write_waymo_tfrecords(root: str, seed: int = 0, segments: int = 2,
                          frames: int = 4, points: int = 196608,
                          boxes: int = 40, top_shape=(64, 2650),
                          side_shape=(200, 600), sides: int = 4,
                          no_label_zone: int = 512) -> list:
    """Raw Waymo segments: one tfrecord of ``frames`` Frame protos
    (``data/waymo_proto.py``'s encoders) per segment under ``root``, at the
    sensors' geometry: a TOP lidar of ``top_shape`` pixels with both
    returns, its 64 beam inclinations and per-pixel rolling-shutter poses
    (the ego drives 10 m/s), and ``sides`` short-range lidars of
    ``side_shape`` pixels on the min / max inclination path, each with its
    own extrinsic. Every frame converts to exactly ``points`` points
    (``WAYMO_SIDE_SHARE`` of them from the short-range lidars,
    ``WAYMO_SECOND_SHARE`` of each lidar's from its second return), plus
    ``no_label_zone`` TOP
    pixels in a no-label zone that the converter drops.

    Each segment holds ``boxes`` labelled objects of the three classes
    (and one sign) moving at constant velocity in the world; their points
    sit on the TOP lidar's pixels, placed through the pixel poses so that
    they convert to points inside the boxes, and each label counts the
    points placed for it. About one object in seven gets none, so the
    converter drops its label. Returns the tfrecords' paths."""
    from sst_tpu_torch.core.waymo_bin import lidar_to_waymo_heading
    from sst_tpu_torch.data import waymo_proto as wp
    from sst_tpu_torch.data.incremental_dataset import box_frame_transform_np

    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    th, tw = top_shape
    sh, sw = side_shape
    lo, hi = WAYMO_TOP_INCLINATION
    step = (hi - lo) / (th - 1)
    top_incl = np.linspace(lo, hi, th) + rng.uniform(-0.2, 0.2, th) * step
    top_rows = top_incl[::-1]  # row 0 = the highest beam
    slo, shi = WAYMO_SIDE_INCLINATION
    side_rows = (slo + (0.5 + np.arange(sh)) / sh * (shi - slo))[::-1]
    top_ext = _extrinsic(*WAYMO_TOP[1:])
    cal = wp.enc_bytes(3, wp.enc_laser_calibration(
        WAYMO_TOP[0], top_ext, beam_inclinations=top_incl))
    for name, t, yaw in WAYMO_SIDES[:sides]:
        cal += wp.enc_bytes(3, wp.enc_laser_calibration(
            name, _extrinsic(t, yaw), incl_min=slo, incl_max=shi))
    n_side = int(round(points * WAYMO_SIDE_SHARE)) // sides if sides else 0
    n_top = points - n_side * sides
    speed = 1.0 / WAYMO_FRAME_S  # m/s: _ego_pose moves 1 m per frame
    paths = []
    for q in range(segments):
        ctx = f"seg-{seed}-{q:03d}"
        cls = rng.randint(0, 3, boxes)
        dims = np.zeros((boxes, 3))
        for k, c in enumerate(cls):
            prior = _CLASS_PRIORS[c]
            dims[k] = (rng.uniform(*prior[2:4]), rng.uniform(*prior[0:2]),
                       rng.uniform(*prior[4:6]))  # w, l, h
        rad = rng.uniform(8.0, 50.0, boxes)
        ang = rng.uniform(-np.pi, np.pi, boxes)
        start = np.concatenate([
            np.stack([rad * np.cos(ang), rad * np.sin(ang),
                      np.zeros(boxes)], -1), dims,
            rng.uniform(-np.pi, np.pi, (boxes, 1))], -1).astype(np.float32)
        world = box_frame_transform_np(start, _ego_pose(q, 0), np.eye(4))
        velo = rng.uniform(-1.0, 1.0, (boxes, 2)) * (cls == 0)[:, None]
        hidden = rng.rand(boxes) < 1 / 7
        records = []
        for f in range(frames):
            pose = _ego_pose(q, f)
            wb = world.copy()
            wb[:, :2] += velo * WAYMO_FRAME_S * f
            b = box_frame_transform_np(wb, np.eye(4),
                                       np.linalg.inv(pose)).astype(
                                           np.float64)
            # the objects' points in this frame's vehicle frame
            r_box = np.hypot(b[:, 0], b[:, 1])
            n_obj = np.where(hidden, 0, np.clip(
                2500.0 * points / 196608 * np.sqrt(b[:, 3] * b[:, 4])
                / np.maximum(r_box, 5.0), 8, 1200).astype(np.int64))
            which = np.repeat(np.arange(boxes), n_obj)
            local = rng.uniform(-0.4, 0.4, (len(which), 3)) * b[which, 3:6]
            c, s = np.cos(b[which, 6]), np.sin(b[which, 6])
            obj = np.stack([local[:, 0] * c + local[:, 1] * s + b[which, 0],
                            -local[:, 0] * s + local[:, 1] * c + b[which, 1],
                            local[:, 2] + b[which, 2] + b[which, 5] / 2], -1)
            # through the pixel poses into the TOP sensor frame: the column
            # first from the frame's pose, then again from its own pose
            ppose = _pixel_pose(pose, tw, speed)
            world_pts = obj @ pose[:3, :3].T + pose[:3, 3]
            az_corr = np.arctan2(top_ext[1, 0], top_ext[0, 0])
            sensor = (obj - top_ext[:3, 3]) @ top_ext[:3, :3]
            col = _pixel_azimuth_col(np.arctan2(sensor[:, 1], sensor[:, 0]),
                                     az_corr, tw)
            for _ in range(2):
                pp = ppose[col]
                rot = np.stack([np.cos(pp[:, 2]), -np.sin(pp[:, 2]),
                                np.sin(pp[:, 2]), np.cos(pp[:, 2])],
                               -1).reshape(-1, 2, 2)
                veh = world_pts - pp[:, 3:6]
                veh[:, :2] = np.einsum("nji,nj->ni", rot, veh[:, :2])
                sensor = (veh - top_ext[:3, 3]) @ top_ext[:3, :3]
                col = _pixel_azimuth_col(
                    np.arctan2(sensor[:, 1], sensor[:, 0]), az_corr, tw)
            rng_ = np.linalg.norm(sensor, axis=-1)
            incl = np.arcsin(sensor[:, 2] / rng_)
            row = np.abs(top_rows[None, :] - incl[:, None]).argmin(1)
            seen = np.abs(top_rows[row] - incl) <= step
            img1 = np.zeros((th, tw, 4))
            img2 = np.zeros((th, tw, 4))
            counts = np.zeros(boxes, np.int64)
            for ret in (img1, img2):
                flat = row * tw + col
                order = np.flatnonzero(seen)
                first = order[np.unique(flat[order], return_index=True)[1]]
                first = first[ret[row[first], col[first], 0] == 0]
                ret[row[first], col[first]] = np.stack([
                    rng_[first], rng.rand(len(first)),
                    rng.uniform(0, 0.5, len(first)),
                    np.full(len(first), -1.0)], -1)
                np.add.at(counts, which[first], 1)
                seen[first] = False
            n_top2 = int(round(n_top * WAYMO_SECOND_SHARE))
            n_obj2 = int((img2[..., 0] > 0).sum())
            _fill_background(rng, img1, img1[..., 0] == 0,
                             n_top - n_top2 - int((img1[..., 0] > 0).sum()),
                             top_rows, top_ext[2, 3], 75.0)
            _second_returns(rng, img1, img2, n_top2 - n_obj2)
            nlz = np.zeros((th, tw, 4))
            _fill_background(rng, nlz, img1[..., 0] == 0, no_label_zone,
                             top_rows, top_ext[2, 3], 75.0)
            nlz[..., 3] = np.where(nlz[..., 0] > 0, 1.0, 0.0)
            img1 += nlz
            pix = np.broadcast_to(ppose[None], (th, tw, 6))
            lasers = [wp.enc_varint(1, WAYMO_TOP[0])
                      + wp.enc_bytes(2, wp.enc_range_image(img1, pose=pix))
                      + wp.enc_bytes(3, wp.enc_range_image(img2))]
            for name, t, _ in WAYMO_SIDES[:sides]:
                s1 = np.zeros((sh, sw, 4))
                s2 = np.zeros((sh, sw, 4))
                n2 = int(round(n_side * WAYMO_SECOND_SHARE))
                _fill_background(rng, s1, s1[..., 0] == 0, n_side - n2,
                                 side_rows, t[2], 20.0)
                _second_returns(rng, s1, s2, n2)
                lasers.append(wp.enc_varint(1, name)
                              + wp.enc_bytes(2, wp.enc_range_image(s1))
                              + wp.enc_bytes(3, wp.enc_range_image(s2)))
            rot_inv = pose[:3, :3].T
            labels = []
            for k in range(boxes):
                bx = b[k]
                vel = rot_inv[:2, :2] @ velo[k]
                labels.append(wp.enc_label(
                    (bx[0], bx[1], bx[2] + bx[5] / 2, bx[4], bx[3], bx[5],
                     lidar_to_waymo_heading(float(bx[6]))),
                    WAYMO_TYPES[WAYMO_CLASSES[cls[k]]], f"{ctx}-obj{k}",
                    int(counts[k]), difficulty=1 if counts[k] > 5 else 2,
                    speed=(float(vel[0]), float(vel[1]))))
            labels.append(wp.enc_label(
                (15.0, 4.0, 1.0, 0.3, 0.3, 2.0, 0.0), 3, f"{ctx}-sign",
                10))
            ts = 1_560_000_000_000_000 + q * 10**9 + f * 100_000
            records.append(wp.enc_frame(ctx, ts, pose, cal, lasers, labels))
        path = os.path.join(root, f"segment-{seed}-{q:03d}.tfrecord")
        wp.write_tfrecord(path, records)
        paths.append(path)
    return paths


# nuScenes' raw category names, one per detection class
NUSC_RAW_NAMES = ("vehicle.car", "vehicle.truck", "vehicle.trailer",
                  "vehicle.bus.rigid", "vehicle.construction",
                  "vehicle.bicycle", "vehicle.motorcycle",
                  "human.pedestrian.adult", "movable_object.trafficcone",
                  "movable_object.barrier")
# the LIDAR_TOP mount of the nuScenes vehicles (translation, [w, x, y, z])
NUSC_LIDAR = ([0.943713, 0.0, 1.84023],
              [0.7077955119163518, -0.006492242056004365,
               0.010646214713995808, -0.7063073142877817])


def _quat_z(theta: float) -> list:
    return [float(np.cos(theta / 2)), 0.0, 0.0, float(np.sin(theta / 2))]


NUSC_SWEEPS_BETWEEN = 9  # LIDAR_TOP sweeps at 20 Hz between 2 Hz keyframes


def write_nuscenes_tables(root: str, seed: int = 0, scenes: int = 2,
                          keyframes: int = 4, points: int = 34720,
                          objects: int = 20) -> dict:
    """A nuScenes v1.0-trainval table set under ``root`` (the JSON schema
    ``tools/data_converter/nuscenes_converter.py`` reads) and its lidar
    files: ``scenes`` scenes of ``keyframes`` LIDAR_TOP keyframes 0.5 s
    apart with 9 sweeps between two of them (20 Hz) and 10 before the
    first, so every keyframe has a 10-sweep chain; ``points`` five-channel points per file (the sensor's
    32 beams x 1085). The ego drives 5 m/s along a turning path; the lidar
    sits on nuScenes' mount. ``objects`` instances per scene, of every
    detection class, move at constant velocity, annotated in every
    keyframe; one more is annotated in one keyframe only (its velocity is
    NaN). Returns dict(root, version, val_scenes: the last scene's name)."""
    import json

    rng = np.random.RandomState(seed)
    version = "v1.0-trainval"
    tdir = os.path.join(root, version)
    for d in (tdir, os.path.join(root, "samples", "LIDAR_TOP"),
              os.path.join(root, "sweeps", "LIDAR_TOP")):
        os.makedirs(d, exist_ok=True)
    t = {k: [] for k in ("scene", "log", "sensor", "calibrated_sensor",
                         "sample", "sample_data", "ego_pose",
                         "sample_annotation", "instance", "category")}
    t["sensor"].append(dict(token="se_lidar", channel="LIDAR_TOP",
                            modality="lidar"))
    t["calibrated_sensor"].append(dict(
        token="cs_lidar", sensor_token="se_lidar",
        translation=NUSC_LIDAR[0], rotation=NUSC_LIDAR[1],
        camera_intrinsic=[]))
    for i, name in enumerate(NUSC_RAW_NAMES):
        t["category"].append(dict(token=f"cat{i}", name=name))
    pre = NUSC_SWEEPS_BETWEEN + 1
    step_us = 500_000 // pre
    for sc in range(scenes):
        t0 = 1_533_151_600_000_000 + sc * 10**9
        t["log"].append(dict(token=f"log{sc}", location="synthetic"))
        t["scene"].append(dict(
            token=f"sc{sc}", name=f"scene-{seed:02d}{sc:02d}",
            log_token=f"log{sc}", nbr_samples=keyframes,
            first_sample_token=f"s{sc}_0",
            last_sample_token=f"s{sc}_{keyframes - 1}"))
        yaw0 = rng.uniform(-np.pi, np.pi)
        start = rng.uniform(-500, 500, 2)

        def ego(ts):
            dt = (ts - t0) * 1e-6
            yaw = yaw0 + 0.05 * dt
            xy = start + 5.0 * dt * np.array([np.cos(yaw), np.sin(yaw)])
            return [float(xy[0]), float(xy[1]), 0.0], _quat_z(yaw)

        # the sample_data chain: ``pre`` sweeps, then a keyframe every
        # ``pre`` files
        prev = ""
        for j in range(pre + (keyframes - 1) * pre + 1):
            key = j >= pre and (j - pre) % pre == 0
            k = max(j - 1, 0) // pre
            ts = t0 + (j - pre) * step_us
            tok = f"sd{sc}_{j}"
            tr, rot = ego(ts)
            t["ego_pose"].append(dict(token=f"ep{sc}_{j}", timestamp=ts,
                                      translation=tr, rotation=rot))
            folder = "samples" if key else "sweeps"
            fname = f"{folder}/LIDAR_TOP/n{seed}-{sc}__LIDAR_TOP__{ts}.bin"
            pts = np.zeros((points, 5), np.float32)
            pts[:, 0:2] = rng.uniform(-50, 50, (points, 2))
            pts[:, 2] = rng.uniform(-2.0, 2.0, points)
            pts[:, 3] = rng.uniform(0, 255, points)
            pts[:, 4] = rng.randint(0, 32, points)
            pts.tofile(os.path.join(root, fname))
            t["sample_data"].append(dict(
                token=tok, sample_token=f"s{sc}_{k}",
                calibrated_sensor_token="cs_lidar",
                ego_pose_token=f"ep{sc}_{j}", timestamp=ts,
                is_key_frame=bool(key), filename=fname, fileformat="pcd",
                prev=prev, next=""))
            if prev:
                t["sample_data"][-2]["next"] = tok
            prev = tok
            if key:
                t["sample"].append(dict(
                    token=f"s{sc}_{k}", timestamp=ts, scene_token=f"sc{sc}",
                    prev=f"s{sc}_{k - 1}" if k else "",
                    next=f"s{sc}_{k + 1}" if k + 1 < keyframes else ""))
        # the objects, in the world frame at the first keyframe
        cls = np.concatenate([np.arange(len(NUSC_RAW_NAMES)), rng.randint(
            0, len(NUSC_RAW_NAMES), max(objects - len(NUSC_RAW_NAMES), 0))])
        ego0 = np.asarray(ego(t0)[0])
        for o in range(len(cls) + 1):
            c = int(cls[o]) if o < len(cls) else 0
            inst = f"in{sc}_{o}"
            frames = range(keyframes) if o < len(cls) else [keyframes // 2]
            pos = ego0 + np.concatenate([rng.uniform(-40, 40, 2),
                                         [rng.uniform(0.5, 1.5)]])
            vel = np.concatenate([rng.uniform(-3, 3, 2), [0.0]])
            size = [float(v) for v in rng.uniform([0.5, 0.5, 1.0],
                                                  [3.0, 8.0, 3.5])]
            yaw = rng.uniform(-np.pi, np.pi)
            toks = [f"a{sc}_{o}_{k}" for k in frames]
            t["instance"].append(dict(
                token=inst, category_token=f"cat{c}",
                nbr_annotations=len(toks), first_annotation_token=toks[0],
                last_annotation_token=toks[-1]))
            for n, k in enumerate(frames):
                p = pos + vel * 0.5 * k
                t["sample_annotation"].append(dict(
                    token=toks[n], sample_token=f"s{sc}_{k}",
                    instance_token=inst,
                    translation=[float(v) for v in p], size=size,
                    rotation=_quat_z(yaw), prev=toks[n - 1] if n else "",
                    next=toks[n + 1] if n + 1 < len(toks) else "",
                    num_lidar_pts=int(rng.randint(0, 300)) if n else 0,
                    num_radar_pts=int(rng.randint(0, 5)),
                    visibility_token="4", attribute_tokens=[]))
    for name, rows in t.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return dict(root=root, version=version,
                val_scenes={t["scene"][-1]["name"]})


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
