"""nuScenes (or Lyft) relational tables → the info pkls the port's
datasets read, with no devkit (counterpart of the JAX package's
``tools/data_converter/nuscenes_converter.py``).

    python -m sst_tpu_torch.tools.data_converter.nuscenes_converter \\
        --root-path data/nuscenes --version v1.0-trainval \\
        [--max-sweeps 10] [--val-scenes FILE | --val-ratio R] \\
        [--out-dir DIR] [--format nuscenes|lyft]

The JSON tables of ``<root>/<version>/`` (sample, sample_data,
calibrated_sensor, ego_pose, sample_annotation, instance, category, scene,
log, sensor) are read directly. Per LIDAR_TOP keyframe the info holds
lidar_path, token, timestamp, sweeps (sensor2lidar R / T per sweep),
lidar2ego_* / ego2global_*, gt_boxes [G, 7] in the lidar frame ([x y z w l
h yaw], yaw = -yaw' - pi/2, the SECOND convention), gt_names (the 10
detection classes), gt_velocity [G, 2] in the lidar frame (NaN where the
devkit's box_velocity has none), num_lidar_pts, num_radar_pts and
valid_flag: ``data/datasets.py NuScenesDataset``'s schema.

Splits: the official trainval scene lists live in the devkit; here the
official v1.0-mini lists are embedded, ``--val-scenes`` names the val
scenes one per line, or ``--val-ratio`` splits by a hash of the scene name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle

import numpy as np

NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

# official v1.0-mini scene splits (devkit nuscenes/utils/splits.py)
MINI_TRAIN = ("scene-0061", "scene-0553", "scene-0655", "scene-0757",
              "scene-0796", "scene-1077", "scene-1094", "scene-1100")
MINI_VAL = ("scene-0103", "scene-0916")


# ------------------------------------------------------------- quaternions
# nuScenes stores rotations as [w, x, y, z] unit quaternions.


def quat_to_rot(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_mult(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw)


def quat_inv(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def quat_yaw(q) -> np.float64:
    """yaw_pitch_roll[0] of the devkit: z-axis rotation component (a numpy
    float64, so a float32 array minus it is taken in float64)."""
    w, x, y, z = q
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


# ------------------------------------------------------------- table access


class NuScenesTables:
    """Minimal relational view over the nuScenes JSON tables."""

    TABLES = ("sample", "sample_data", "calibrated_sensor", "ego_pose",
              "sample_annotation", "instance", "category", "scene", "log",
              "sensor")

    def __init__(self, root: str, version: str):
        self.root = root
        self.version = version
        tdir = os.path.join(root, version)
        self.t = {}
        for name in self.TABLES:
            path = os.path.join(tdir, f"{name}.json")
            rows = json.load(open(path)) if os.path.exists(path) else []
            self.t[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self.t[table][token]

    def rows(self, table: str):
        return self.t[table].values()


def _sensor_to_lidar(tables, sd_rec, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat,
                     sensor_type: str) -> dict:
    """obtain_sensor2top semantics (nuscenes_converter.py:272-330):
    sweep sensor frame → ego_s → global → ego' → current lidar, packed as
    points @ R + T (sensor2lidar_rotation stored transposed exactly like
    the reference so `pts @ rot + trans` reproduces it)."""
    cs = tables.get("calibrated_sensor", sd_rec["calibrated_sensor_token"])
    pose = tables.get("ego_pose", sd_rec["ego_pose_token"])
    l2e_r_s_mat = quat_to_rot(cs["rotation"])
    e2g_r_s_mat = quat_to_rot(pose["rotation"])
    l2e_t_s = np.asarray(cs["translation"])
    e2g_t_s = np.asarray(pose["translation"])
    inv = np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    R = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ inv
    T = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ inv
    T -= e2g_t @ inv + l2e_t @ np.linalg.inv(l2e_r_mat).T
    return {
        "data_path": os.path.join(tables.root, sd_rec["filename"]),
        "type": sensor_type,
        "sample_data_token": sd_rec["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd_rec["timestamp"],
        "sensor2lidar_rotation": R.T,
        "sensor2lidar_translation": T,
    }


def box_velocity(tables, ann_token: str, max_time_diff: float = 1.5):
    """Devkit box_velocity semantics: finite difference of the SAME
    instance's neighboring annotation positions in GLOBAL frame; one-sided
    when an endpoint is missing; nan when isolated or too far apart."""
    ann = tables.get("sample_annotation", ann_token)
    has_prev = bool(ann["prev"])
    has_next = bool(ann["next"])
    if not has_prev and not has_next:
        return np.array([np.nan, np.nan, np.nan])
    first = tables.get("sample_annotation", ann["prev"]) if has_prev else ann
    last = tables.get("sample_annotation", ann["next"]) if has_next else ann
    pos_f = np.asarray(first["translation"], float)
    pos_l = np.asarray(last["translation"], float)
    t_f = 1e-6 * tables.get("sample", first["sample_token"])["timestamp"]
    t_l = 1e-6 * tables.get("sample", last["sample_token"])["timestamp"]
    if t_l - t_f > max_time_diff:
        return np.array([np.nan, np.nan, np.nan])
    return (pos_l - pos_f) / max(t_l - t_f, 1e-6)


def _fill_infos(tables: NuScenesTables, train_scene_tokens, max_sweeps: int,
                test: bool, name_mapping=None):
    name_mapping = NAME_MAPPING if name_mapping is None else name_mapping
    train_infos, val_infos = [], []
    samples = sorted(tables.rows("sample"), key=lambda s: s["timestamp"])
    sd_by_sample = {}
    for sd in tables.rows("sample_data"):
        sd_by_sample.setdefault(sd["sample_token"], []).append(sd)
    ann_by_sample = {}
    for a in tables.rows("sample_annotation"):
        ann_by_sample.setdefault(a["sample_token"], []).append(a)

    for sample in samples:
        lidar_sd = None
        for sd in sd_by_sample.get(sample["token"], []):
            sensor = tables.get(
                "sensor",
                tables.get("calibrated_sensor",
                           sd["calibrated_sensor_token"])["sensor_token"])
            if sensor["channel"] == "LIDAR_TOP" and sd["is_key_frame"]:
                lidar_sd = sd
                break
        if lidar_sd is None:
            continue
        cs = tables.get("calibrated_sensor",
                        lidar_sd["calibrated_sensor_token"])
        pose = tables.get("ego_pose", lidar_sd["ego_pose_token"])
        l2e_r_mat = quat_to_rot(cs["rotation"])
        e2g_r_mat = quat_to_rot(pose["rotation"])
        l2e_t = np.asarray(cs["translation"])
        e2g_t = np.asarray(pose["translation"])
        info = {
            "lidar_path": os.path.join(tables.root, lidar_sd["filename"]),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }

        sd_rec = lidar_sd
        while len(info["sweeps"]) < max_sweeps and sd_rec["prev"]:
            sd_rec = tables.get("sample_data", sd_rec["prev"])
            info["sweeps"].append(_sensor_to_lidar(
                tables, sd_rec, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat, "lidar"))

        if not test:
            anns = ann_by_sample.get(sample["token"], [])
            # lidar-frame quaternion: q_lidar = q_l2e^-1 * q_e2g^-1 * q_g
            q_le = quat_inv(tuple(cs["rotation"]))
            q_eg = quat_inv(tuple(pose["rotation"]))
            locs, dims, yaws, names, vels = [], [], [], [], []
            nlp, nrp = [], []
            for a in anns:
                c = np.asarray(a["translation"], float)
                c = np.linalg.inv(l2e_r_mat) @ (
                    np.linalg.inv(e2g_r_mat) @ (c - e2g_t) - l2e_t)
                q = quat_mult(q_le, quat_mult(q_eg, tuple(a["rotation"])))
                cat = tables.get("instance",
                                 a["instance_token"])["category_token"] \
                    if "category_name" not in a else None
                raw_name = a.get("category_name") or tables.get(
                    "category", cat)["name"]
                locs.append(c)
                dims.append(a["size"])  # nuScenes size = [w, l, h]
                yaws.append(quat_yaw(q))
                names.append(name_mapping.get(raw_name, raw_name))
                v = box_velocity(tables, a["token"])
                v = np.linalg.inv(l2e_r_mat) @ (np.linalg.inv(e2g_r_mat) @ v)
                vels.append(v[:2])
                nlp.append(a.get("num_lidar_pts", 0))
                nrp.append(a.get("num_radar_pts", 0))
            g = len(anns)
            locs = np.asarray(locs, float).reshape(g, 3)
            dims = np.asarray(dims, float).reshape(g, 3)
            yaws = np.asarray(yaws, float).reshape(g, 1)
            # SECOND yaw convention (reference :254)
            info["gt_boxes"] = np.concatenate(
                [locs, dims, -yaws - np.pi / 2], axis=1)
            info["gt_names"] = np.asarray(names)
            info["gt_velocity"] = np.asarray(vels, float).reshape(g, 2)
            info["num_lidar_pts"] = np.asarray(nlp, np.int64)
            info["num_radar_pts"] = np.asarray(nrp, np.int64)
            info["valid_flag"] = (info["num_lidar_pts"]
                                  + info["num_radar_pts"]) > 0

        if sample["scene_token"] in train_scene_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(root_path: str, info_prefix: str = "nuscenes",
                          version: str = "v1.0-mini", max_sweeps: int = 10,
                          val_scene_names=None, val_ratio: float = 0.0,
                          out_dir: str | None = None, fmt: str = "nuscenes"):
    """fmt="lyft": Lyft L5 ships the same relational table format (its
    devkit is a nuScenes-devkit fork); its category names are already flat
    (car/truck/bus/...), so the raw->detection name mapping is identity,
    and annotations carry no lidar/radar point counts (valid_flag all
    True). Counterpart of the reference's lyft_converter.py."""
    tables = NuScenesTables(root_path, version)
    test = "test" in version
    scenes = list(tables.rows("scene"))
    if val_scene_names is None:
        if version == "v1.0-mini":
            val_scene_names = set(MINI_VAL)
        elif val_ratio > 0:
            val_scene_names = {
                s["name"] for s in scenes
                if int(hashlib.md5(s["name"].encode()).hexdigest(), 16)
                % 1000 < val_ratio * 1000}
        else:
            val_scene_names = set()
    train_tokens = {s["token"] for s in scenes
                    if s["name"] not in set(val_scene_names)}
    name_mapping = {} if fmt == "lyft" else NAME_MAPPING
    train_infos, val_infos = _fill_infos(tables, train_tokens, max_sweeps,
                                         test, name_mapping)
    out_dir = out_dir or root_path
    os.makedirs(out_dir, exist_ok=True)
    meta = dict(version=version)
    suffix = "test" if test else "train"
    train_path = os.path.join(out_dir, f"{info_prefix}_infos_{suffix}.pkl")
    with open(train_path, "wb") as f:
        pickle.dump(dict(infos=train_infos, metadata=meta), f)
    paths = [train_path]
    if not test:
        val_path = os.path.join(out_dir, f"{info_prefix}_infos_val.pkl")
        with open(val_path, "wb") as f:
            pickle.dump(dict(infos=val_infos, metadata=meta), f)
        paths.append(val_path)
    print(f"nuscenes infos: {len(train_infos)} train / {len(val_infos)} val "
          f"-> {paths}")
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root-path", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--info-prefix", default="nuscenes")
    p.add_argument("--max-sweeps", type=int, default=10)
    p.add_argument("--val-scenes", default=None,
                   help="file with one val scene name per line "
                        "(official split lists live in the devkit)")
    p.add_argument("--val-ratio", type=float, default=0.0,
                   help="deterministic name-hash val fraction when no "
                        "--val-scenes is given (trainval only)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--format", dest="fmt", default="nuscenes",
                   choices=("nuscenes", "lyft"))
    args = p.parse_args(argv)
    val_names = None
    if args.val_scenes:
        val_names = {ln.strip() for ln in open(args.val_scenes)
                     if ln.strip()}
    return create_nuscenes_infos(args.root_path, args.info_prefix,
                                 args.version, args.max_sweeps, val_names,
                                 args.val_ratio, args.out_dir, args.fmt)


if __name__ == "__main__":
    main()
