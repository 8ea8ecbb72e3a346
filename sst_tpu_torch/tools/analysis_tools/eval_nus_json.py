"""Offline NDS evaluation of a nuScenes-submission-format results json,
with no devkit (counterpart of the JAX package's
``tools/analysis_tools/eval_nus_json.py``, after the reference's, which
wraps nuscenes-devkit NuScenesEval), on ``core/eval_nuscenes.py``.

The json follows the official submission schema:
  {"results": {sample_token: [{"translation": [3], "size": [3],
    "rotation": [w,x,y,z], "velocity": [2], "detection_name": str,
    "detection_score": float}, ...]}, "meta": {...}}

Ground truth comes from an info pkl of ``tools/create_data.py nuscenes``.

Usage:
  python -m sst_tpu_torch.tools.analysis_tools.eval_nus_json \\
      results_nusc.json --info-path data/nuscenes/nuscenes_infos_val.pkl
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from sst_tpu_torch.core.eval_nuscenes import nusc_eval
from sst_tpu_torch.tools.data_converter.nuscenes_converter import (
    quat_to_rot, quat_yaw)

CLASSES = ("car", "truck", "trailer", "bus", "construction_vehicle",
           "bicycle", "motorcycle", "pedestrian", "traffic_cone", "barrier")


def global_to_lidar(boxes, info):
    """Official submission boxes live in the GLOBAL frame; bring them into
    the sample's lidar frame using the info's ego/lidar poses (the inverse
    of the devkit's lidar→global chain)."""
    if len(boxes) == 0 or "ego2global_rotation" not in info:
        return boxes
    r_eg = quat_to_rot(info["ego2global_rotation"])
    t_eg = np.asarray(info["ego2global_translation"], np.float64)
    r_le = quat_to_rot(info["lidar2ego_rotation"])
    t_le = np.asarray(info["lidar2ego_translation"], np.float64)
    out = boxes.copy()
    ctr = boxes[:, :3].astype(np.float64)
    ctr[:, 2] += boxes[:, 5] / 2  # bottom → gravity center for the rotation
    ctr = (ctr - t_eg) @ r_eg
    ctr = (ctr - t_le) @ r_le
    dyaw = quat_yaw(info["ego2global_rotation"]) + \
        quat_yaw(info["lidar2ego_rotation"])
    out[:, :3] = ctr
    out[:, 2] -= boxes[:, 5] / 2
    out[:, 6] = boxes[:, 6] - dyaw
    vel3 = np.concatenate(
        [boxes[:, 7:9], np.zeros((len(boxes), 1))], -1).astype(np.float64)
    vel3 = vel3 @ r_eg @ r_le
    out[:, 7:9] = vel3[:, :2]
    return out


def boxes_from_json(entries):
    boxes, scores, labels = [], [], []
    for e in entries:
        name = e["detection_name"]
        if name not in CLASSES:
            continue
        t = e["translation"]
        s = e["size"]  # devkit order: w, l, h
        yaw = quat_yaw(e["rotation"])
        vel = e.get("velocity", (0.0, 0.0))
        # internal rows: [x, y, z_bottom, w, l, h, yaw, vx, vy]
        boxes.append([t[0], t[1], t[2] - s[2] / 2, s[0], s[1], s[2], yaw,
                      vel[0], vel[1]])
        scores.append(e.get("detection_score", 1.0))
        labels.append(CLASSES.index(name))
    return (np.asarray(boxes, np.float32).reshape(-1, 9),
            np.asarray(scores, np.float32), np.asarray(labels, np.int32))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("result_json")
    p.add_argument("--info-path", required=True)
    args = p.parse_args(argv)

    with open(args.result_json) as f:
        results = json.load(f)["results"]
    with open(args.info_path, "rb") as f:
        infos = pickle.load(f)
    if isinstance(infos, dict):
        infos = infos.get("infos", infos)

    preds, gts = [], []
    skipped = 0
    for info in infos:
        token = info.get("token")
        entries = results.get(token)
        if entries is None:
            skipped += 1
            entries = []
        b, s, l = boxes_from_json(entries)
        b = global_to_lidar(b, info)
        preds.append({"boxes": b, "scores": s, "labels": l})
        names = info.get("gt_names", [])
        glab = np.asarray([CLASSES.index(n) for n in names], np.int32)
        gb = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
        gv = np.asarray(info.get("gt_velocity",
                                 np.zeros((len(gb), 2))), np.float32)
        gv = np.nan_to_num(gv)
        gts.append({"boxes": np.concatenate([gb[:, :7], gv], -1),
                    "labels": glab})
    if skipped:
        print(f"warning: {skipped}/{len(infos)} tokens missing from json")

    out = nusc_eval(preds, gts, CLASSES)
    for k in ("mAP", "mATE", "mASE", "mAOE", "mAVE", "NDS"):
        print(f"{k}: {out[k]}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
