"""Waymo tfrecords → the kitti format the port's datasets read, with no
devkit (counterpart of the JAX package's
``tools/data_converter/waymo_converter.py``).

    python -m sst_tpu_torch.tools.data_converter.waymo_converter \\
        --load-dir data/waymo/raw/training --save-dir data/waymo/kitti \\
        [--prefix 0] [--split train] [--test-mode]

Frame protos are decoded by ``data/waymo_proto.py``; the range-image →
point-cloud geometry is float64 numpy on the host, in the devkit's order
(``range_image_utils.extract_point_cloud_from_range_image``, the TOP
lidar's per-pixel rolling-shutter poses included), so the output files
are the JAX tool's byte for byte.

Outputs under ``--save-dir``:
  velodyne/{idx}.bin    float32 [N, 6] x, y, z, intensity, elongation,
                        timestamp_micros (both returns, no-label-zone
                        pixels dropped)
  label_all/{idx}.txt   KITTI label lines (camera frame through the front
                        camera's reference transform)
  calib/{idx}.txt, pose/{idx}.txt
  waymo_infos_{split}.pkl   what ``data/datasets.py WaymoDataset`` reads
                        (annos with num_points_in_gt, difficulty, obj ids
                        and speeds)
  idx2timestamp.pkl / idx2contextname.pkl   maps of the seed and tracklet
                        tools
  gt.bin                a Waymo Objects bin of the ground truth
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

from sst_tpu_torch.data import waymo_proto as wp

TOP_LIDAR = 1
TYPE_LIST = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
W2K_CLASS = {"VEHICLE": "Car", "PEDESTRIAN": "Pedestrian",
             "CYCLIST": "Cyclist", "SIGN": "Sign", "UNKNOWN": "DontCare"}
SELECTED = ("VEHICLE", "PEDESTRIAN", "CYCLIST")
# Waymo front camera → KITTI reference camera axes
T_FRONT_CAM_TO_REF = np.array([
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def _rotation_zyx(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), over any leading dims
    (``transform_utils.get_rotation_matrix``)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    R = np.empty(np.shape(yaw) + (3, 3))
    R[..., 0, 0] = cy * cp
    R[..., 0, 1] = cy * sp * sr - sy * cr
    R[..., 0, 2] = cy * sp * cr + sy * sr
    R[..., 1, 0] = sy * cp
    R[..., 1, 1] = sy * sp * sr + cy * cr
    R[..., 1, 2] = sy * sp * cr - cy * sr
    R[..., 2, 0] = -sp
    R[..., 2, 1] = cp * sr
    R[..., 2, 2] = cp * cr
    return R


def range_image_to_points(range_image, extrinsic, beam_inclinations,
                          pixel_pose=None, frame_pose=None):
    """[H, W, C >= 3] range image → (points [N, 3] in the vehicle frame,
    mask [H, W]). Rows top to bottom are the largest to the smallest
    inclination; columns sweep the azimuth from +pi to -pi, less the
    extrinsic's yaw. With ``pixel_pose`` [H, W, 6] (the TOP lidar) each
    pixel is lifted through its own vehicle pose into the world and
    brought back through ``frame_pose``. Float64 throughout."""
    H, W = range_image.shape[:2]
    r = range_image[..., 0]
    mask = r > 0
    if range_image.shape[-1] > 3:
        mask &= range_image[..., 3] != 1.0  # no-label-zone filter

    incl = np.asarray(beam_inclinations, np.float64)[::-1]  # row 0 = top
    az_corr = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(W, 0, -1) - 0.5) / W
    azimuth = (ratios * 2 - 1) * np.pi - az_corr

    cos_i, sin_i = np.cos(incl)[:, None], np.sin(incl)[:, None]
    cos_a, sin_a = np.cos(azimuth)[None, :], np.sin(azimuth)[None, :]
    x = cos_i * cos_a * r
    y = cos_i * sin_a * r
    z = sin_i * r
    pts = np.stack([x, y, z], axis=-1)  # sensor frame [H, W, 3]
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]

    if pixel_pose is not None and pixel_pose.size:
        R = _rotation_zyx(pixel_pose[..., 0], pixel_pose[..., 1],
                          pixel_pose[..., 2])
        t = pixel_pose[..., 3:6]
        world = np.einsum("hwij,hwj->hwi", R, pts) + t
        fp_inv = np.linalg.inv(frame_pose)
        pts = world @ fp_inv[:3, :3].T + fp_inv[:3, 3]
    return pts[mask], mask


def compute_inclinations(cal, height):
    """The calibration's beam inclinations, or, where it lists none (the
    side lidars), ``height`` rows spread evenly from its min to its max."""
    if len(cal["beam_inclinations"]):
        return np.asarray(cal["beam_inclinations"], np.float64)
    lo, hi = cal["beam_inclination_min"], cal["beam_inclination_max"]
    return lo + (0.5 + np.arange(height)) / height * (hi - lo)


def extract_frame_points(frame):
    """Every lidar, both returns → float32 [N, 5] (x, y, z, intensity,
    elongation) in the frame's vehicle pose, lidars in name order."""
    chunks = []
    for name in sorted(frame["lasers"]):
        cal = frame["laser_calibrations"].get(name)
        if cal is None:
            continue
        for ri in frame["lasers"][name]:
            img = ri.get("range_image")
            if img is None or img.ndim != 3:
                continue
            incl = compute_inclinations(cal, img.shape[0])
            pixel_pose = frame_pose = None
            if name == TOP_LIDAR and "pose" in frame["lasers"][name][0]:
                pixel_pose = frame["lasers"][name][0]["pose"]
                frame_pose = frame["pose"]
            pts, mask = range_image_to_points(
                img, cal["extrinsic"], incl, pixel_pose, frame_pose)
            feats = img[mask][:, 1:3] if img.shape[-1] >= 3 else \
                np.zeros((len(pts), 2))
            chunks.append(np.concatenate(
                [pts, feats], axis=1).astype(np.float32))
    if not chunks:
        return np.zeros((0, 5), np.float32)
    return np.concatenate(chunks)


class Waymo2KITTI:
    """The tfrecords of ``load_dir`` → the kitti format under ``save_dir``
    (see the module's docstring). ``prefix``: 0 train, 1 val, 2 test; frame
    f of file i is named ``{prefix}{i:03d}{f:03d}``."""

    def __init__(self, load_dir, save_dir, prefix: int = 0,
                 test_mode: bool = False, split: str = "train"):
        self.load_dir = load_dir
        self.save_dir = save_dir
        self.prefix = int(prefix)
        self.test_mode = test_mode
        self.split = split
        self.paths = sorted(glob.glob(os.path.join(load_dir, "*.tfrecord")))
        for sub in ("velodyne", "label_all", "calib", "pose"):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)
        self.infos = []
        self.idx2timestamp = {}
        self.idx2contextname = {}
        self.gt_frames = []

    def convert(self):
        for file_idx, path in enumerate(self.paths):
            for frame_idx, rec in enumerate(wp.read_tfrecord(path)):
                self._convert_frame(wp.parse_frame(rec), file_idx, frame_idx)
        self._finish()
        return self.infos

    # ---------------------------------------------------------- per frame

    def _idx_str(self, file_idx, frame_idx):
        return f"{self.prefix}{file_idx:03d}{frame_idx:03d}"

    def _convert_frame(self, frame, file_idx, frame_idx):
        idx = self._idx_str(file_idx, frame_idx)
        ts = frame["timestamp_micros"]

        points = extract_frame_points(frame)
        pc = np.concatenate(
            [points, np.full((len(points), 1), ts, np.float32)], axis=1)
        rel = f"velodyne/{idx}.bin"
        pc.astype(np.float32).tofile(os.path.join(self.save_dir, rel))

        # the front camera (name 1) defines the KITTI reference frame
        T_velo_to_cam = T_FRONT_CAM_TO_REF.copy()
        for cam in frame["camera_calibrations"]:
            if cam["name"] == 1:
                T_velo_to_cam = T_FRONT_CAM_TO_REF @ np.linalg.inv(
                    cam["extrinsic"])
                break
        self._save_calib(frame, idx, T_velo_to_cam)
        np.savetxt(os.path.join(self.save_dir, f"pose/{idx}.txt"),
                   frame["pose"])

        annos = None
        if not self.test_mode:
            annos = self._save_labels(frame, idx, T_velo_to_cam)

        info = dict(
            point_cloud=dict(velodyne_path=rel, num_features=6),
            image=dict(image_idx=int(idx)),
            pose=frame["pose"],
            calib=dict(R0_rect=np.eye(4), Tr_velo_to_cam=T_velo_to_cam),
            timestamp=ts,
            context=frame["context_name"],
        )
        if annos is not None:
            info["annos"] = annos
        self.infos.append(info)
        self.idx2timestamp[idx] = ts
        self.idx2contextname[idx] = frame["context_name"]

    def _save_calib(self, frame, idx, T_velo_to_cam):
        lines = []
        intr = {c["name"]: c["intrinsic"] for c in
                frame["camera_calibrations"]}
        for i in range(5):
            P = np.zeros((3, 4))
            vals = intr.get(i + 1)
            if vals is not None and len(vals) >= 4:
                P[0, 0], P[1, 1], P[0, 2], P[1, 2] = vals[:4]
            P[2, 2] = 1
            lines.append(f"P{i}: " + " ".join(f"{v:e}" for v in
                                              P.reshape(12)))
        lines.append("R0_rect: " + " ".join(
            f"{v:e}" for v in np.eye(3).reshape(9)))
        for i in range(5):
            lines.append(f"Tr_velo_to_cam_{i}: " + " ".join(
                f"{v:e}" for v in T_velo_to_cam[:3].reshape(12)))
        with open(os.path.join(self.save_dir, f"calib/{idx}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")

    def _save_labels(self, frame, idx, T_velo_to_cam):
        """KITTI label lines and the info's annos of the frame's vehicles,
        pedestrians and cyclists that hold a lidar point; each one's box,
        bottom-centred with yaw ``-heading - pi / 2``, goes into
        ``gt.bin``."""
        names, bboxes, dims, locs, rys = [], [], [], [], []
        trunc, occl, npts, diffs, ids, speeds = [], [], [], [], [], []
        gt_boxes_lidar, gt_labels = [], []
        lines = []
        for obj in frame["laser_labels"]:
            wtype = TYPE_LIST[obj["type"]] if obj["type"] < len(TYPE_LIST) \
                else "UNKNOWN"
            if wtype not in SELECTED:
                continue
            if obj["num_lidar_points_in_box"] < 1:
                continue
            kname = W2K_CLASS[wtype]
            cx, cy, cz, length, width, height, heading = obj["box"]
            z_bottom = cz - height / 2
            cam = T_velo_to_cam @ np.array([cx, cy, z_bottom, 1.0])
            ry = -heading - np.pi / 2
            proj = frame["projected_labels"].get(obj["id"])
            bbox = proj["bbox"] if proj else (0.0, 0.0, 0.0, 0.0)

            names.append(kname)
            bboxes.append(bbox)
            dims.append((length, height, width))  # KITTI l, h, w
            locs.append(cam[:3])
            rys.append(ry)
            trunc.append(0.0)
            occl.append(0)
            npts.append(obj["num_lidar_points_in_box"])
            diffs.append(obj["detection_difficulty_level"])
            ids.append(obj["id"])
            speeds.append(obj["speed"])
            gt_boxes_lidar.append(
                (cx, cy, z_bottom, width, length, height,
                 -heading - np.pi / 2))
            gt_labels.append(("Car", "Pedestrian", "Cyclist").index(kname)
                             if kname in ("Car", "Pedestrian", "Cyclist")
                             else -1)
            lines.append(
                f"{kname} 0.00 0 -10 "
                f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} {bbox[3]:.2f} "
                f"{height:.2f} {width:.2f} {length:.2f} "
                f"{cam[0]:.2f} {cam[1]:.2f} {cam[2]:.2f} {ry:.2f}")
        with open(os.path.join(self.save_dir, f"label_all/{idx}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        if gt_boxes_lidar:
            self.gt_frames.append(dict(
                boxes=np.asarray(gt_boxes_lidar, np.float32),
                scores=np.ones(len(gt_boxes_lidar), np.float32),
                labels=np.asarray(gt_labels, np.int32),
                obj_ids=list(ids),
                context_name=frame["context_name"],
                timestamp_micros=frame["timestamp_micros"]))
        return dict(
            name=np.asarray(names),
            truncated=np.asarray(trunc, np.float32),
            occluded=np.asarray(occl, np.int32),
            alpha=np.full(len(names), -10.0, np.float32),
            bbox=np.asarray(bboxes, np.float32).reshape(-1, 4),
            dimensions=np.asarray(dims, np.float32).reshape(-1, 3),
            location=np.asarray(locs, np.float32).reshape(-1, 3),
            rotation_y=np.asarray(rys, np.float32),
            num_points_in_gt=np.asarray(npts, np.int32),
            difficulty=np.asarray(diffs, np.int32),
            obj_ids=np.asarray(ids),
            speed=np.asarray(speeds, np.float32).reshape(-1, 2),
        )

    # ------------------------------------------------------------- finish

    def _finish(self):
        for name, obj in ((f"waymo_infos_{self.split}.pkl", self.infos),
                          ("idx2timestamp.pkl", self.idx2timestamp),
                          ("idx2contextname.pkl", self.idx2contextname)):
            with open(os.path.join(self.save_dir, name), "wb") as f:
                pickle.dump(obj, f)
        if self.gt_frames:
            from sst_tpu_torch.core.waymo_bin import write_waymo_bin

            write_waymo_bin(os.path.join(self.save_dir, "gt.bin"),
                            self.gt_frames)


def add_arguments(p: argparse.ArgumentParser) -> None:
    p.add_argument("--load-dir", required=True,
                   help="directory of *.tfrecord segments")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--prefix", type=int, default=0,
                   help="0 train / 1 val / 2 test (file naming)")
    p.add_argument("--split", default="train")
    p.add_argument("--test-mode", action="store_true")


def convert(args) -> Waymo2KITTI:
    conv = Waymo2KITTI(args.load_dir, args.save_dir, prefix=args.prefix,
                       test_mode=args.test_mode, split=args.split)
    conv.convert()
    return conv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_arguments(p)
    conv = convert(p.parse_args(argv))
    print(f"converted {len(conv.infos)} frames from {len(conv.paths)} "
          f"tfrecords")
    return conv


if __name__ == "__main__":
    main()
