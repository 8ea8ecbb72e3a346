"""Datasets of the port (numpy code copied from ``sst_tpu/data/datasets.py``,
which it cannot import): KITTI-format pkl-info readers (the Waymo layout
the reference's offline converters write), the synthetic scenes of the
CLIs' ``--synthetic``, and :func:`collate_to_batch`.

An info dict (mmdet3d v0.15 schema) carries
``info['point_cloud']['velodyne_path']``, ``info['annos']['name' /
'location' / 'dimensions' / 'rotation_y']`` (camera coordinates for the
KITTI format) and ``info['calib']``. Ground-truth boxes become LiDAR-frame
rows [x, y, z_bottom, w, l, h, yaw] at load time. Samples run through a
pipeline (``data/pipelines.py``) ending in ``PadToCap``, then collate into
a ``PointBatch``.

A ``Custom3DDataset`` hands every sample the dataset's one
``np.random.RandomState``, as JAX's does; the loader's worker threads share
it, so with augmentation on the order of the draws follows the threads'
timing (``SyntheticDataset`` draws from a state per index instead).

The nuScenes, Lyft and Argo2 datasets read LiDAR-frame infos (boxes,
names, velocities, ``valid_flag``) and hand the pipeline each keyframe's
``sweeps`` and ``timestamp`` for ``LoadPointsFromMultiSweeps``; KITTI reads
the Waymo layout's camera-frame annos. Each has its own ``evaluate``
(``core/eval_{nuscenes,argo2,kitti,lyft}.py``); ``CBGSDataset`` resamples a
dataset's indices toward balanced classes with ``RandomState(0)``, as
JAX's does. Every dataset is registered in ``utils/registry.py
DATASETS``. ``WaymoDataset.format_results`` writes the detections as a
Waymo Objects bin (``core/waymo_bin.py``), and its ``evaluate`` scores them
with the official metric binary where it is on ``PATH`` and with
``core/eval_waymo.py`` always.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

from sst_tpu_torch.utils.registry import DATASETS


def camera_to_lidar_boxes(annos: dict, rect=None, Trv2c=None) -> np.ndarray:
    """KITTI-format camera-frame annos → LiDAR 7-dof rows.

    For Waymo-KITTI conversions the reference stores location in camera
    coords with rect/Trv2c transforms in the info; when absent (already
    LiDAR), passes through.
    """
    loc = annos["location"].astype(np.float32)
    dims = annos["dimensions"].astype(np.float32)  # (l, h, w) camera convention
    rots = annos["rotation_y"].astype(np.float32)
    if rect is not None and Trv2c is not None and len(loc):
        hom = np.concatenate([loc, np.ones((len(loc), 1), np.float32)], axis=1)
        lidar_loc = hom @ np.linalg.inv((rect @ Trv2c).T)
        loc = lidar_loc[:, :3]
        # camera (l, h, w) + ry → lidar (w, l, h) + yaw
        w, l, h = dims[:, 2], dims[:, 0], dims[:, 1]
        yaw = -rots - np.pi / 2
        return np.stack([loc[:, 0], loc[:, 1], loc[:, 2], w, l, h, yaw], -1)
    w, l, h = dims[:, 2], dims[:, 0], dims[:, 1]
    return np.stack(
        [loc[:, 0], loc[:, 1], loc[:, 2], w, l, h, rots], -1
    ).astype(np.float32)


@DATASETS.register
class Custom3DDataset:
    """pkl-info dataset base (datasets/custom_3d.py analog)."""

    CLASSES: Sequence[str] = ()

    def __init__(self, data_root, info_path, pipeline=None, classes=None,
                 load_interval: int = 1, test_mode: bool = False, seed: int = 0):
        self.data_root = data_root
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        if isinstance(self.infos, dict) and "infos" in self.infos:
            # reference-format pkl: dict(infos=[...], metadata=...)
            self.infos = self.infos["infos"]
        self.infos = self.infos[::load_interval]
        self.classes = list(classes or self.CLASSES)
        self.test_mode = test_mode
        self.pipeline = pipeline
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.infos)

    def get_sample(self, idx: int) -> dict:
        raise NotImplementedError

    def __getitem__(self, idx: int) -> dict:
        sample = self.get_sample(idx)
        sample["rng"] = self._rng
        if self.pipeline is not None:
            sample = self.pipeline(sample)
        return sample


@DATASETS.register
class WaymoDataset(Custom3DDataset):
    """KITTI-format Waymo Open Dataset (datasets/waymo_dataset.py:29).

    Expects infos from the reference's waymo converter; point clouds are
    6-channel .bin (x, y, z, intensity, elongation, timestamp_diff)."""

    CLASSES = ("Car", "Pedestrian", "Cyclist")

    def __init__(self, *args, load_dim: int = 6, use_dim=(0, 1, 2, 3, 4),
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.load_dim = load_dim
        self.use_dim = list(use_dim)

    def get_sample(self, idx: int) -> dict:
        info = self.infos[idx]
        pts_path = os.path.join(
            self.data_root, info["point_cloud"]["velodyne_path"]
        )
        points = np.fromfile(pts_path, dtype=np.float32).reshape(-1, self.load_dim)
        points = points[:, self.use_dim]
        sample = {"points": points, "idx": idx, "info": info}
        annos = info.get("annos")
        if annos is not None:
            names = annos["name"]
            keep = np.isin(names, self.classes)
            rect = info.get("calib", {}).get("R0_rect")
            trv2c = info.get("calib", {}).get("Tr_velo_to_cam")
            boxes = camera_to_lidar_boxes(
                {k: v[keep] for k, v in annos.items()
                 if k in ("location", "dimensions", "rotation_y")},
                rect, trv2c,
            )
            labels = np.asarray(
                [self.classes.index(n) for n in names[keep]], np.int32
            )
            sample["gt_boxes"] = boxes
            sample["gt_labels"] = labels
            sample["gt_names"] = list(names[keep])
        return sample

    # -------------------------------------------------- waymo-protocol output

    def format_results(self, results, pklfile_prefix: str):
        """results[i]: dict(boxes_3d [N,7+], scores_3d [N], labels_3d [N])
        → serialized WOD Objects bin (waymo_dataset.py:715
        fast_convert_to_waymo), using the converter-produced
        idx2timestamp.pkl / idx2contextname.pkl maps."""
        from sst_tpu_torch.core.waymo_bin import write_waymo_bin

        with open(os.path.join(self.data_root, "idx2timestamp.pkl"), "rb") as f:
            idx2ts = pickle.load(f)
        with open(os.path.join(self.data_root, "idx2contextname.pkl"), "rb") as f:
            idx2ctx = pickle.load(f)
        frames = []
        for idx, res in enumerate(results):
            sample_idx = self.infos[idx]["image"]["image_idx"]
            key = f"{sample_idx:07d}"
            frames.append(dict(
                boxes=np.asarray(res["boxes_3d"]),
                scores=np.asarray(res["scores_3d"]),
                labels=np.asarray(res["labels_3d"]),
                context_name=idx2ctx[key],
                timestamp_micros=idx2ts[key],
            ))
        path = pklfile_prefix if pklfile_prefix.endswith(".bin") else \
            pklfile_prefix + ".bin"
        return write_waymo_bin(path, frames, tuple(self.classes))

    def evaluate(self, results, metric: str = "fast",
                 pklfile_prefix: str | None = None,
                 waymo_metrics_bin: str = "compute_detection_metrics_main",
                 gt_bin: str | None = None):
        """`fast`/`waymo`: write the Objects bin and invoke the official WOD
        metric binary when present (waymo_dataset.py:354-415); falls back to
        the internal numpy AP protocol otherwise. `kitti`: internal AP only."""
        import shutil
        import subprocess

        from sst_tpu_torch.core.eval_waymo import (
            parse_metrics_stdout,
            waymo_eval,
        )

        out = {}
        binary_ap = None
        if metric in ("fast", "waymo") and pklfile_prefix is not None:
            bin_path = self.format_results(results, pklfile_prefix)
            out["bin"] = bin_path
            if gt_bin is not None and shutil.which(waymo_metrics_bin):
                proc = subprocess.run(
                    [waymo_metrics_bin, bin_path, gt_bin],
                    capture_output=True, text=True,
                )
                out["waymo_stdout"] = proc.stdout
                # parse the table into the ap_dict
                # (waymo_dataset.py:416-470); the internal protocol still
                # runs below so the binary-vs-internal delta is visible
                binary_ap = parse_metrics_stdout(proc.stdout)
                out.update(binary_ap)

        gts = []
        for info in self.infos:
            annos = info.get("annos", {})
            names = np.asarray(annos.get("name", [])).reshape(-1)
            keep = np.isin(names, self.classes)
            rect = info.get("calib", {}).get("R0_rect")
            trv2c = info.get("calib", {}).get("Tr_velo_to_cam")
            boxes = camera_to_lidar_boxes(
                {k: v[keep] for k, v in annos.items()
                 if k in ("location", "dimensions", "rotation_y")},
                rect, trv2c,
            ) if keep.any() else np.zeros((0, 7), np.float32)
            labels = np.asarray(
                [self.classes.index(n) for n in names[keep]], np.int32)
            g = dict(boxes=boxes, labels=labels)
            if "num_points_in_gt" in annos:
                g["num_points"] = np.asarray(annos["num_points_in_gt"])[keep]
            if "difficulty" in annos:
                g["difficulty"] = np.asarray(annos["difficulty"])[keep]
            gts.append(g)
        preds = [
            dict(boxes=np.asarray(r["boxes_3d"]),
                 scores=np.asarray(r["scores_3d"]),
                 labels=np.asarray(r["labels_3d"]))
            for r in results
        ]
        internal = waymo_eval(preds, gts, tuple(self.classes),
                              range_breakdowns=metric == "waymo")
        if binary_ap is None:
            out.update(internal)
        else:
            # binary numbers are authoritative; surface the internal
            # protocol's agreement as a cross-check scalar
            for k in ("Overall/L1 mAPH", "Overall/L2 mAPH"):
                if k in binary_ap and k in internal:
                    out[f"binary_minus_internal/{k.split('/')[1]}"] = round(
                        binary_ap[k] - internal[k], 4)
        return out


def lidar_to_camera_annos(boxes, scores, labels, classes, rect=None,
                          Trv2c=None, P2=None, image_shape=None):
    """LiDAR 7-dof predictions → a KITTI-format anno dict (camera frame),
    the inverse of camera_to_lidar_boxes.

    With ``P2`` (3x4 camera projection) the image bbox is the real
    projection of the 3D corners (reference kitti format path,
    box_np_ops center_to_corner_box3d → project_to_image) and alpha the
    devkit observation angle; otherwise bbox is a never-size-ignored
    placeholder (lidar-only pipelines)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1] if
                                                  len(boxes) else 7)
    n = len(boxes)
    if rect is not None and Trv2c is not None and n:
        hom = np.concatenate(
            [boxes[:, :3], np.ones((n, 1), np.float32)], axis=1)
        loc = (hom @ (rect @ Trv2c).T)[:, :3]
        ry = -boxes[:, 6] - np.pi / 2
    else:
        loc = boxes[:, :3] if n else np.zeros((0, 3), np.float32)
        ry = boxes[:, 6] if n else np.zeros(0, np.float32)
    dims = boxes[:, [4, 5, 3]] if n else np.zeros((0, 3), np.float32)  # lhw
    if P2 is not None and n:
        from sst_tpu_torch.core.frames import cam_boxes_to_image_bbox, kitti_alpha

        # camera-frame rows (x_size, y_size, z_size) = (l, h, w), y = bottom
        cam = np.concatenate(
            [loc, dims, ry[:, None]], axis=1).astype(np.float32)
        bbox = cam_boxes_to_image_bbox(cam, P2, image_shape)
        alpha = kitti_alpha(loc, ry).astype(np.float32)
    else:
        bbox = np.tile(np.array([[0.0, 0.0, 200.0, 200.0]], np.float32),
                       (n, 1))
        alpha = np.asarray(ry, np.float32).copy()
    return dict(
        name=np.asarray([classes[int(l)] for l in labels]),
        location=loc.astype(np.float32),
        dimensions=dims.astype(np.float32),
        rotation_y=np.asarray(ry, np.float32),
        alpha=alpha,
        bbox=bbox,
        occluded=np.zeros(n, np.int32),
        truncated=np.zeros(n, np.float32),
        score=np.asarray(scores, np.float32).reshape(-1),
    )


@DATASETS.register
class KittiDataset(WaymoDataset):
    """KITTI 3D detection (datasets/kitti_dataset.py): same kitti-format info
    schema as the Waymo converter output, 4-channel points."""

    CLASSES = ("Car", "Pedestrian", "Cyclist")

    def __init__(self, *args, load_dim: int = 4, use_dim=(0, 1, 2, 3), **kw):
        super().__init__(*args, load_dim=load_dim, use_dim=use_dim, **kw)

    def evaluate(self, results, metric: str = "kitti", **kw):
        """Official KITTI easy/moderate/hard R40 protocol
        (kitti_dataset.py:707 kitti_eval path)."""
        from sst_tpu_torch.core.eval_kitti import kitti_eval

        empty = dict(name=np.zeros(0, dtype="<U16"))
        gt_annos = [info.get("annos", empty) for info in self.infos]
        dt_annos = []
        for res, info in zip(results, self.infos):
            calib = info.get("calib", {})
            dt_annos.append(lidar_to_camera_annos(
                np.asarray(res["boxes_3d"]), np.asarray(res["scores_3d"]),
                np.asarray(res["labels_3d"]), self.classes,
                rect=calib.get("R0_rect"), Trv2c=calib.get("Tr_velo_to_cam"),
                P2=calib.get("P2"),
                image_shape=info.get("image", {}).get("image_shape"),
            ))
        return kitti_eval(gt_annos, dt_annos, tuple(self.classes))


@DATASETS.register
class NuScenesDataset(Custom3DDataset):
    """nuScenes (datasets/nuscenes_dataset.py): infos carry LiDAR-frame boxes
    directly (gt_boxes [G, 7], gt_names, gt_velocity [G, 2]); code_size 9
    boxes = [x y z w l h yaw vx vy]."""

    CLASSES = (
        "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
        "motorcycle", "pedestrian", "traffic_cone", "barrier",
    )

    def __init__(self, *args, load_dim: int = 5, use_dim=(0, 1, 2, 3, 4),
                 with_velocity: bool = True, use_valid_flag: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.with_velocity = with_velocity
        self.use_valid_flag = use_valid_flag

    def get_sample(self, idx: int) -> dict:
        info = self.infos[idx]
        path = info.get("lidar_path") or info["point_cloud"]["velodyne_path"]
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        points = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        sample = {
            "points": points[:, self.use_dim],
            "idx": idx,
            "info": info,
            "timestamp": info.get("timestamp", 0.0),
            "sweeps": info.get("sweeps", []),
        }
        if "gt_boxes" in info:
            boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 7)
            names = np.asarray(info["gt_names"]).reshape(-1)
            mask = (
                np.asarray(info["valid_flag"], bool)
                if self.use_valid_flag and "valid_flag" in info
                else np.asarray(info.get("num_lidar_pts", np.ones(len(boxes)))) > 0
            )
            keep = mask & np.isin(names, self.classes)
            boxes = boxes[keep]
            names = names[keep]
            if self.with_velocity:
                vel = np.asarray(info.get(
                    "gt_velocity", np.zeros((len(mask), 2))), np.float32)[keep]
                vel = np.nan_to_num(vel)
                boxes = np.concatenate([boxes, vel], axis=1)
            sample["gt_boxes"] = boxes
            sample["gt_labels"] = np.asarray(
                [self.classes.index(n) for n in names], np.int32
            )
            sample["gt_names"] = list(names)
        return sample

    def class_counts(self):
        counts = np.zeros(len(self.classes), np.int64)
        for info in self.infos:
            names = np.asarray(info.get("gt_names", [])).reshape(-1)
            for n in names:
                if n in self.classes:
                    counts[self.classes.index(n)] += 1
        return counts

    def _gt_frames(self):
        gts = []
        for i in range(len(self.infos)):
            s = self.get_sample(i)
            gts.append(dict(
                boxes=s.get("gt_boxes", np.zeros((0, 7), np.float32)),
                labels=s.get("gt_labels", np.zeros(0, np.int32))))
        return gts

    def evaluate(self, results, metric: str = "nds", **kw):
        """nuScenes protocol: center-distance AP at {0.5, 1, 2, 4} m, TP
        error metrics, NDS composite (nuscenes_dataset.py _evaluate_single
        equivalent, devkit-free)."""
        from sst_tpu_torch.core.eval_nuscenes import nusc_eval

        preds = [dict(boxes=np.asarray(r["boxes_3d"]),
                      scores=np.asarray(r["scores_3d"]),
                      labels=np.asarray(r["labels_3d"])) for r in results]
        return nusc_eval(preds, self._gt_frames(), tuple(self.classes))


@DATASETS.register
class LyftDataset(NuScenesDataset):
    """Lyft L5 dataset (datasets/lyft_dataset.py): nuScenes relational
    format with flat (unmapped) category names, no velocity; evaluated with
    the Lyft mAP@0.5:0.95 protocol (core/eval_lyft.py, reference
    core/evaluation/lyft_eval.py:89)."""

    CLASSES = (
        "car", "truck", "bus", "emergency_vehicle", "other_vehicle",
        "motorcycle", "bicycle", "pedestrian", "animal",
    )

    def __init__(self, *args, with_velocity: bool = False, **kw):
        super().__init__(*args, with_velocity=with_velocity, **kw)

    def evaluate(self, results, metric: str = "lyft", **kw):
        from sst_tpu_torch.core.eval_lyft import lyft_eval

        preds = [dict(boxes=np.asarray(r["boxes_3d"]),
                      scores=np.asarray(r["scores_3d"]),
                      labels=np.asarray(r["labels_3d"])) for r in results]
        return lyft_eval(preds, self._gt_frames(), tuple(self.classes))


@DATASETS.register
class Argo2Dataset(NuScenesDataset):
    """Argoverse 2 sensor dataset (datasets/argo2_dataset.py): 26-class,
    LiDAR-frame infos produced by tools/argo converters; no velocity."""

    CLASSES = (
        "Regular_vehicle", "Pedestrian", "Bicyclist", "Motorcyclist",
        "Wheeled_rider", "Bollard", "Construction_cone", "Sign",
        "Construction_barrel", "Stop_sign", "Mobile_pedestrian_crossing_sign",
        "Large_vehicle", "Bus", "Box_truck", "Truck", "Vehicular_trailer",
        "Truck_cab", "School_bus", "Articulated_bus", "Message_board_trailer",
        "Bicycle", "Motorcycle", "Wheeled_device", "Wheelchair", "Stroller",
        "Dog",
    )

    def __init__(self, *args, with_velocity: bool = False, **kw):
        super().__init__(*args, with_velocity=with_velocity, **kw)

    def format_results(self, results, pklfile_prefix: str):
        """av2-schema feather output (argo2_dataset.py:374-440)."""
        from sst_tpu_torch.core.eval_argo2 import format_results_feather

        return format_results_feather(results, self.infos,
                                      tuple(self.classes), pklfile_prefix)

    def evaluate(self, results, metric: str = "cds",
                 pklfile_prefix: str | None = None, **kw):
        """av2-protocol CDS eval (argo2_dataset.py:459-520 equivalent,
        av2-package-free); optionally also writes the feather dump."""
        from sst_tpu_torch.core.eval_argo2 import argo2_eval

        out = {}
        if pklfile_prefix is not None:
            out["feather"] = self.format_results(results, pklfile_prefix)
        preds = [dict(boxes=np.asarray(r["boxes_3d"]),
                      scores=np.asarray(r["scores_3d"]),
                      labels=np.asarray(r["labels_3d"])) for r in results]
        out.update(argo2_eval(preds, self._gt_frames(),
                              tuple(self.classes)))
        return out


@DATASETS.register
class CBGSDataset:
    """Class-balanced resampling wrapper (datasets/dataset_wrappers.py
    CBGSDataset, nuScenes recipe): duplicate sample indices so every class's
    expected frequency approaches 1/num_classes."""

    def __init__(self, dataset):
        self.dataset = (
            DATASETS.build(dataset) if isinstance(dataset, dict) else dataset
        )
        self.sample_indices = self._balanced_indices()
        self.classes = self.dataset.classes

    def _balanced_indices(self):
        ds = self.dataset
        num_classes = len(ds.classes)
        cls_to_samples = {c: [] for c in range(num_classes)}
        for i in range(len(ds)):
            info = ds.infos[i]
            names = np.asarray(info.get(
                "gt_names", info.get("annos", {}).get("name", []))).reshape(-1)
            labels = {ds.classes.index(n) for n in names if n in ds.classes}
            for l in labels:
                cls_to_samples[l].append(i)
        duplicated = sum(len(v) for v in cls_to_samples.values())
        if duplicated == 0:
            return list(range(len(ds)))
        frac = 1.0 / num_classes
        ratios = [frac / (len(v) / duplicated) if len(v) else 0.0
                  for v in cls_to_samples.values()]
        out = []
        rng = np.random.RandomState(0)
        for cls, ratio in enumerate(ratios):
            pool = cls_to_samples[cls]
            if not pool:
                continue
            n = int(len(pool) * ratio)
            out.extend(rng.choice(pool, n).tolist())
        return out or list(range(len(ds)))

    def __len__(self):
        return len(self.sample_indices)

    def __getitem__(self, idx):
        return self.dataset[self.sample_indices[idx]]

@DATASETS.register
class SyntheticDataset:
    """Deterministic synthetic LiDAR scenes for smoke training/benchmarks —
    clustered objects + ground plane + clutter, Waymo-like density."""

    CLASSES = ("Car", "Pedestrian", "Cyclist")
    SIZES = {
        0: (2.0, 4.6, 1.7),
        1: (0.85, 0.9, 1.7),
        2: (0.85, 1.8, 1.7),
    }

    def __init__(self, num_samples=64, num_points=32768, num_objects=24,
                 pc_range=(-74.88, -74.88, -2, 74.88, 74.88, 4), pipeline=None,
                 seed=0, **kw):
        self.num_samples = num_samples
        self.num_points = num_points
        self.num_objects = num_objects
        self.pc_range = pc_range
        self.pipeline = pipeline
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        g = self.num_objects
        labels = rng.randint(0, 3, g).astype(np.int32)
        sizes = np.stack([self.SIZES[int(l)] for l in labels])
        sizes = sizes * rng.uniform(0.85, 1.15, (g, 3))
        xy = rng.uniform(self.pc_range[0] * 0.9, self.pc_range[3] * 0.9, (g, 2))
        z = rng.uniform(-0.3, 0.3, (g, 1))
        yaw = rng.uniform(-np.pi, np.pi, (g, 1))
        boxes = np.concatenate([xy, z, sizes, yaw], -1).astype(np.float32)

        p = self.num_points
        n_obj_pts = p // 3
        which = rng.randint(0, g, n_obj_pts)
        local = rng.uniform(-0.5, 0.5, (n_obj_pts, 3)) * sizes[which]
        c, s = np.cos(boxes[which, 6]), np.sin(boxes[which, 6])
        ox = local[:, 0] * c + local[:, 1] * s + boxes[which, 0]
        oy = -local[:, 0] * s + local[:, 1] * c + boxes[which, 1]
        oz = local[:, 2] + boxes[which, 2] + sizes[which, 2] / 2
        obj = np.stack([ox, oy, oz], -1)
        n_bg = p - n_obj_pts
        r = np.abs(rng.randn(n_bg)) * 25 + rng.rand(n_bg) * 40
        th = rng.uniform(-np.pi, np.pi, n_bg)
        bg = np.stack(
            [r * np.cos(th), r * np.sin(th), rng.uniform(-1.8, 3.0, n_bg)], -1
        )
        pts = np.concatenate([obj, bg]).astype(np.float32)
        inten = rng.rand(p, 2).astype(np.float32)
        sample = {
            "points": np.concatenate([pts, inten], -1),
            "gt_boxes": boxes,
            "gt_labels": labels,
            "idx": idx,
            "rng": rng,
        }
        if self.pipeline is not None:
            sample = self.pipeline(sample)
        return sample


def collate_to_batch(samples: list[dict]):
    """Stack padded samples into a ``PointBatch`` of CPU tensors. The move
    to the device happens on the caller's thread (the train and test CLIs'
    main loop), as JAX's ``shard_batch`` does, never in a loader thread."""
    import torch

    from sst_tpu_torch.models import PointBatch

    def stack(key):
        return torch.from_numpy(np.stack([s[key] for s in samples]))

    return PointBatch(points=stack("points"), valid=stack("points_valid"),
                      gt_boxes=stack("gt_boxes"), gt_labels=stack("gt_labels"),
                      gt_valid=stack("gt_valid"))
