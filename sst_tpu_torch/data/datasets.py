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

Not ported yet (ROADMAP queue 1, item 9b): ``WaymoDataset.format_results``
and ``evaluate`` (the Waymo-bin output), and the KITTI, nuScenes, Lyft,
Argo2 and CBGS datasets.
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np


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
