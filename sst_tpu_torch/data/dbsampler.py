"""GT-database copy-paste augmentation (ObjectSample).

The port's copy of ``sst_tpu/data/dbsampler.py`` (numpy code; the
port cannot import the JAX package, whose ``__init__`` loads JAX).

Rebuild of the reference's mmdet3d/datasets/pipelines/dbsampler.py:80
(DataBaseSampler) + the ObjectSample transform in transforms_3d.py: sample
extra ground-truth objects from an offline database pkl and paste their
points into the current frame, rejecting samples whose boxes collide (BEV
overlap) with existing or previously pasted boxes.

Database format (tools/create_data.py style): a pkl mapping class name →
list of infos, each with {"path": <points .bin relative to data_root>,
"box3d_lidar": [7] f32, "name": str, "num_points_in_gt": int,
"difficulty": int}.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from sst_tpu_torch.core.evaluation import rotated_iou_matrix
from sst_tpu_torch.utils.registry import PIPELINES


class BatchSampler:
    """Shuffled epoch-cycling sampler over one class's db infos
    (dbsampler.py:12-77)."""

    def __init__(self, infos, rng=None):
        self.infos = infos
        self.rng = rng or np.random.RandomState(0)
        self.indices = self.rng.permutation(len(infos))
        self.idx = 0

    def sample(self, num: int):
        if num >= len(self.infos):
            return list(self.infos)
        if self.idx + num > len(self.indices):
            self.indices = self.rng.permutation(len(self.infos))
            self.idx = 0
        out = [self.infos[i] for i in self.indices[self.idx:self.idx + num]]
        self.idx += num
        return out


class DataBaseSampler:
    def __init__(
        self,
        info_path: str,
        data_root: str,
        rate: float = 1.0,
        prepare: dict | None = None,
        sample_groups: dict | None = None,
        classes=("Car", "Pedestrian", "Cyclist"),
        points_loader: dict | None = None,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.rate = rate
        self.classes = list(classes)
        self.sample_groups = dict(sample_groups or {})
        self.load_dim = (points_loader or {}).get("load_dim", 5)
        self.use_dim = (points_loader or {}).get("use_dim", list(range(5)))
        rng = np.random.RandomState(seed)

        with open(info_path, "rb") as f:
            db_infos = pickle.load(f)
        prepare = prepare or {}
        if "filter_by_difficulty" in prepare:
            removed = set(prepare["filter_by_difficulty"])
            db_infos = {
                k: [i for i in v if i.get("difficulty", 0) not in removed]
                for k, v in db_infos.items()
            }
        if "filter_by_min_points" in prepare:
            for name, min_pts in prepare["filter_by_min_points"].items():
                if name in db_infos:
                    db_infos[name] = [
                        i for i in db_infos[name]
                        if i.get("num_points_in_gt", 0) >= int(min_pts)
                    ]
        self.db_infos = db_infos
        self.samplers = {
            k: BatchSampler(v, rng) for k, v in db_infos.items() if len(v)
        }

    def _load_points(self, info):
        path = os.path.join(self.data_root, info["path"])
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        return pts[:, self.use_dim]

    def sample_all(self, gt_boxes: np.ndarray, gt_names, rng=None):
        """Returns None or dict(gt_boxes [S,7], gt_names, gt_labels, points
        [sum_pts, C]) for the pasted objects (dbsampler.py:170-244)."""
        sampled_infos = []
        avoid = np.asarray(gt_boxes[:, :7], np.float32) if len(gt_boxes) else \
            np.zeros((0, 7), np.float32)
        for name, max_num in self.sample_groups.items():
            if name not in self.samplers:
                continue
            have = sum(1 for n in gt_names if n == name)
            need = int(self.rate * (int(max_num) - have))
            if need <= 0:
                continue
            cands = self.samplers[name].sample(need)
            for info in cands:
                box = np.asarray(info["box3d_lidar"], np.float32)[None, :7]
                if len(avoid):
                    iou = rotated_iou_matrix(box, avoid, mode="bev")
                    if (iou > 1e-4).any():
                        continue
                avoid = np.concatenate([avoid, box])
                sampled_infos.append(info)
        if not sampled_infos:
            return None
        boxes = np.stack(
            [np.asarray(i["box3d_lidar"], np.float32)[:7] for i in sampled_infos]
        )
        names = [i["name"] for i in sampled_infos]
        pts_list = []
        for i, info in enumerate(sampled_infos):
            obj = self._load_points(info)
            obj = obj.copy()
            # db points are stored in the object's local frame (origin at box
            # center, yaw kept) — translate back to the box position.
            obj[:, :3] += boxes[i, :3]
            pts_list.append(obj)
        points = np.concatenate(pts_list) if pts_list else \
            np.zeros((0, len(self.use_dim)), np.float32)
        labels = np.asarray(
            [self.classes.index(n) if n in self.classes else -1 for n in names],
            np.int32,
        )
        return dict(gt_boxes=boxes, gt_names=names, gt_labels=labels,
                    points=points)


def _points_in_bev_boxes(points, boxes):
    """[P] mask of points inside any rotated BEV box (numpy)."""
    if not len(boxes) or not len(points):
        return np.zeros(len(points), bool)
    xy = points[:, :2][:, None, :] - boxes[None, :, :2]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = xy[..., 0] * c[None] - xy[..., 1] * s[None]
    ly = xy[..., 0] * s[None] + xy[..., 1] * c[None]
    inside = (np.abs(lx) <= boxes[None, :, 3] / 2) & (
        np.abs(ly) <= boxes[None, :, 4] / 2
    )
    return inside.any(axis=1)


@PIPELINES.register
class ObjectSample:
    """Paste sampled db objects into the frame (transforms_3d.py ObjectSample):
    remove original points falling inside the pasted boxes, then prepend the
    object points."""

    def __init__(self, db_sampler: dict, sample_2d: bool = False):
        cfg = dict(db_sampler)
        cfg.pop("type", None)
        self.sampler = DataBaseSampler(**cfg)

    def __call__(self, sample):
        gt_boxes = sample.get("gt_boxes", np.zeros((0, 7), np.float32))
        gt_names = sample.get("gt_names",
                              [self.sampler.classes[int(l)]
                               for l in sample.get("gt_labels", [])])
        out = self.sampler.sample_all(gt_boxes, gt_names, sample.get("rng"))
        if out is None:
            return sample
        pts = sample["points"]
        keep = ~_points_in_bev_boxes(pts, out["gt_boxes"])
        obj_pts = out["points"]
        if obj_pts.shape[1] < pts.shape[1]:
            pad = np.zeros((len(obj_pts), pts.shape[1] - obj_pts.shape[1]),
                           np.float32)
            obj_pts = np.concatenate([obj_pts, pad], axis=1)
        elif obj_pts.shape[1] > pts.shape[1]:
            obj_pts = obj_pts[:, : pts.shape[1]]
        sample["points"] = np.concatenate([obj_pts, pts[keep]])
        dim = gt_boxes.shape[1] if len(gt_boxes) else 7
        new_boxes = out["gt_boxes"]
        if dim > 7:  # velocity columns: pasted objects get zeros
            new_boxes = np.concatenate(
                [new_boxes, np.zeros((len(new_boxes), dim - 7), np.float32)], 1
            )
        sample["gt_boxes"] = np.concatenate(
            [gt_boxes.reshape(-1, dim), new_boxes]
        ).astype(np.float32)
        sample["gt_labels"] = np.concatenate(
            [np.asarray(sample.get("gt_labels", []), np.int32),
             out["gt_labels"]]
        )
        sample["gt_names"] = list(gt_names) + out["gt_names"]
        return sample
