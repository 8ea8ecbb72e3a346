"""Host-side (numpy) data pipeline transforms (the port's copy of
``sst_tpu/data/pipelines.py``, which it cannot import: importing ``sst_tpu``
loads JAX).

Each transform works on a plain dict sample

  {"points": [P, C] f32, "gt_boxes": [G, 7+] f32, "gt_labels": [G] i32,
   "gt_names": list[str], "rng": np.random.RandomState, ...}

and draws from ``sample["rng"]`` exactly as JAX's does, draw for draw, so
both packages give the same samples from the same state. ``PointsRangeFilter``
and ``PadToCap`` take the native route (``data/native``) wherever its
library builds, as JAX's do; ``PadToCap`` draws a seed on that route only.
``LoadPointsFromMultiSweeps`` concatenates a keyframe's past sweeps with a
time-lag channel (Waymo's 4x4 ``pose`` route and nuScenes'
``sensor2lidar_*`` route); ``ObjectSample`` (``data/dbsampler.py``) pastes
objects of a gt database into the frame.
"""

from __future__ import annotations

import numpy as np

from sst_tpu_torch.utils.registry import PIPELINES


def _rot2d(xy, angle):
    c, s = np.cos(angle), np.sin(angle)
    x = xy[..., 0] * c + xy[..., 1] * s
    y = -xy[..., 0] * s + xy[..., 1] * c
    return np.stack([x, y], -1)


@PIPELINES.register
class LoadPointsFromFile:
    """Read a .bin float32 point cloud (KITTI-format layout)."""

    def __init__(self, load_dim: int = 6, use_dim=(0, 1, 2, 3)):
        self.load_dim = load_dim
        self.use_dim = list(use_dim)

    def __call__(self, sample):
        path = sample["pts_filename"]
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        sample["points"] = pts[:, self.use_dim]
        return sample


@PIPELINES.register
class GlobalRotScaleTrans:
    def __init__(self, rot_range=(-0.78539816, 0.78539816),
                 scale_ratio_range=(0.95, 1.05), translation_std=(0, 0, 0)):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)

    def __call__(self, sample):
        rng: np.random.RandomState = sample["rng"]
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.randn(3).astype(np.float32) * self.translation_std

        pts = sample["points"]
        pts[:, :2] = _rot2d(pts[:, :2], angle)
        pts[:, :3] = pts[:, :3] * scale + trans
        sample["points"] = pts

        boxes = sample.get("gt_boxes")
        if boxes is not None and len(boxes):
            boxes[:, :2] = _rot2d(boxes[:, :2], angle)
            boxes[:, 6] += angle
            boxes[:, :6] *= scale
            boxes[:, :3] += trans
            if boxes.shape[1] > 7:
                boxes[:, 7:9] = _rot2d(boxes[:, 7:9], angle) * scale
            sample["gt_boxes"] = boxes
        return sample


@PIPELINES.register
class RandomFlip3D:
    def __init__(self, flip_ratio_bev_horizontal=0.5, flip_ratio_bev_vertical=0.0):
        self.ratio_h = flip_ratio_bev_horizontal
        self.ratio_v = flip_ratio_bev_vertical

    def __call__(self, sample):
        rng: np.random.RandomState = sample["rng"]
        boxes = sample.get("gt_boxes")
        if rng.rand() < self.ratio_h:  # flip y (lidar_box3d.flip horizontal)
            sample["points"][:, 1] *= -1
            if boxes is not None and len(boxes):
                boxes[:, 1] *= -1
                boxes[:, 6] = -boxes[:, 6] + np.pi
                if boxes.shape[1] > 7:
                    boxes[:, 8] *= -1
        if rng.rand() < self.ratio_v:  # flip x (lidar_box3d.flip vertical)
            sample["points"][:, 0] *= -1
            if boxes is not None and len(boxes):
                boxes[:, 0] *= -1
                boxes[:, 6] *= -1
                if boxes.shape[1] > 7:
                    boxes[:, 7] *= -1
        return sample


@PIPELINES.register
class PointsRangeFilter:
    def __init__(self, point_cloud_range, use_native: bool = True):
        self.pcr = np.asarray(point_cloud_range, np.float32)
        self.use_native = use_native

    def __call__(self, sample):
        p = sample["points"]
        if self.use_native:
            from sst_tpu_torch.data import native

            if native.available():
                sample["points"] = native.range_filter(p, self.pcr)
                return sample
        m = (
            (p[:, 0] >= self.pcr[0]) & (p[:, 0] < self.pcr[3])
            & (p[:, 1] >= self.pcr[1]) & (p[:, 1] < self.pcr[4])
            & (p[:, 2] >= self.pcr[2]) & (p[:, 2] < self.pcr[5])
        )
        sample["points"] = p[m]
        return sample


@PIPELINES.register
class ObjectRangeFilter:
    def __init__(self, point_cloud_range):
        self.pcr = np.asarray(point_cloud_range, np.float32)

    def __call__(self, sample):
        b = sample.get("gt_boxes")
        if b is None or not len(b):
            return sample
        m = (
            (b[:, 0] >= self.pcr[0]) & (b[:, 0] < self.pcr[3])
            & (b[:, 1] >= self.pcr[1]) & (b[:, 1] < self.pcr[4])
        )
        sample["gt_boxes"] = b[m]
        sample["gt_labels"] = sample["gt_labels"][m]
        return sample


@PIPELINES.register
class PointShuffle:
    def __call__(self, sample):
        rng: np.random.RandomState = sample["rng"]
        perm = rng.permutation(len(sample["points"]))
        sample["points"] = sample["points"][perm]
        return sample


@PIPELINES.register
class PadToCap:
    """Pad/truncate to the static caps, producing mask arrays — the bridge
    from ragged host data to fixed-shape device batches."""

    def __init__(self, max_points: int, max_gt: int = 128):
        self.max_points = max_points
        self.max_gt = max_gt

    def __call__(self, sample):
        p = sample["points"]
        from sst_tpu_torch.data import native

        if native.available():
            rng = sample.get("rng")
            seed = int(rng.randint(1 << 31)) if rng is not None else 0
            out_p, n = native.shuffle_pad(p, self.max_points, seed)
        else:
            n = min(len(p), self.max_points)
            if len(p) > self.max_points:
                # keep a uniform subsample rather than a prefix
                rng = sample.get("rng", np.random)
                idx = rng.choice(len(p), self.max_points, replace=False)
                p = p[idx]
            out_p = np.zeros((self.max_points, p.shape[1]), np.float32)
            out_p[:n] = p[:n]
        valid = np.zeros(self.max_points, bool)
        valid[:n] = True
        sample["points"] = out_p
        sample["points_valid"] = valid

        b = sample.get("gt_boxes")
        if b is not None:
            g = min(len(b), self.max_gt)
            # an empty (0, 9) velocity-coded array must keep its width
            dim = b.shape[1] if getattr(b, "ndim", 1) == 2 else 7
            out_b = np.zeros((self.max_gt, dim), np.float32)
            out_l = np.zeros(self.max_gt, np.int32)
            gv = np.zeros(self.max_gt, bool)
            out_b[:g] = b[:g]
            out_l[:g] = sample["gt_labels"][:g]
            gv[:g] = True
            sample["gt_boxes"] = out_b
            sample["gt_labels"] = out_l
            sample["gt_valid"] = gv
        return sample


@PIPELINES.register
class LoadPointsFromMultiSweeps:
    """Concatenate past lidar sweeps into the current frame with a time-lag
    channel (loading.py LoadPointsFromMultiSweeps / ...Waymo).

    Each entry of sample["sweeps"] needs: data_path (str), timestamp, and
    either a 4x4 "pose" composed with the current frame's (waymo style) or
    "sensor2lidar_rotation"/"sensor2lidar_translation" (nuscenes style).
    """

    def __init__(self, sweeps_num: int = 2, load_dim: int = 5,
                 use_dim=(0, 1, 2, 3, 4), pad_empty_sweeps: bool = True,
                 remove_close: float = 1.0, test_mode: bool = False):
        self.sweeps_num = sweeps_num
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.pad_empty_sweeps = pad_empty_sweeps
        self.remove_close = remove_close
        self.test_mode = test_mode

    def _remove_close(self, pts):
        if self.remove_close <= 0:
            return pts
        m = (np.abs(pts[:, 0]) > self.remove_close) | (
            np.abs(pts[:, 1]) > self.remove_close
        )
        return pts[m]

    def __call__(self, sample):
        pts = sample["points"]
        ts = float(sample.get("timestamp", 0.0))
        out = [np.concatenate(
            [pts, np.zeros((len(pts), 1), np.float32)], axis=1)]
        sweeps = sample.get("sweeps", [])
        if not sweeps and self.pad_empty_sweeps:
            for _ in range(self.sweeps_num):
                out.append(out[0].copy() if not self.remove_close else
                           np.concatenate([self._remove_close(pts),
                                           np.zeros((len(self._remove_close(pts)), 1),
                                                    np.float32)], axis=1))
        else:
            if len(sweeps) <= self.sweeps_num:
                chosen = list(range(len(sweeps)))
            elif self.test_mode:
                chosen = list(range(self.sweeps_num))
            else:
                chosen = list(sample["rng"].choice(
                    len(sweeps), self.sweeps_num, replace=False))
            for i in chosen:
                sw = sweeps[i]
                p = np.fromfile(sw["data_path"], dtype=np.float32).reshape(
                    -1, self.load_dim)[:, self.use_dim]
                p = self._remove_close(p)
                if "sensor2lidar_rotation" in sw:
                    r = np.asarray(sw["sensor2lidar_rotation"], np.float32)
                    t = np.asarray(sw["sensor2lidar_translation"], np.float32)
                    p[:, :3] = p[:, :3] @ r.T + t
                elif "pose" in sw and "pose" in sample:
                    rel = np.linalg.inv(
                        np.asarray(sample["pose"], np.float64)
                    ) @ np.asarray(sw["pose"], np.float64)
                    p[:, :3] = (p[:, :3] @ rel[:3, :3].T + rel[:3, 3]).astype(
                        np.float32)
                lag = ts - float(sw.get("timestamp", ts))
                p = np.concatenate(
                    [p, np.full((len(p), 1), lag, np.float32)], axis=1)
                out.append(p)
        sample["points"] = np.concatenate(out)
        return sample


@PIPELINES.register
class RandomPointDrop:
    """Drop a random fraction of points (transforms_3d.py RandomPointDrop)."""

    def __init__(self, max_ratio: float = 0.4, prob: float = 0.5):
        self.max_ratio = max_ratio
        self.prob = prob

    def __call__(self, sample):
        rng: np.random.RandomState = sample["rng"]
        if rng.rand() >= self.prob:
            return sample
        ratio = rng.uniform(0, self.max_ratio)
        p = sample["points"]
        keep = rng.rand(len(p)) >= ratio
        sample["points"] = p[keep]
        return sample


@PIPELINES.register
class FrameDropout:
    """Drop whole past sweeps by their time-lag channel
    (transforms_3d.py FrameDropout): assumes the last point column is the
    per-sweep time lag added by LoadPointsFromMultiSweeps."""

    def __init__(self, drop_ratio: float = 0.2, time_dim: int = -1):
        self.drop_ratio = drop_ratio
        self.time_dim = time_dim

    def __call__(self, sample):
        rng: np.random.RandomState = sample["rng"]
        p = sample["points"]
        lags = np.unique(p[:, self.time_dim])
        keep = np.ones(len(p), bool)
        for lag in lags:
            if lag != 0 and rng.rand() < self.drop_ratio:
                keep &= p[:, self.time_dim] != lag
        sample["points"] = p[keep]
        return sample


@PIPELINES.register
class ObjectNoise:
    """Per-object random translation/rotation (transforms_3d.py ObjectNoise /
    box_np_ops noise_per_object), numpy implementation: moves each gt box and
    its interior points; reverts a move that would collide with another box."""

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 rot_range=(-0.15707963, 0.15707963), num_try: int = 10):
        self.translation_std = np.asarray(translation_std, np.float32)
        self.rot_range = rot_range
        self.num_try = num_try

    def __call__(self, sample):
        from sst_tpu_torch.core.evaluation import rotated_iou_matrix

        boxes = sample.get("gt_boxes")
        if boxes is None or len(boxes) == 0:
            return sample
        rng: np.random.RandomState = sample["rng"]
        pts = sample["points"]
        boxes = boxes.copy()
        for i in range(len(boxes)):
            for _ in range(self.num_try):
                t = rng.randn(3).astype(np.float32) * self.translation_std
                r = rng.uniform(*self.rot_range)
                nb = boxes[i].copy()
                nb[:3] += t
                nb[6] += r
                others = np.delete(boxes, i, axis=0)
                if len(others):
                    iou = rotated_iou_matrix(nb[None, :7], others[:, :7],
                                             mode="bev")
                    if (iou > 1e-4).any():
                        continue
                # move interior points with the box
                rel = pts[:, :2] - boxes[i, :2]
                c0, s0 = np.cos(-boxes[i, 6]), np.sin(-boxes[i, 6])
                lx = rel[:, 0] * c0 - rel[:, 1] * s0
                ly = rel[:, 0] * s0 + rel[:, 1] * c0
                inside = (
                    (np.abs(lx) <= boxes[i, 3] / 2)
                    & (np.abs(ly) <= boxes[i, 4] / 2)
                    & (pts[:, 2] >= boxes[i, 2])
                    & (pts[:, 2] <= boxes[i, 2] + boxes[i, 5])
                )
                if inside.any():
                    local = pts[inside, :3] - boxes[i, :3]
                    local[:, :2] = _rot2d(local[:, :2], r)
                    pts[inside, :3] = local + nb[:3]
                boxes[i] = nb
                break
        sample["points"] = pts
        sample["gt_boxes"] = boxes
        return sample


def build_pipeline(cfgs: list[dict]):
    """The transforms of ``cfgs`` (``dict(type=..., **kwargs)``) chained
    into one function of a sample."""
    from sst_tpu_torch.data import dbsampler  # noqa: F401 (ObjectSample)

    steps = [PIPELINES.build(dict(c)) for c in cfgs]
    def run(sample):
        for s in steps:
            sample = s(sample)
        return sample
    return run
