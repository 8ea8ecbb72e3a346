"""LiDARTracklet, the host-side track container of CTRL, and the padding of
one tracklet into the fixed-shape arrays a ``TrackletBatch`` stacks
(counterpart of ``sst_tpu/core/tracklet.py``, numpy code copied, not
imported).

A tracklet holds one track's per-frame boxes, timestamps and scores, moves
them between ego and world frames, extends them at constant velocity and
adds the test-time noise. The Waymo Objects-bin reading and writing
(``from_waymo_bin``, ``to_frames``, ``tracklets_to_bin``) is not ported
yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sst_tpu_torch.ops.incremental import box_frame_transform


def _box_frame_transform_np(boxes, pre_pose, cur_inv):
    """Host-side 7-dof box pose transform in float64, rounded to float32:
    the centre rotated and moved, the yaw through the heading vector
    (sin(yaw), cos(yaw), 0)."""
    mm = cur_inv @ pre_pose
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ mm[:3, :3].T + mm[:3, 3]
    yaw = boxes[:, 6]
    heading = np.stack([np.sin(yaw), np.cos(yaw), np.zeros_like(yaw)], -1)
    heading = heading @ mm[:3, :3].T
    out[:, 6] = np.arctan2(heading[:, 0], heading[:, 1])
    return out.astype(np.float32)


@dataclasses.dataclass
class LiDARTracklet:
    context_name: str
    obj_id: str
    type_id: int  # WOD Label.Type (1 vehicle, 2 pedestrian, 4 cyclist)
    timestamps: list  # [F] int64 microseconds
    boxes: np.ndarray  # [F, 7] per-frame ego coordinates
    scores: np.ndarray  # [F]

    def __len__(self):
        return len(self.timestamps)

    # ------------------------------------------------------------- transforms

    def to_world(self, poses: dict) -> "LiDARTracklet":
        """Boxes into the world frame by each timestamp's 4x4 ego pose, in
        float32 as the JAX package computes it."""
        eye = torch.eye(4)
        out = [box_frame_transform(
            torch.as_tensor(np.asarray(box, np.float32)[None]),
            torch.as_tensor(np.asarray(poses[ts], np.float32)), eye)[0]
            .numpy() for ts, box in zip(self.timestamps, self.boxes)]
        return dataclasses.replace(self, boxes=np.stack(out))

    def center_frame(self):
        """All boxes moved so that the track's median centre is the origin
        (the track-centric frame CTRL trains in); returns (tracklet,
        centre)."""
        ctr = np.median(self.boxes[:, :3], axis=0)
        boxes = self.boxes.copy()
        boxes[:, :3] -= ctr
        return dataclasses.replace(self, boxes=boxes), ctr

    def to_ego(self, poses: dict) -> "LiDARTracklet":
        """World-frame boxes into each frame's own ego frame (the inverse
        of :meth:`to_world`)."""
        eye = np.eye(4, dtype=np.float64)
        out = []
        for ts, box in zip(self.timestamps, self.boxes):
            inv = np.linalg.inv(np.asarray(poses[ts], np.float64))
            out.append(_box_frame_transform_np(box[None], eye, inv)[0])
        return dataclasses.replace(self, boxes=np.stack(out))

    # ----------------------------------------------------- velocity/extension

    def velocity(self) -> np.ndarray:
        """[F, 3] forward-difference centre velocity (m/s), the first row
        repeated. The boxes must share one (world) frame."""
        if len(self) <= 1:
            return np.zeros((len(self), 3), np.float32)
        t = (np.asarray(self.timestamps, np.float64)
             - self.timestamps[0]) / 1e6
        d = np.diff(self.boxes[:, :3], axis=0) / np.maximum(
            np.diff(t)[:, None], 1e-6)
        return np.concatenate([d[:1], d], 0).astype(np.float32)

    def _extrapolate(self, anchor_i, target_ts, velo, score_multiplier):
        t0 = self.timestamps[anchor_i] / 1e6
        boxes, scores = [], []
        for k, ts in enumerate(target_ts):
            b = self.boxes[anchor_i].copy()
            b[:2] += velo[:2] * (ts / 1e6 - t0)
            boxes.append(b)
            scores.append(self.scores[anchor_i] * score_multiplier ** (k + 1))
        return boxes, scores

    def extend(self, length: int, direction: str, full_ts_list, min_length: int,
               score_multiplier: float = 0.9, velo_window_size: int = 10):
        """Constant-velocity extension in a shared world frame: up to
        ``length`` boxes prepended at the timestamps before the track,
        their scores decayed geometrically. Only ``"backward"`` exists."""
        if direction != "backward":
            raise ValueError(f"direction {direction!r}: only 'backward' "
                             f"extends")
        # the velocity and gap checks read timestamps[1]: a single-frame
        # track is never extended, whatever min_length says
        if len(self) < max(min_length, 2):
            return self
        idx = full_ts_list.index(self.timestamps[0])
        length = min(length, idx)
        if length <= 0:
            return self
        if (self.timestamps[1] - self.timestamps[0]) / 1e6 > 0.5:
            return self  # a gap at the start: no usable velocity
        velo = self.velocity()[:velo_window_size].mean(0)
        target = full_ts_list[idx - length: idx]
        boxes, scores = self._extrapolate(0, target, velo, score_multiplier)
        return dataclasses.replace(
            self,
            timestamps=list(target) + list(self.timestamps),
            boxes=np.concatenate([np.stack(boxes), self.boxes]),
            scores=np.concatenate([np.asarray(scores, np.float32),
                                   self.scores]),
        )

    def extend_all(self, full_ts_list, min_length: int,
                   score_multiplier: float = 0.9, velo_window_size: int = 10):
        """Extended to every timestamp of the sequence: backward from the
        first box, forward from the last."""
        if len(self) < max(min_length, 2):
            return self
        out = self
        left = full_ts_list.index(self.timestamps[0])
        if left > 0 and (self.timestamps[1] - self.timestamps[0]) / 1e6 <= 0.5:
            out = out.extend(left, "backward", full_ts_list, min_length,
                             score_multiplier, velo_window_size)
        right = full_ts_list.index(self.timestamps[-1]) + 1
        n_fwd = len(full_ts_list) - right
        # a gap of more than 0.5 s before the last box leaves no usable
        # velocity at the tail
        if n_fwd > 0 and \
                (self.timestamps[-1] - self.timestamps[-2]) / 1e6 <= 0.5:
            velo = self.velocity()[-velo_window_size:].mean(0)
            target = full_ts_list[right:]
            boxes, scores = self._extrapolate(
                len(self) - 1, target, velo, score_multiplier)
            # the anchor indexes the original track; spliced onto out
            out = dataclasses.replace(
                out,
                timestamps=list(out.timestamps) + list(target),
                boxes=np.concatenate([out.boxes, np.stack(boxes)]),
                scores=np.concatenate([out.scores,
                                       np.asarray(scores, np.float32)]),
            )
        return out

    # ------------------------------------------------------- frame selection

    def slice(self, beg: int, end: int) -> "LiDARTracklet":
        return dataclasses.replace(
            self, timestamps=list(self.timestamps[beg:end]),
            boxes=self.boxes[beg:end], scores=self.scores[beg:end],
        )

    def remove(self, ts_list) -> "LiDARTracklet":
        drop = set(ts_list)
        keep = [i for i, t in enumerate(self.timestamps) if t not in drop]
        return dataclasses.replace(
            self, timestamps=[self.timestamps[i] for i in keep],
            boxes=self.boxes[keep], scores=self.scores[keep],
        )

    def random_frame_drop(self, drop_rate: float, rng) -> "LiDARTracklet":
        """Training augmentation: each frame dropped with ``drop_rate``
        (``rng`` a numpy RandomState), at least one kept."""
        if len(self) <= 1:
            return self
        keep = rng.rand(len(self)) >= drop_rate
        if not keep.any():
            keep[rng.randint(len(self))] = True
        idx = np.flatnonzero(keep)
        return dataclasses.replace(
            self, timestamps=[self.timestamps[i] for i in idx],
            boxes=self.boxes[idx], scores=self.scores[idx],
        )

    def ts_intersection(self, other: "LiDARTracklet"):
        return sorted(set(self.timestamps) & set(other.timestamps))

    # -------------------------------------------------------------- TTA noise

    def add_center_noise(self, max_noise: float, rng, consistent=False):
        n = (rng.rand(1 if consistent else len(self), 3) * 2 - 1) * max_noise
        boxes = self.boxes.copy()
        boxes[:, :3] += n
        return dataclasses.replace(self, boxes=boxes)

    def add_size_noise(self, max_noise: float, rng, consistent=False):
        n = (rng.rand(1 if consistent else len(self), 3) * 2 - 1) * max_noise
        boxes = self.boxes.copy()
        boxes[:, 3:6] = np.maximum(boxes[:, 3:6] + n, 0.1)
        return dataclasses.replace(self, boxes=boxes)

    def add_yaw_noise(self, max_noise: float, rng, consistent=False):
        n = (rng.rand(1 if consistent else len(self)) * 2 - 1) * max_noise
        boxes = self.boxes.copy()
        boxes[:, 6] += n
        return dataclasses.replace(self, boxes=boxes)


def pad_tracklet_arrays(points, frame_inds, boxes, scores, gt_boxes, gt_valid,
                        label: int, max_points: int, max_frames: int):
    """One tracklet → the fixed-shape numpy arrays of one ``TrackletBatch``
    row. A track with more than ``max_points`` points keeps a subsample
    drawn by ``np.random.RandomState(0)``, the JAX package's draw."""
    c = points.shape[1] if len(points) else 6
    p_out = np.zeros((max_points, c), np.float32)
    f_out = np.zeros(max_points, np.int32)
    v_out = np.zeros(max_points, bool)
    n = min(len(points), max_points)
    sel = np.arange(len(points))
    if len(points) > max_points:
        sel = np.random.RandomState(0).choice(len(points), max_points, False)
    p_out[:n] = points[sel][:n]
    f_out[:n] = np.clip(frame_inds[sel][:n], 0, max_frames - 1)
    v_out[:n] = True

    f = min(len(boxes), max_frames)
    b_out = np.zeros((max_frames, 7), np.float32)
    s_out = np.zeros(max_frames, np.float32)
    tv = np.zeros(max_frames, bool)
    g_out = np.zeros((max_frames, 7), np.float32)
    gv = np.zeros(max_frames, bool)
    b_out[:f] = boxes[:f]
    s_out[:f] = scores[:f]
    tv[:f] = True
    if gt_boxes is not None:
        g_out[:f] = gt_boxes[:f]
        gv[:f] = gt_valid[:f]
    return dict(points=p_out, valid=v_out, frame_inds=f_out, trk_boxes=b_out,
                trk_scores=s_out, trk_valid=tv, labels=np.int32(label),
                gt_boxes=g_out, gt_valid=gv)
