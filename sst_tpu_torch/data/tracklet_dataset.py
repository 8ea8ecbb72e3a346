"""WaymoTrackletDataset: one CTRL sample per track (counterpart of
``sst_tpu/data/tracklet_dataset.py``, numpy code copied, not imported).

A sample is one track: each frame's points cropped around its (enlarged)
tracker box, moved into the world frame by the frame's ego pose and then
into a track-centric frame (the median box centre at the origin), with a
time channel of ``frame * 0.1``; the per-frame tracker boxes and, for
training, the one-to-one gt candidate boxes, in the same frame.

Inputs (pickles the JAX package's ``tools/ctrl`` scripts write):
  tracklet_path   a list of ``LiDARTracklet`` in the world frame
  candidates_path one dict per tracklet: ``boxes`` [F, 7] (world frame)
                  and ``valid`` [F]
  poses_path      {context_name: {timestamp: 4x4 ego → world}}
  frame_index     {(context_name, timestamp): points .bin path}

:func:`collate_tracklets` stacks samples into a torch ``TrackletBatch`` on
a device. The Waymo-bin output (``format_results``, ``evaluate``) is not
ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from sst_tpu_torch.core.tracklet import pad_tracklet_arrays


class WaymoTrackletDataset:
    CLASSES = ("Car", "Pedestrian", "Cyclist")
    TYPE2LABEL = {1: 0, 2: 1, 4: 2}

    def __init__(self, data_root, tracklet_path, poses_path, frame_index_path,
                 candidates_path=None, load_dim: int = 6,
                 use_dim=(0, 1, 2, 3, 4), extra_wlh=(1.0, 1.0, 1.0),
                 max_points: int = 32768, max_frames: int = 200,
                 test_mode: bool = False, seed: int = 0):
        self.data_root = data_root
        with open(tracklet_path, "rb") as f:
            self.tracklets = pickle.load(f)
        with open(poses_path, "rb") as f:
            self.poses = pickle.load(f)
        with open(frame_index_path, "rb") as f:
            self.frame_index = pickle.load(f)
        self.candidates = None
        if candidates_path:
            with open(candidates_path, "rb") as f:
                self.candidates = pickle.load(f)
            if len(self.candidates) != len(self.tracklets):
                raise ValueError(
                    f"{len(self.candidates)} candidate sets for "
                    f"{len(self.tracklets)} tracklets")
        self.load_dim = load_dim
        self.use_dim = list(use_dim)
        self.extra_wlh = np.asarray(extra_wlh, np.float32)
        self.max_points = max_points
        self.max_frames = max_frames
        self.test_mode = test_mode
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.tracklets)

    def _load_frame(self, context, ts):
        path = self.frame_index.get((context, ts))
        if path is None:
            return None
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        pts = np.fromfile(path, dtype=np.float32).reshape(-1, self.load_dim)
        return pts[:, self.use_dim]

    def __getitem__(self, idx):
        trk = self.tracklets[idx]
        n_frames = min(len(trk), self.max_frames)
        ctr = np.median(trk.boxes[:n_frames, :3], axis=0)

        pts_list, frame_ids = [], []
        world_boxes = trk.boxes[:n_frames].copy()
        for fi in range(n_frames):
            ts = trk.timestamps[fi]
            frame = self._load_frame(trk.context_name, ts)
            if frame is None:
                continue
            pose = np.asarray(self.poses[trk.context_name][ts], np.float64)
            xyz_world = frame[:, :3] @ pose[:3, :3].T + pose[:3, 3]
            box = world_boxes[fi]
            ew = self.extra_wlh
            rel = xyz_world[:, :2] - box[:2]
            c, s = np.cos(-box[6]), np.sin(-box[6])
            lx = rel[:, 0] * c - rel[:, 1] * s
            ly = rel[:, 0] * s + rel[:, 1] * c
            m = (
                (np.abs(lx) <= box[3] / 2 + ew[0])
                & (np.abs(ly) <= box[4] / 2 + ew[1])
                & (xyz_world[:, 2] >= box[2] - ew[2])
                & (xyz_world[:, 2] <= box[2] + box[5] + ew[2])
            )
            crop = np.concatenate(
                [xyz_world[m] - ctr, frame[m, 3:],
                 np.full((int(m.sum()), 1), fi * 0.1, np.float32)], axis=1,
            ).astype(np.float32)
            pts_list.append(crop)
            frame_ids.append(np.full(len(crop), fi, np.int32))

        points = np.concatenate(pts_list) if pts_list else \
            np.zeros((0, len(self.use_dim) + 1), np.float32)
        frame_inds = np.concatenate(frame_ids) if frame_ids else \
            np.zeros(0, np.int32)
        boxes = world_boxes.copy()
        boxes[:, :3] -= ctr

        gt_boxes = gt_valid = None
        if self.candidates is not None:
            cand = self.candidates[idx]
            gt_boxes = cand["boxes"][:n_frames].copy()
            gt_boxes[:, :3] -= ctr
            gt_valid = cand["valid"][:n_frames]

        out = pad_tracklet_arrays(
            points, frame_inds, boxes, trk.scores[:n_frames], gt_boxes,
            gt_valid, self.TYPE2LABEL.get(trk.type_id, 0), self.max_points,
            self.max_frames,
        )
        out["idx"] = idx
        out["track_center"] = ctr
        out["rng"] = self._rng
        return out


_BATCH_KEYS = ("points", "valid", "frame_inds", "trk_boxes", "trk_scores",
               "trk_valid", "labels", "gt_boxes", "gt_valid")


def collate_tracklets(samples, device="cuda"):
    """Padded tracklet samples stacked into a ``TrackletBatch`` on
    ``device`` (the card by default; pass ``"cpu"`` for the CPU)."""
    from sst_tpu_torch.models.ctrl import TrackletBatch

    return TrackletBatch(**{k: np.stack([s[k] for s in samples])
                            for k in _BATCH_KEYS}).to(device)
