"""Helpers shared by the CTRL offline scripts (counterpart of the JAX
package's ``tools/ctrl/utils.py``), on the port's bin codec
(``core/waymo_bin.py``) and ``LiDARTracklet``."""

from __future__ import annotations

import os
import pickle

import numpy as np

from sst_tpu_torch.core.tracklet import LiDARTracklet
from sst_tpu_torch.core.waymo_bin import read_bin_as_frames, read_waymo_bin

__all__ = ["generate_tracklets", "get_pc_from_time_stamp", "load_pose_maps",
           "read_bin", "read_bin_as_frames"]


def read_bin(path: str):
    """An Objects bin as a list of decoded object dicts."""
    return read_waymo_bin(path)


def generate_tracklets(bin_path: str, types=(1, 2, 4), min_len: int = 1):
    """A tracking bin grouped into ``LiDARTracklet``s of the given Waymo
    types."""
    tracklets = LiDARTracklet.from_waymo_bin(bin_path, min_len=min_len)
    return [t for t in tracklets if t.type_id in types]


def get_pc_from_time_stamp(timestamp, ts2idx, data_root, split="training"):
    """The six-channel velodyne points of a timestamp
    (``data_root/split/velodyne/<idx>.bin``)."""
    idx = ts2idx[timestamp]
    path = os.path.join(data_root, split, "velodyne", f"{idx}.bin")
    return np.fromfile(path, dtype=np.float32).reshape(-1, 6)


def load_pose_maps(kitti_root: str):
    """(``poses.pkl`` {timestamp: pose}, ``context2timestamp.pkl``), as
    ``extract_poses`` writes them."""
    with open(os.path.join(kitti_root, "poses.pkl"), "rb") as f:
        ts2pose = pickle.load(f)
    with open(os.path.join(kitti_root, "context2timestamp.pkl"), "rb") as f:
        context2ts = pickle.load(f)
    return ts2pose, context2ts
