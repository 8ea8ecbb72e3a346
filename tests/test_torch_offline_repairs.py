"""Three faults of the port's offline data path, each held by a test that
fails where the fault stands (ROADMAP queue 3: F6, F7 and F9).

- F6: ``tools/ctrl/generate_candidates --poses`` moves the gt bin's ego
  boxes into the world frame of the tracklets that
  ``generate_track_input --poses`` wrote, so that they can match.
- F7: ``IncrementalWaymoDataset`` finds image-index seeds (the info, raw
  output and bin tools' keys) beside the converter's maps.
- F9: ``data/format_writers.py scene_points`` places every object point
  inside its box under ``core/boxes.py points_in_boxes``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from sst_tpu_torch.core.boxes import points_in_boxes
from sst_tpu_torch.core.tracklet import LiDARTracklet
from sst_tpu_torch.core.waymo_bin import write_waymo_bin
from sst_tpu_torch.data import format_writers as fw
from sst_tpu_torch.data import incremental_dataset as tinc
from sst_tpu_torch.tools.ctrl import generate_candidates
from torch_threads import torch_threads_per_worker  # noqa: F401

# float32 coordinates of points up to 20 m out are rounded by ~1e-6 m; a
# point drawn next to a face may cross it by that much
FACE_MARGIN = 1e-4


def _pose(yaw: float, t) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    m[:3, 3] = t
    return m


def test_candidates_match_world_tracklets(tmp_path):
    """A seeded sequence of 4 frames whose ego turns and drives: 3 cars
    per frame in the gt bin (ego frame), the tracker's tracklets the same
    boxes with 5 cm of noise, moved to the world frame. With ``--poses``
    every tracklet frame matches its car; without, none does (the poses
    move the boxes by tens of metres)."""
    rng = np.random.RandomState(6)
    ctx = "seg-f6"
    stamps = [1_000_000 + 100_000 * f for f in range(4)]
    poses = {ctx: {ts: _pose(0.4 + 0.05 * f, (30.0 + 2 * f, -12.0, 0.5))
                   for f, ts in enumerate(stamps)}}
    boxes = [np.concatenate([rng.uniform(-20, 20, (3, 2)),
                             rng.uniform(-1.8, -1.2, (3, 1)),
                             rng.uniform(1.8, 2.2, (3, 1)),
                             rng.uniform(4.0, 5.0, (3, 1)),
                             rng.uniform(1.4, 1.8, (3, 1)),
                             rng.uniform(-np.pi, np.pi, (3, 1))],
                            -1).astype(np.float32) for _ in stamps]
    gt_bin = write_waymo_bin(str(tmp_path / "gt.bin"), [
        dict(boxes=b, scores=np.ones(3, np.float32),
             labels=np.zeros(3, np.int64), context_name=ctx,
             timestamp_micros=ts) for b, ts in zip(boxes, stamps)])
    trks = []
    for k in range(3):
        ego = np.stack([b[k] for b in boxes])
        ego[:, :2] += rng.normal(0, 0.05, (4, 2)).astype(np.float32)
        trks.append(LiDARTracklet(ctx, f"obj{k}", 1, list(stamps), ego,
                                  np.full(4, 0.9, np.float32))
                    .to_world(poses[ctx]))
    trk_pkl = tmp_path / "tracklets.pkl"
    with open(trk_pkl, "wb") as f:
        pickle.dump(trks, f)
    pose_pkl = tmp_path / "poses_by_context.pkl"
    with open(pose_pkl, "wb") as f:
        pickle.dump(poses, f)

    def run(*extra):
        out = tmp_path / f"cands{len(extra)}.pkl"
        generate_candidates.main(["--tracklets", str(trk_pkl), "--gt-bin",
                                  gt_bin, "--out", str(out), *extra])
        with open(out, "rb") as f:
            return pickle.load(f)

    assert sum(c["valid"].sum() for c in run()) == 0
    cands = run("--poses", str(pose_pkl))
    for t, c in zip(trks, cands):
        assert c["valid"].all()
        # the candidate is the car's own gt box, in the world frame
        np.testing.assert_allclose(c["boxes"][:, :2], t.boxes[:, :2],
                                   atol=0.3)


def _seeded_world(tmp_path, keys):
    """A Waymo set with the converter's maps; seeds of every frame (one
    box, label ``i % 3``) under the image-index keys ``keys(idx)``."""
    root = str(tmp_path / "waymo")
    out = fw.write_waymo_set(root, seed=3, frames=4, points=300, boxes=3,
                             half=7.5)
    with open(out["validation"], "rb") as f:
        infos = pickle.load(f)
    seeds = {keys(info["image"]["image_idx"]): dict(
        boxes=np.asarray([[1.0, 2.0, -1.0, 2.0, 4.0, 1.5, 0.3]], np.float32),
        labels=np.asarray([i % 3]), scores=np.asarray([0.5], np.float32))
        for i, info in enumerate(infos)}
    path = os.path.join(root, "seeds.pkl")
    with open(path, "wb") as f:
        pickle.dump(seeds, f)
    return tinc.IncrementalWaymoDataset(
        data_root=root, info_path=out["validation"], seeds_path=path,
        num_previous_frames=2, max_points=2048, max_seeds=4, max_gt=4)


def test_image_index_seeds_found_beside_maps(tmp_path):
    """Beside ``idx2timestamp.pkl`` and ``idx2contextname.pkl``, seeds
    keyed by ``%07d`` (the info and raw-output tools) and by ``str(idx)``
    (the bin tool's keys of an int index map) are used: frame f of a
    sequence carries the seeds of its min(f, 2) earlier frames, with their
    labels."""
    for name, keys in (("padded", lambda i: f"{i:07d}"),
                       ("plain", lambda i: str(i))):
        ds = _seeded_world(tmp_path / name, keys)
        assert ds._idx2key  # the maps are there
        for i in range(len(ds)):
            s = ds[i]
            f = i % 4
            assert s["seed_valid"].sum() == min(f, 2), (name, i)
            want = [(i - k) % 3 for k in range(1, min(f, 2) + 1)]
            assert list(s["seed_labels"][s["seed_valid"]]) == want


def test_scene_points_lie_in_their_boxes():
    """Every object point ``scene_points`` writes (the first half of the
    rows) lies inside its box under ``points_in_boxes``, at any yaw; one
    box at a time, so each point's box is known."""
    rng = np.random.RandomState(9)
    for yaw in np.linspace(-np.pi, np.pi, 13):
        b = np.asarray([[rng.uniform(-15, 15), rng.uniform(-15, 15), -1.5,
                         1.2, 4.5, 1.6, yaw]], np.float32)
        pts = fw.scene_points(rng, b, 400, 20.0)
        inside = points_in_boxes(torch.from_numpy(pts[:200, :3]),
                                 torch.from_numpy(b), margin=FACE_MARGIN)
        assert inside.all(), f"yaw {yaw:.3f}: {int((~inside).sum())} out"
    # the seeded scenes of the writers: each box's points fill it
    pts, b = fw.scene(np.random.RandomState(1), 2000, 6, 20.0)
    held = points_in_boxes(torch.from_numpy(pts[:1000, :3]),
                           torch.from_numpy(b),
                           margin=FACE_MARGIN).any(1)
    assert held.all()
