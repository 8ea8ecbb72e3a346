"""The port's offline tools against the JAX package's, on a seeded Waymo
kitti-format set (``data/format_writers.py write_waymo_set``) and
detections near its gt, no model. JAX's scripts are imported by file path
and their ``main`` runs in this process with ``sys.argv`` set; the port's
take ``argv``.

- ``tools/ctrl``: ``extract_poses``' tables, ``generate_train_gt_bin``'s
  bin, ``merge_bins`` and ``remove_empty`` equal JAX's (bytes or values);
  ``generate_track_input`` groups the tracker-style bin as JAX's, its
  world boxes within 2e-5 m and 2e-6 rad (both move them in float32: JAX
  with jnp, the port with torch, at world coordinates of 100-150 m; the
  largest gaps seen are 3.8e-6 m and 2.4e-7 rad);
  ``generate_candidates`` run on JAX's tracklet pickle gives JAX's
  candidates exactly; ``extend_tracks``' bin equals JAX's in ids and
  scores, its boxes within the same tolerance.
- ``tools/fsdpp``: every seed tool's pickle and ``create_segment_break``'s
  breaks equal JAX's.
- ``WaymoTrackletDataset.format_results`` / ``evaluate`` on JAX's tracklet
  pickle write JAX's bytes and give JAX's metrics.
- F5: a pickle of JAX ``LiDARTracklet``s loads into the port's dataset in
  a process where ``jax``, ``flax`` and ``sst_tpu`` cannot be imported,
  the tracks equal, and no ``sst_tpu`` module enters ``sys.modules``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from sst_tpu.core import tracklet as jtrk
from sst_tpu.data import tracklet_dataset as jtds
from sst_tpu_torch.core import waymo_bin as twb
from sst_tpu_torch.data import format_writers as fw
from sst_tpu_torch.data import tracklet_dataset as ttds
from test_torch_waymo_bin import ROOT, load_jax_script, run_jax_script
from torch_threads import torch_threads_per_worker  # noqa: F401

BOX_TOL = dict(atol=2e-5, rtol=0)
YAW_TOL = 2e-6


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same(a, b, path="obj"):
    """Nested dicts, lists and arrays equal exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


def _yaw_gap(a, b):
    return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi).max(initial=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One training and two validation sequences of 5 frames (800 points,
    6 objects); per validation frame, detections near its gt (some
    dropped, one spurious), a raw ``tools.test --out`` dump of them, their
    Objects bin and a tracker-style bin (``assign_track_ids``)."""
    root = str(tmp_path_factory.mktemp("offline"))
    out = fw.write_waymo_set(root, seed=21, train_sequences=1,
                             val_sequences=2, frames=5, points=800, boxes=6,
                             half=20.0)
    rng = np.random.RandomState(22)
    infos = _load(out["validation"])
    idx2ts = _load(os.path.join(root, "idx2timestamp.pkl"))
    idx2cx = _load(os.path.join(root, "idx2contextname.pkl"))
    from sst_tpu_torch.data.datasets import WaymoDataset

    ds = WaymoDataset(data_root=root, info_path=out["validation"])
    raw, frames, poses = [], {}, {}
    for i, info in enumerate(infos):
        g = ds.get_sample(i)
        keep = rng.rand(len(g["gt_boxes"])) > 0.15
        boxes = g["gt_boxes"][keep].astype(np.float32) + rng.normal(
            0, 0.1, (int(keep.sum()), 7)).astype(np.float32)
        boxes = np.concatenate([boxes, np.asarray(
            [[rng.uniform(-15, 15), rng.uniform(-15, 15), -1.5, 2, 4, 1.5,
              0.3]], np.float32)])
        labels = np.concatenate([g["gt_labels"][keep], [0]]).astype(np.int32)
        scores = rng.uniform(0.2, 1.0, len(boxes)).astype(np.float32)
        raw.append(dict(boxes=boxes, scores=scores, labels=labels))
        key = f"{info['image']['image_idx']:07d}"
        frames[(idx2cx[key], idx2ts[key])] = raw[-1]
        poses.setdefault(idx2cx[key], {})[idx2ts[key]] = info["pose"]
    out["raw"] = os.path.join(root, "raw.pkl")
    with open(out["raw"], "wb") as f:
        pickle.dump(raw, f)
    out["dets"] = twb.write_waymo_bin(
        os.path.join(root, "dets.bin"),
        [dict(fr, context_name=k[0], timestamp_micros=k[1])
         for k, fr in frames.items()])
    out["tracks"] = twb.write_waymo_bin(
        os.path.join(root, "tracks.bin"),
        fw.assign_track_ids(frames, poses, max_dist=2.0))
    return out


def _run_both(name, argv_of, tmp_path, monkeypatch):
    """JAX's ``tools/<name>.py`` and the port's ``sst_tpu_torch.tools.<name>``
    each with ``argv_of(tag)`` (tag ``jax`` / ``port``)."""
    import importlib

    jmod = load_jax_script(f"tools/{name}.py", monkeypatch)
    run_jax_script(jmod, argv_of("jax"), monkeypatch)
    tmod = importlib.import_module("sst_tpu_torch.tools."
                                   + name.replace("/", "."))
    return tmod.main(argv_of("port"))


def test_ctrl_tables_gt_bin_merge_and_remove_equal_jax(world, tmp_path,
                                                       monkeypatch):
    root = world["root"]
    names = ("poses.pkl", "context2timestamp.pkl", "poses_by_context.pkl",
             "frame_index.pkl")
    jmod = load_jax_script("tools/ctrl/extract_poses.py", monkeypatch)
    run_jax_script(jmod, ["--kitti-root", root], monkeypatch)
    jax_tables = [_load(os.path.join(root, n)) for n in names]
    from sst_tpu_torch.tools.ctrl import extract_poses

    extract_poses.main(["--kitti-root", root])
    for n, ref in zip(names, jax_tables):
        _same(_load(os.path.join(root, n)), ref, n)
    assert len(jax_tables[0]) == 15 and len(jax_tables[1]) == 3

    def gt(tag):
        return ["--data-folder", os.path.dirname(world["tfrecord"]),
                "--output", str(tmp_path / f"gt_{tag}.bin")]

    _run_both("ctrl/generate_train_gt_bin", gt, tmp_path, monkeypatch)
    blob = (tmp_path / "gt_port.bin").read_bytes()
    assert blob == (tmp_path / "gt_jax.bin").read_bytes()
    got = twb.read_bin_as_frames(str(tmp_path / "gt_port.bin"))
    assert len(got) == 15 and all(len(f["obj_ids"]) == 6
                                  for f in got.values())

    def merge(tag):
        return ["--bins", world["dets"], world["tracks"],
                str(tmp_path / "gt_jax.bin"),
                "--out", str(tmp_path / f"merged_{tag}.bin")]

    _run_both("ctrl/merge_bins", merge, tmp_path, monkeypatch)
    assert (tmp_path / "merged_port.bin").read_bytes() == \
        (tmp_path / "merged_jax.bin").read_bytes()
    from sst_tpu_torch.tools.ctrl import merge_bins

    with pytest.raises(FileExistsError):
        merge_bins.main(merge("port"))

    def remove(tag):
        return ["--bin", world["dets"], "--kitti-root", root, "--split",
                "validation", "--extra-hw", "0.1",
                "--out", str(tmp_path / f"nonempty_{tag}.bin")]

    _run_both("ctrl/remove_empty", remove, tmp_path, monkeypatch)
    kept = (tmp_path / "nonempty_port.bin").read_bytes()
    assert kept == (tmp_path / "nonempty_jax.bin").read_bytes()
    # the spurious box of each frame mostly holds no point
    n_in = sum(len(f["scores"]) for f in twb.read_bin_as_frames(
        world["dets"]).values())
    n_out = sum(len(f["scores"]) for f in twb.read_bin_as_frames(
        str(tmp_path / "nonempty_port.bin")).values())
    assert 0 < n_out < n_in


def _same_tracklets(t, j):
    assert [(x.context_name, x.obj_id, x.type_id, list(x.timestamps))
            for x in t] == [(x.context_name, x.obj_id, x.type_id,
                             list(x.timestamps)) for x in j]
    for x, y in zip(t, j):
        np.testing.assert_allclose(x.boxes[:, :6], y.boxes[:, :6],
                                   **BOX_TOL)
        assert _yaw_gap(x.boxes[:, 6], y.boxes[:, 6]) <= YAW_TOL
        np.testing.assert_array_equal(x.scores, y.scores)


def test_ctrl_tracklets_candidates_and_extension_equal_jax(world, tmp_path,
                                                           monkeypatch):
    root = world["root"]
    from sst_tpu_torch.tools.ctrl import extract_poses

    extract_poses.main(["--kitti-root", root])

    def track_input(tag):
        return ["--bin", world["tracks"], "--poses",
                os.path.join(root, "poses_by_context.pkl"),
                "--out", str(tmp_path / f"trk_{tag}.pkl")]

    _run_both("ctrl/generate_track_input", track_input, tmp_path,
              monkeypatch)
    t = _load(tmp_path / "trk_port.pkl")
    j = _load(tmp_path / "trk_jax.pkl")
    assert type(t[0]).__module__ == "sst_tpu_torch.core.tracklet"
    assert type(j[0]).__module__ == "sst_tpu.core.tracklet"
    assert len(t) >= 8 and all(len(x) >= 2 for x in t)
    _same_tracklets(t, j)

    gt = str(tmp_path / "gt.bin")
    from sst_tpu_torch.tools.ctrl import generate_train_gt_bin

    generate_train_gt_bin.main(["--data-folder",
                                os.path.dirname(world["tfrecord"]),
                                "--output", gt])

    def cands(tag):
        # both read JAX's tracklets: the port through load_tracklets
        return ["--tracklets", str(tmp_path / "trk_jax.pkl"), "--gt-bin",
                gt, "--out", str(tmp_path / f"cand_{tag}.pkl")]

    _run_both("ctrl/generate_candidates", cands, tmp_path, monkeypatch)
    c = _load(tmp_path / "cand_port.pkl")
    _same(c, _load(tmp_path / "cand_jax.pkl"))
    # JAX's tool matches the world-frame tracks against the gt bin's ego
    # boxes (ROADMAP queue 3, F6): only frames whose pose is near the
    # identity match, in both packages
    assert sum(int(x["valid"].sum()) for x in c) > 0

    def extend(tag):
        return ["--bin", world["tracks"], "--kitti-root", root,
                "--extend-length", "3", "--min-length", "2",
                "--out", str(tmp_path / f"ext_{tag}.bin")]

    _run_both("ctrl/extend_tracks", extend, tmp_path, monkeypatch)
    a = twb.read_bin_as_frames(str(tmp_path / "ext_port.bin"))
    b = twb.read_bin_as_frames(str(tmp_path / "ext_jax.bin"))
    assert sorted(a) == sorted(b)
    added = 0
    for k in a:
        assert a[k]["obj_ids"] == b[k]["obj_ids"]
        np.testing.assert_array_equal(a[k]["scores"], b[k]["scores"])
        np.testing.assert_allclose(a[k]["boxes"][:, :6], b[k]["boxes"][:, :6],
                                   **BOX_TOL)
        assert _yaw_gap(a[k]["boxes"][:, 6], b[k]["boxes"][:, 6]) <= YAW_TOL
        added += len(a[k]["scores"])
    assert added > sum(len(f["scores"]) for f in twb.read_bin_as_frames(
        world["tracks"]).values())


def test_fsdpp_seed_tools_equal_jax(world, tmp_path, monkeypatch):
    root = world["root"]
    runs = {
        "fsdpp/generate_seeds": lambda tag: [
            "--bin", world["dets"], "--score-thr", "0.3",
            "--out", str(tmp_path / f"gs_{tag}.pkl")],
        "fsdpp/create_seed_boxes_from_bin": lambda tag: [
            "--bin", world["dets"], "--idx2ts",
            os.path.join(root, "idx2timestamp.pkl"),
            "--out", str(tmp_path / f"sb_{tag}.pkl")],
        "fsdpp/create_seed_boxes_from_info": lambda tag: [
            "--info", world["training"],
            "--out", str(tmp_path / f"si_{tag}.pkl")],
        "fsdpp/create_seed_boxes_from_raw_output": lambda tag: [
            "--raw", world["raw"], "--info", world["validation"],
            "--score-thr", "0.5", "--out", str(tmp_path / f"sr_{tag}.pkl")],
        "fsdpp/create_segment_break": lambda tag: [
            "--info", world["validation"], "--num-shards", "2",
            "--out", str(tmp_path / f"br_{tag}.pkl")],
    }
    for name, argv_of in runs.items():
        _run_both(name, argv_of, tmp_path, monkeypatch)
    for prefix in ("gs", "sb", "si", "sr", "br"):
        got = _load(tmp_path / f"{prefix}_port.pkl")
        _same(got, _load(tmp_path / f"{prefix}_jax.pkl"), prefix)
        assert len(got) > 1, prefix
    assert _load(tmp_path / "br_port.pkl") == [0, 5, 10]
    keys = sorted(_load(tmp_path / "si_port.pkl"))
    assert keys[0] == "0000000" and len(keys) == 5


def _refined(ds, seed):
    """Refined tracks in the track-centric frame: each track's boxes
    jittered, a frame invalid, one track all invalid."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        s = ds[i]
        n = int(s["trk_valid"].sum())
        valid = rng.rand(n) > 0.2
        if i == 1:
            valid[:] = False
        out.append(dict(boxes=s["trk_boxes"][:n] + rng.normal(
            0, 0.05, (n, 7)).astype(np.float32),
            scores=rng.rand(n).astype(np.float32), valid=valid,
            track_center=s["track_center"]))
    return out


def test_tracklet_dataset_format_results_and_evaluate_equal_jax(
        world, tmp_path, monkeypatch):
    root = world["root"]
    from sst_tpu_torch.tools.ctrl import (
        extract_poses,
        generate_track_input,
        generate_train_gt_bin,
    )

    extract_poses.main(["--kitti-root", root])
    jmod = load_jax_script("tools/ctrl/generate_track_input.py", monkeypatch)
    trk = str(tmp_path / "trk_jax.pkl")
    run_jax_script(jmod, ["--bin", world["tracks"], "--poses",
                          os.path.join(root, "poses_by_context.pkl"),
                          "--out", trk], monkeypatch)
    gt = str(tmp_path / "gt.bin")
    generate_train_gt_bin.main(["--data-folder",
                                os.path.dirname(world["tfrecord"]),
                                "--output", gt])
    kw = dict(data_root=root, tracklet_path=trk,
              poses_path=os.path.join(root, "poses_by_context.pkl"),
              frame_index_path=os.path.join(root, "frame_index.pkl"),
              max_points=2048, max_frames=8)
    t, j = ttds.WaymoTrackletDataset(**kw), jtds.WaymoTrackletDataset(**kw)
    res = _refined(t, 31)
    a = t.format_results(res, str(tmp_path / "port.bin"))
    b = j.format_results(res, str(tmp_path / "jax.bin"))
    assert len(a) == len(b) == len(t) - 1
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()
    got = t.evaluate(res, str(tmp_path / "port_eval.bin"), gt_bin=gt)
    want = j.evaluate(res, str(tmp_path / "jax_eval.bin"), gt_bin=gt)
    assert got.pop("bin_path").endswith("port_eval.bin")
    want.pop("bin_path")
    assert got == want and 0.0 < got["Overall/L2 mAP"] <= 100.0
    assert t.evaluate(res, str(tmp_path / "only.bin")) == {
        "bin_path": str(tmp_path / "only.bin")}
    # a port-written pickle of the same tracks reads back as the port's
    tport = str(tmp_path / "trk_port.pkl")
    generate_track_input.main(["--bin", world["tracks"], "--poses",
                               os.path.join(root, "poses_by_context.pkl"),
                               "--out", tport])
    assert len(ttds.load_tracklets(tport)) == len(t)


_F5_CHECK = r"""
import pickle
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _Blocked())
from sst_tpu_torch.data.tracklet_dataset import WaymoTrackletDataset

root, trk, poses, index = sys.argv[1:5]
ds = WaymoTrackletDataset(root, trk, poses, index, max_points=512,
                          max_frames=8)
sample = ds[0]
tracks = [(type(t).__module__, t.context_name, t.obj_id, t.type_id,
           list(t.timestamps), t.boxes.tolist(), t.scores.tolist())
          for t in ds.tracklets]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "sst_tpu"))
print(repr((loaded, tracks, int(sample["valid"].sum()))))
"""


def test_jax_tracklet_pickle_loads_without_jax(world, tmp_path):
    """F5: JAX's ``tools/ctrl`` pickles ``sst_tpu.core.tracklet``
    ``LiDARTracklet``s; the port's dataset reads them in a process that
    cannot import ``jax``, ``flax`` or ``sst_tpu`` (a plain ``pickle.load``
    imports ``sst_tpu.core``, which imports JAX), and refuses a pickle that
    names any other class of the JAX package."""
    from sst_tpu_torch.tools.ctrl import extract_poses

    root = world["root"]
    extract_poses.main(["--kitti-root", root])
    jtracks = jtrk.LiDARTracklet.from_waymo_bin(world["tracks"], min_len=2)
    assert len(jtracks) >= 8
    trk = str(tmp_path / "jax_tracklets.pkl")
    with open(trk, "wb") as f:
        pickle.dump(jtracks, f)
    paths = [root, trk, os.path.join(root, "poses_by_context.pkl"),
             os.path.join(root, "frame_index.pkl")]
    res = subprocess.run([sys.executable, "-c", _F5_CHECK, *paths], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded, tracks, n_points = eval(res.stdout.strip().splitlines()[-1])
    assert loaded == []
    assert tracks == [("sst_tpu_torch.core.tracklet", t.context_name,
                       t.obj_id, t.type_id, list(t.timestamps),
                       t.boxes.tolist(), t.scores.tolist())
                      for t in jtracks]
    assert n_points > 0
    bad = str(tmp_path / "other.pkl")
    with open(bad, "wb") as f:
        pickle.dump([jtrk.pad_tracklet_arrays], f)
    with pytest.raises(pickle.UnpicklingError, match="sst_tpu.core.tracklet"):
        ttds.load_tracklets(bad)


def test_train_cli_trains_ctrl_on_the_tracklet_kind(world, tmp_path,
                                                    monkeypatch):
    """F8: ``tools.train`` on the ``waymo_tracklet`` kind (the chain's
    tracklets, a small ``TrackletDetector`` config) trains; the dataset
    set-up read ``model.point_cloud_range``, which CTRL's model lacks, for
    a pipeline the tracklet samples never run. TensorBoard is absent, as on
    the card's machine (``tests/test_torch_tools.py`` covers its writer)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from sst_tpu_torch import flagship as tflag
    from sst_tpu_torch.tools import train as train_cli
    from sst_tpu_torch.tools.ctrl import extract_poses, generate_track_input

    root = world["root"]
    extract_poses.main(["--kitti-root", root])
    trk = str(tmp_path / "trk.pkl")
    generate_track_input.main(["--bin", world["tracks"], "--poses",
                               os.path.join(root, "poses_by_context.pkl"),
                               "--out", trk])
    model = dict(type="TrackletDetector", segmentor=dict(
        point_cloud_range=(-3.2, -3.2, -4.0, 3.2, 3.2, 4.0),
        voxel_size=(0.2, 0.2, 0.4), max_voxels=512,
        unet_level_caps=(512, 256, 128),
        vfe=dict(feat_channels=(16, 16), mode="max"),
        unet=dict(in_channels=16, base_channels=16,
                  encoder_channels=((16,), (16, 16), (16, 16)),
                  decoder_channels=((16, 16, 16),) * 3)),
        roi_head=dict(num_classes=1, **tflag._tiny_roi_head_cfg()))
    data = dict(dataset="waymo_tracklet", samples_per_device=2,
                data_root=root, tracklet_path=trk,
                poses_path=os.path.join(root, "poses_by_context.pkl"),
                frame_index_path=os.path.join(root, "frame_index.pkl"))
    cfg = tmp_path / "tiny_ctrl.py"
    cfg.write_text(f"model = {model!r}\ncapacity = dict(max_points=1024, "
                   f"max_frames=8)\ndata = {data!r}\n")
    summary = train_cli.main([str(cfg), "--device", "cpu", "--work-dir",
                              str(tmp_path / "wd"), "--max-steps", "2"])
    assert summary["steps"] == 2
    assert np.isfinite(summary["loss_total"]).all()
