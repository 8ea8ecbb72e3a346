"""FSD++'s sequential data path on the port against the JAX package's, on
a seeded Waymo kitti-format set (``data/format_writers.py
write_waymo_set``: sequences whose ego moves, six-channel points, poses,
the converter's maps), no jitted JAX model.

- ``IncrementalWaymoDataset`` samples equal JAX's under the same seed:
  points, frame ages and the rows the point cap draws, gt and seed labels,
  scores and masks exactly; the seed boxes, which both move into the
  current frame in float32 (JAX with jnp, the port with
  ``ops/incremental.py box_frame_transform`` on CPU tensors), within
  4e-6 m and 2e-6 rad (float32 products in another order; the largest
  gaps seen are 4.8e-7 m and 2.4e-7 rad).
- ``run_sequential_eval`` with one deterministic numpy ``predict_fn`` in
  both packages feeds the same seeds to every frame (the previous frame's
  detections, moved by float64 numpy in both: exactly) and returns the
  same results; a sequence's first frame gets none.
- The ``waymo_incremental`` kind (``sequential=True``) of
  ``train/data_setup.py`` builds JAX's dataset and collates a
  ``TemporalBatch`` of CPU tensors equal to JAX's.
- On the tiny FSD++ (``flagship.tiny_fsdpp``'s config in a config file),
  ``tools.train`` trains two steps on that kind and ``tools.test
  --sequential`` runs over the validation sequences on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import pickle

import numpy as np
import pytest
import torch

from sst_tpu.data import incremental_dataset as jinc
from sst_tpu.train import data_setup as jsetup
from sst_tpu_torch import flagship as tflag
from sst_tpu_torch.data import format_writers as fw
from sst_tpu_torch.data import incremental_dataset as tinc
from sst_tpu_torch.train import data_setup as tsetup
from torch_threads import torch_threads_per_worker  # noqa: F401

SEED_TOL = dict(atol=4e-6, rtol=0)
YAW_TOL = 2e-6
EXACT = ("points", "valid", "frame_inds", "gt_boxes", "gt_labels",
         "gt_valid", "seed_labels", "seed_scores", "seed_valid")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Two training and two validation sequences of 4 frames, 600 points
    each (within 7.5 m, the tiny FSD++'s range), 5 objects; seeds from the
    gt boxes keyed by (context, timestamp), all of JAX's dataset inputs."""
    root = str(tmp_path_factory.mktemp("waymo_seq"))
    out = fw.write_waymo_set(root, seed=11, frames=4, points=600, boxes=5,
                             half=7.5)
    with open(os.path.join(root, "idx2timestamp.pkl"), "rb") as f:
        idx2ts = pickle.load(f)
    with open(os.path.join(root, "idx2contextname.pkl"), "rb") as f:
        idx2cx = pickle.load(f)
    rng = np.random.RandomState(12)
    seeds = {}
    for split in ("training", "validation"):
        with open(out[split], "rb") as f:
            infos = pickle.load(f)
        ds = tinc.IncrementalWaymoDataset(data_root=root,
                                          info_path=out[split])
        for i, info in enumerate(infos):
            key = f"{info['image']['image_idx']:07d}"
            g = ds.get_sample(i)
            seeds[(idx2cx[key], idx2ts[key])] = dict(
                boxes=g["gt_boxes"].astype(np.float32) + rng.normal(
                    0, 0.1, g["gt_boxes"].shape).astype(np.float32),
                labels=g["gt_labels"],
                scores=rng.rand(len(g["gt_labels"])).astype(np.float32))
    out["seeds"] = os.path.join(root, "seeds.pkl")
    with open(out["seeds"], "wb") as f:
        pickle.dump(seeds, f)
    return out


def _kw(world, split="training", **kw):
    return dict(dict(data_root=world["root"], info_path=world[split],
                     seeds_path=world["seeds"], num_previous_frames=2,
                     max_points=1500, max_seeds=12, max_gt=4, seed=3), **kw)


def _same_sample(a: dict, b: dict):
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["seed_boxes"][:, :6], b["seed_boxes"][:, :6],
                               **SEED_TOL)
    d = (a["seed_boxes"][:, 6] - b["seed_boxes"][:, 6] + np.pi) \
        % (2 * np.pi) - np.pi
    assert np.abs(d).max() <= YAW_TOL


def test_incremental_samples_equal_jax(world):
    """Every sample of both splits: three frames of 600 points exceed the
    1,500-point cap, so the draw runs (the same ``RandomState`` calls in
    the same order); frame 0 of a sequence has no history and no seeds;
    gt capped at 4 of 5."""
    for split in ("training", "validation"):
        t = tinc.IncrementalWaymoDataset(**_kw(world, split))
        j = jinc.IncrementalWaymoDataset(**_kw(world, split))
        assert len(t) == len(j) == 8
        for i in range(len(t)):
            a, b = t[i], j[i]
            _same_sample(a, b)
            frame = i % 4
            ages = set(np.unique(a["frame_inds"][a["valid"]]))
            assert ages == set(range(min(frame, 2) + 1))
            assert a["valid"].sum() == min(600 * (min(frame, 2) + 1), 1500)
            assert a["seed_valid"].sum() == min(frame, 2) * 5
            assert a["gt_valid"].sum() == 4


def test_image_index_seed_keys_equal_jax(world, tmp_path):
    """Without the converter's maps in ``data_root``, seeds are keyed by
    the ``%07d`` image index (``tools/fsdpp/create_seed_boxes_from_info``'s
    keys), in both packages."""
    root = tmp_path / "no_maps"
    root.mkdir()
    with open(world["validation"], "rb") as f:
        infos = pickle.load(f)
    for info in infos:
        info["point_cloud"]["velodyne_path"] = os.path.join(
            world["root"], info["point_cloud"]["velodyne_path"])
    with open(root / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    seeds = {f"{info['image']['image_idx']:07d}": dict(
        boxes=np.asarray([[1.0, 2.0, -1.0, 2.0, 4.0, 1.5, 3.1]], np.float32),
        labels=np.asarray([k % 3]), scores=np.asarray([0.5], np.float32))
        for k, info in enumerate(infos)}
    with open(root / "seeds.pkl", "wb") as f:
        pickle.dump(seeds, f)
    kw = dict(data_root=str(root), info_path=str(root / "infos.pkl"),
              seeds_path=str(root / "seeds.pkl"), max_points=4096,
              max_seeds=4, max_gt=8)
    t = tinc.IncrementalWaymoDataset(**kw)
    j = jinc.IncrementalWaymoDataset(**kw)
    for i in (0, 3, 5):
        a, b = t[i], j[i]
        _same_sample(a, b)
        assert a["seed_valid"].sum() == min(i % 4, 4)


def _fake_predict(seen):
    """A deterministic detector in numpy: the first two valid gt boxes of
    the frame, moved 0.3 m in x, scored 0.9 and 0.05 (one above the 0.1
    feedback threshold, one below), and the seeds it was given, recorded
    in ``seen``."""
    def predict(batch):
        sb = np.asarray(batch.seed_boxes)[0].copy()
        sv = np.asarray(batch.seed_valid)[0].copy()
        seen.append((sb, sv))
        gb = np.asarray(batch.gt_boxes)[0]
        gv = np.asarray(batch.gt_valid)[0]
        boxes = np.zeros((1, 4, 7), np.float32)
        rows = gb[gv][:2]
        boxes[0, :len(rows)] = rows
        boxes[0, :, 0] += 0.3
        valid = np.zeros((1, 4), bool)
        valid[0, :len(rows)] = True
        return dict(boxes=boxes,
                    scores=np.asarray([[0.9, 0.05, 0.0, 0.0]], np.float32),
                    labels=np.asarray([[1, 2, 0, 0]], np.int32), valid=valid)
    return predict


def test_run_sequential_eval_equal_jax(world):
    t = tinc.IncrementalWaymoDataset(**_kw(world, "validation",
                                           test_mode=True))
    j = jinc.IncrementalWaymoDataset(**_kw(world, "validation",
                                           test_mode=True))
    t_seen, j_seen = [], []
    tres = tinc.run_sequential_eval(t, _fake_predict(t_seen), score_thr=0.1)
    jres = jinc.run_sequential_eval(j, _fake_predict(j_seen), score_thr=0.1)
    assert len(tres) == len(jres) == 8
    for a, b in zip(tres, jres):
        assert a.keys() == b.keys() and a["idx"] == b["idx"]
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for f, ((ab, av), (bb, bv)) in enumerate(zip(t_seen, j_seen)):
        np.testing.assert_array_equal(av, bv)
        np.testing.assert_array_equal(ab, bb)
        # one fed-back seed (the 0.9 box) past each sequence's first frame
        assert av.sum() == (0 if f % 4 == 0 else 1)
    # the fed seed is the previous frame's box in this frame's ego frame
    with open(world["validation"], "rb") as fh:
        infos = pickle.load(fh)
    prev = tres[0]["boxes"][:1]
    moved = tinc.box_frame_transform_np(prev, infos[0]["pose"],
                                        np.linalg.inv(infos[1]["pose"]))
    np.testing.assert_array_equal(t_seen[1][0][:1], moved)


def _train_cfg(world, max_points=1500):
    return dict(capacity=dict(max_points=max_points, max_seeds=12, max_gt=4),
                data=dict(dataset="waymo", sequential=True,
                          data_root=world["root"],
                          info_path=world["training"],
                          seeds_path=world["seeds"], num_previous_frames=2))


class _ModelStub:
    point_cloud_range = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)


def test_train_kind_equal_jax(world):
    """``sequential=True`` selects the incremental kind in both packages;
    the datasets' samples and the collated ``TemporalBatch`` (CPU tensors
    here, jnp arrays in JAX) are equal."""
    tds, tcol, tkind, _ = tsetup.build_train_dataset(_train_cfg(world),
                                                     _ModelStub())
    jds, jcol, jkind, _ = jsetup.build_train_dataset(_train_cfg(world),
                                                     _ModelStub())
    assert tkind == jkind == "waymo_incremental"
    assert tsetup.UNPORTED_KINDS == {}
    ts, js = [tds[i] for i in (2, 5)], [jds[i] for i in (2, 5)]
    for a, b in zip(ts, js):
        _same_sample(a, b)
    tb, jb = tcol(ts), jcol(js)
    for f in dataclasses.fields(tb):
        x = getattr(tb, f.name)
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        y = np.asarray(getattr(jb, f.name))
        if f.name == "seed_boxes":
            np.testing.assert_allclose(x.numpy(), y, **SEED_TOL)
        else:
            np.testing.assert_array_equal(x.numpy(), y, err_msg=f.name)
    assert tuple(tb.points.shape) == (2, 1500, 5)


def _tiny_fsdpp_config(path, world) -> str:
    """``flagship.tiny_fsdpp``'s model as a config file over the world's
    incremental set."""
    ss = tflag._tiny_fsd_cfg()
    ss["caps"] = dataclasses.asdict(ss["caps"])
    model = dict(type="TwoStageFSDPP",
                 point_cloud_range=tflag._TINY_FSD_PCR,
                 inc_voxel_size=(0.4, 0.4, 0.4), pre_score_thr=0.1,
                 center_noise=0.1, dim_noise=0.05, yaw_noise=0.1,
                 fsd=dict(single_stage=ss,
                          roi_head=tflag._tiny_roi_head_cfg(),
                          rois_per_sample=16))
    data = dict(dataset="waymo", sequential=True, samples_per_device=1,
                data_root=world["root"], info_path=world["training"],
                val_info_path=world["validation"],
                seeds_path=world["seeds"], num_previous_frames=2,
                max_points=1500, max_seeds=12, max_gt=4)
    path.write_text(f"model = {model!r}\n"
                    f"capacity = {dict(max_points=1500, max_seeds=12, max_gt=4)!r}\n"
                    f"data = {data!r}\n"
                    f"optimizer = dict(base_lr=1e-4, weight_decay=0.01, "
                    f"clip_norm=10.0)\n")
    return str(path)


def test_sequential_train_and_test_clis_on_cpu(world, tmp_path, capsys,
                                               monkeypatch):
    """TensorBoard is absent, as on the card's machine
    (``tests/test_torch_tools.py`` covers the train CLI's writer)."""
    from sst_tpu_torch.tools import test as test_cli
    from sst_tpu_torch.tools import train as train_cli

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    cfg = _tiny_fsdpp_config(tmp_path / "tiny_fsdpp.py", world)
    wd = str(tmp_path / "wd")
    summary = train_cli.main([cfg, "--device", "cpu", "--work-dir", wd,
                              "--max-steps", "2", "--log-interval", "1",
                              "--ckpt-interval", "2"])
    assert summary["steps"] == 2 and np.isfinite(summary["loss_total"]).all()
    out = str(tmp_path / "seq.pkl")
    res = test_cli.main([cfg, os.path.join(wd, "ckpt_2"), "--device", "cpu",
                         "--sequential", "--eval", "waymo", "--out", out])
    printed = capsys.readouterr().out
    assert "sequential eval: 8 frames" in printed
    assert res["frames"] == 8 and len(res["predict_ms"]) == 8
    assert "Overall/L2 mAPH" in res
    with open(out, "rb") as f:
        results = pickle.load(f)
    assert [r["idx"] for r in results] == list(range(8))
    assert all(r["boxes"].shape[1:] == (7,) for r in results)
    with pytest.raises(ValueError, match="seg"):
        test_cli.main([cfg, "--device", "cpu", "--sequential", "--eval",
                       "seg"])
