"""Parity of the port's host data path (``sst_tpu_torch/data``, its
``train/data_setup.py``) with the JAX package's, bit for bit, on the CPU:
every pipeline transform on both routes (the native point-prep library and
numpy), the Waymo and synthetic datasets, ``collate_to_batch``, the
loader's index order and the train and val dataset dispatch.

The two routes give different samples: ``PadToCap`` draws a seed from the
sample's ``RandomState`` on the native route only. Each route is held
against JAX's same route; the numpy route is forced in both packages by
patching ``native.available`` (a test-time patch; no file of the JAX
package changes). Every case also holds the ``RandomState`` after the
transform equal, so the draws consumed are JAX's too. The pkl datasets
hand every sample one shared ``RandomState``, so their loaders run one
worker thread here (with more, the order of the draws follows the
threads).
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import sst_tpu.data.native as jnative
import sst_tpu_torch.data.native as tnative
from sst_tpu.data import datasets as jds
from sst_tpu.data import loader as jloader
from sst_tpu.data.pipelines import build_pipeline as jbuild
from sst_tpu.train import data_setup as jsetup
from sst_tpu_torch.data import datasets as tds
from sst_tpu_torch.data import loader as tloader
from sst_tpu_torch.data.pipelines import build_pipeline as tbuild
from sst_tpu_torch.train import data_setup as tsetup
from test_tracklet_dataset import ctrl_world  # noqa: F401 (fixture)
from torch_threads import torch_threads_per_worker  # noqa: F401

PCR = (-8.0, -8.0, -2.0, 8.0, 8.0, 4.0)


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """The pipelines' route in both packages."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available()
    return request.param


def _sample(seed: int, n: int = 600, g: int = 10, box_dim: int = 7) -> dict:
    """Points [n, 5] in and around PCR (the last column a sweep lag of 0,
    0.1 or 0.2), ``g`` boxes of width ``box_dim`` (velocity at 7:9)."""
    r = np.random.RandomState(seed)
    pts = r.uniform(-10, 10, (n, 5)).astype(np.float32)
    pts[:, 2] = r.uniform(-3, 5, n)
    pts[:, 4] = r.choice([0.0, 0.1, 0.2], n)
    boxes = np.concatenate([
        r.uniform(-9, 9, (g, 2)), r.uniform(-1, 0, (g, 1)),
        r.uniform(0.5, 4, (g, 3)), r.uniform(-np.pi, np.pi, (g, 1)),
        r.randn(g, box_dim - 7)], 1).astype(np.float32)
    return {"points": pts, "gt_boxes": boxes,
            "gt_labels": r.randint(0, 3, g).astype(np.int32),
            "rng": np.random.RandomState(seed + 1)}


def _assert_same_sample(t: dict, j: dict):
    assert sorted(t) == sorted(j)
    for k in j:
        if k == "rng":
            ts, js = t[k].get_state(), j[k].get_state()
            assert ts[0] == js[0] and ts[2:] == js[2:], "draws consumed"
            assert np.array_equal(ts[1], js[1]), "draws consumed"
        elif isinstance(j[k], np.ndarray):
            assert t[k].dtype == j[k].dtype, k
            assert np.array_equal(t[k], j[k]), k
        else:
            assert t[k] == j[k], k


TRANSFORMS = {
    "flip_h_v": [dict(type="RandomFlip3D", flip_ratio_bev_horizontal=1.0,
                      flip_ratio_bev_vertical=1.0)],
    "flip_default": [dict(type="RandomFlip3D")],
    "rot_scale_trans": [dict(type="GlobalRotScaleTrans",
                             translation_std=(0.2, 0.2, 0.1))],
    "points_range": [dict(type="PointsRangeFilter", point_cloud_range=PCR)],
    "points_range_numpy": [dict(type="PointsRangeFilter",
                                point_cloud_range=PCR, use_native=False)],
    "object_range": [dict(type="ObjectRangeFilter", point_cloud_range=PCR)],
    "shuffle": [dict(type="PointShuffle")],
    "pad_under_cap": [dict(type="PadToCap", max_points=1024, max_gt=16)],
    "pad_over_cap": [dict(type="PadToCap", max_points=256, max_gt=4)],
    "point_drop": [dict(type="RandomPointDrop", max_ratio=0.5, prob=1.0)],
    "frame_dropout": [dict(type="FrameDropout", drop_ratio=0.5)],
    "object_noise": [dict(type="ObjectNoise")],
    "train_chain": tsetup.default_train_pipeline(PCR, 512),
}


@pytest.mark.parametrize("box_dim", [7, 9])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(route, name, box_dim):
    """Each transform (and the default train chain) on three samples in a
    row, each from its own seed: outputs and the RandomState after, bit for
    bit."""
    cfgs = TRANSFORMS[name]
    tp, jp = tbuild(copy.deepcopy(cfgs)), jbuild(copy.deepcopy(cfgs))
    for seed in range(3):
        s = _sample(seed, box_dim=box_dim)
        _assert_same_sample(tp(copy.deepcopy(s)), jp(copy.deepcopy(s)))


def test_load_points_and_unported_transform(tmp_path):
    pts = np.random.RandomState(0).randn(100, 6).astype(np.float32)
    pts.tofile(tmp_path / "a.bin")
    cfg = [dict(type="LoadPointsFromFile", load_dim=6, use_dim=(0, 1, 2, 4))]
    s = {"pts_filename": str(tmp_path / "a.bin")}
    _assert_same_sample(tbuild(cfg)(dict(s)), jbuild(cfg)(dict(s)))
    # every transform of the JAX registry is ported (the multi-sweep
    # loader and ObjectSample: tests/test_torch_data_nusc_argo.py); an
    # unknown type raises
    tbuild([dict(type="LoadPointsFromMultiSweeps")])
    with pytest.raises(KeyError, match="NoSuchTransform"):
        tbuild([dict(type="NoSuchTransform")])


@pytest.fixture
def waymo_world(tmp_path):
    """Three frames of KITTI-format Waymo infos: 6-channel .bin clouds,
    annos in camera coordinates with a calib (a class outside the dataset's
    among them, and a frame without annos)."""
    r = np.random.RandomState(7)
    rect = np.eye(4, dtype=np.float32)
    rect[:3, :3] = [[0.9998, 0.01, 0.0], [-0.01, 0.9998, 0.0], [0, 0, 1]]
    trv2c = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.2], [1, 0, 0, 0.3],
                      [0, 0, 0, 1]], np.float32)
    infos = []
    for i in range(3):
        pts = r.uniform(-10, 10, (800, 6)).astype(np.float32)
        pts[:, 2] = r.uniform(-2.5, 4.5, 800)
        pts.tofile(tmp_path / f"{i}.bin")
        info = dict(point_cloud=dict(velodyne_path=f"{i}.bin"),
                    image=dict(image_idx=i),
                    calib=dict(R0_rect=rect, Tr_velo_to_cam=trv2c))
        if i < 2:
            g = 5
            info["annos"] = dict(
                name=np.array(["Car", "Pedestrian", "Sign", "Cyclist",
                               "Car"]),
                location=r.uniform(-6, 6, (g, 3)).astype(np.float32),
                dimensions=r.uniform(0.5, 4, (g, 3)).astype(np.float32),
                rotation_y=r.uniform(-np.pi, np.pi, g).astype(np.float32))
        infos.append(info)
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump({"infos": infos}, f)
    return tmp_path


def _waymo_pair(root, pipeline_cfg, **kw):
    """The port's and JAX's ``WaymoDataset`` over ``root``."""
    return tuple(m.WaymoDataset(data_root=str(root),
                                info_path=str(root / "infos.pkl"),
                                pipeline=b(copy.deepcopy(pipeline_cfg)), **kw)
                 for m, b in ((tds, tbuild), (jds, jbuild)))


@pytest.mark.parametrize("pipe", ["none", "train_chain"])
def test_waymo_dataset_matches_jax(route, waymo_world, pipe):
    """``get_sample`` (camera → LiDAR boxes through the calib, the class
    filter, labels) and the train chain over the shared RandomState, frame
    after frame (twice over the three frames)."""
    cfg = [] if pipe == "none" else TRANSFORMS["train_chain"]
    t, j = _waymo_pair(waymo_world, cfg, use_dim=(0, 1, 2, 3, 4))
    assert len(t) == len(j) == 3
    for idx in (0, 1, 2, 1, 0, 2):
        ts, js = t[idx], j[idx]
        assert ts["info"] is not None
        ts.pop("info"), js.pop("info")
        _assert_same_sample(ts, js)
    if pipe == "none":
        assert len(j[0]["gt_labels"]) == 4  # "Sign" dropped


def test_camera_to_lidar_boxes_matches_jax(waymo_world):
    with open(waymo_world / "infos.pkl", "rb") as f:
        info = pickle.load(f)["infos"][0]
    c = info["calib"]
    for rect, trv2c in ((c["R0_rect"], c["Tr_velo_to_cam"]), (None, None)):
        got = tds.camera_to_lidar_boxes(info["annos"], rect, trv2c)
        ref = jds.camera_to_lidar_boxes(info["annos"], rect, trv2c)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_synthetic_dataset_and_collate_match_jax(route):
    """``SyntheticDataset`` samples (a RandomState per index) through the
    range filter and pad, and ``collate_to_batch``: the port's CPU tensors
    hold JAX's numpy arrays."""
    cfg = [dict(type="PointsRangeFilter", point_cloud_range=PCR),
           dict(type="PadToCap", max_points=1024)]
    kw = dict(num_samples=4, num_points=2048, pc_range=PCR, seed=3)
    t = tds.SyntheticDataset(pipeline=tbuild(cfg), **kw)
    j = jds.SyntheticDataset(pipeline=jbuild(cfg), **kw)
    samples_t, samples_j = [t[i] for i in (0, 3)], [j[i] for i in (0, 3)]
    for a, b in zip(samples_t, samples_j):
        _assert_same_sample(a, b)
    tb, jb = tds.collate_to_batch(samples_t), jds.collate_to_batch(samples_j)
    for k in ("points", "valid", "gt_boxes", "gt_labels", "gt_valid"):
        got, ref = getattr(tb, k), getattr(jb, k)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(ref)), k
        assert got.numpy().dtype == np.asarray(ref).dtype, k


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_loader_index_order_matches_jax(shards, drop_last, weak):
    """Index order for seeds 0, 5; epochs 0-2; every shard; plain and
    sequence-weak shuffle (sequences of 1-9 frames); and the batches a
    one-thread port loader yields, epoch after epoch."""
    n = 41
    seq_ids = np.repeat(np.arange(9), [1, 9, 4, 6, 2, 7, 3, 5, 4])
    assert len(seq_ids) == n
    for seed in (0, 5):
        for shard in range(shards):
            kw = dict(batch_size=3, seed=seed, drop_last=drop_last,
                      num_shards=shards, shard_id=shard, collate=list,
                      weak_shuffle_seq_ids=seq_ids if weak else None,
                      weak_shuffle_shard_size=4)
            t = tloader.DataLoader(_Range(n), num_workers=1, **kw)
            j = jloader.DataLoader(_Range(n), **kw)
            assert len(t) == len(j)
            for epoch in range(3):
                t.epoch = j.epoch = epoch
                ref = j._indices()
                assert np.array_equal(t._indices(), ref)
                got = [i for b in t for i in b]
                assert got == [int(i) for i in ref]
                assert t.epoch == epoch + 1
    np.testing.assert_array_equal(
        tloader.weak_shuffle_indices(seq_ids, 4, 1, 2, 2, 1),
        jloader.weak_shuffle_indices(seq_ids, 4, 1, 2, 2, 1))
    assert tloader.sequential_lane_indices(seq_ids, 3) == \
        jloader.sequential_lane_indices(seq_ids, 3)


class _ModelStub:
    point_cloud_range = PCR


def test_train_and_val_dispatch_synthetic(route):
    cfg = dict(capacity=dict(max_points=1024), data=dict())
    t = tsetup.build_train_dataset(cfg, _ModelStub(), synthetic=True,
                                   batch_size=2)
    j = jsetup.build_train_dataset(cfg, _ModelStub(), synthetic=True,
                                   batch_size=2)
    assert t[1:] == j[1:] == (None, "synthetic", t[3])
    assert len(t[0]) == len(j[0]) == 64
    _assert_same_sample(t[0][5], j[0][5])
    tv, tc = tsetup.build_val_dataset(cfg, _ModelStub(), synthetic=True,
                                      num_samples=3)
    jv, jc = jsetup.build_val_dataset(cfg, _ModelStub(), synthetic=True,
                                      num_samples=3)
    assert tc == jc and len(tv) == len(jv) == 3
    _assert_same_sample(tv[2], jv[2])


def test_train_and_val_dispatch_waymo(route, waymo_world):
    cfg = dict(capacity=dict(max_points=1024),
               data=dict(dataset="waymo", data_root=str(waymo_world),
                         info_path=str(waymo_world / "infos.pkl"),
                         val_info_path=str(waymo_world / "infos.pkl"),
                         load_dim=6, use_dim=(0, 1, 2, 3, 4)))
    t = tsetup.build_train_dataset(cfg, _ModelStub())
    j = jsetup.build_train_dataset(cfg, _ModelStub())
    assert t[1:] == j[1:] and t[2] == "waymo"
    for idx in (0, 2, 1):
        a, b = t[0][idx], j[0][idx]
        a.pop("info"), b.pop("info")
        _assert_same_sample(a, b)
    # the val set: range filter and pad only, on 5-channel points
    tv, _ = tsetup.build_val_dataset(cfg, _ModelStub())
    jv, _ = jsetup.build_val_dataset(cfg, _ModelStub())
    a, b = tv[0], jv[0]
    a.pop("info"), b.pop("info")
    _assert_same_sample(a, b)
    # sequential=True: FSD++'s incremental kind, JAX's samples (three
    # frames of one sequence, the 1,024-point cap drawn from 2,400)
    inc = copy.deepcopy(cfg)
    inc["data"]["sequential"] = True
    t = tsetup.build_train_dataset(inc, _ModelStub())
    j = jsetup.build_train_dataset(inc, _ModelStub())
    assert t[2] == j[2] == "waymo_incremental"
    for idx in (0, 2):
        a, b = t[0][idx], j[0][idx]
        for k in ("points", "valid", "frame_inds", "gt_boxes", "gt_labels",
                  "gt_valid", "seed_valid"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_dispatch_tracklet(ctrl_world):  # noqa: F811
    """The tracklet kind: the ported dataset and its collate (CPU
    tensors), against JAX's on the same world."""
    cfg = dict(
        capacity=dict(max_points=4096, max_frames=8),
        data=dict(dataset="waymo_tracklet", data_root=str(ctrl_world),
                  tracklet_path=str(ctrl_world / "tracklets.pkl"),
                  poses_path=str(ctrl_world / "poses.pkl"),
                  frame_index_path=str(ctrl_world / "frame_index.pkl"),
                  candidates_path=str(ctrl_world / "cands.pkl")))
    tds_, tcol, tkind, _ = tsetup.build_train_dataset(cfg, _ModelStub())
    jds_, jcol, jkind, _ = jsetup.build_train_dataset(cfg, _ModelStub())
    assert tkind == jkind == "waymo_tracklet"
    tb, jb = tcol([tds_[0]]), jcol([jds_[0]])
    for k in ("points", "valid", "frame_inds", "trk_boxes", "trk_valid",
              "gt_boxes", "gt_valid"):
        got = getattr(tb, k)
        assert got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(getattr(jb, k))), k
    assert tsetup.build_val_dataset(cfg, _ModelStub()) == (None, None)
