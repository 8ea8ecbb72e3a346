"""Parity of the port's nuScenes, Argo2, KITTI and Lyft data paths with the
JAX package's on the CPU, on files written in each dataset's format from a
numpy seed (``sst_tpu_torch/data/format_writers.py``; no real data is in
the repository): the datasets' samples, the CBGS indices,
``LoadPointsFromMultiSweeps`` on both pose routes and in ``test_mode``,
``ObjectSample`` from one ``RandomState``, the train-time dataset kinds,
the four evaluations (``nusc_eval``, ``argo2_eval``, ``kitti_eval``,
``lyft_eval`` through each dataset's ``evaluate``), the Argo2 feather round
trip and ``prune_frames_to_roi`` on a map the test writes.

Samples and indices are held bit for bit (every array, every name, and the
``RandomState`` after the pipeline); the evaluations' numbers within 1e-6.
The pipelines run their numpy route in both packages (``native.available``
patched false), so no seed depends on the native library's build.
"""

import copy
import os

import numpy as np
import pytest

import sst_tpu.data.native as jnative
import sst_tpu_torch.data.native as tnative
from sst_tpu.core import eval_argo2 as jargo
from sst_tpu.data import datasets as jds
from sst_tpu.data.pipelines import build_pipeline as jbuild
from sst_tpu.train import data_setup as jsetup
from sst_tpu_torch.core import eval_argo2 as targo
from sst_tpu_torch.data import datasets as tds
from sst_tpu_torch.data import format_writers as fw
from sst_tpu_torch.data.pipelines import build_pipeline as tbuild
from sst_tpu_torch.train import data_setup as tsetup
from test_av2_map import LOG_ID, TS, _write_fixture_log
from test_torch_data import _assert_same_sample
from torch_threads import torch_threads_per_worker  # noqa: F401

PCR = (-20.0, -20.0, -3.0, 20.0, 20.0, 3.0)
EVAL_TOL = 1e-6


@pytest.fixture(autouse=True)
def numpy_route(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("formats"))
    nusc = os.path.join(root, "nuscenes")
    argo = os.path.join(root, "argo2")
    kitti = os.path.join(root, "kitti")
    lyft = os.path.join(root, "lyft")
    for d in (nusc, argo, kitti, lyft):
        os.makedirs(d)
    return dict(
        nuscenes=(nusc, fw.write_nuscenes_set(nusc, seed=0, frames=6,
                                              points=1500, sweeps=3,
                                              boxes=8)),
        argo2=(argo, fw.write_argo2_set(argo, seed=1, frames=4,
                                        points=1500, log_id=LOG_ID)),
        kitti=(kitti, fw.write_kitti_set(kitti, seed=2, frames=4,
                                         points=1500)),
        # few frames and boxes: JAX's Lyft IoU runs eagerly, one compile
        # per box-count pair
        lyft=(lyft, fw.write_nuscenes_set(lyft, seed=3, frames=1,
                                          points=1500, sweeps=0, boxes=4,
                                          classes=fw.LYFT_CLASSES)),
        db=(nusc, fw.write_gt_database(nusc, fw.NUSC_CLASSES[:4], seed=4,
                                       per_class=6)),
        root=root)


_CLASSES = {"nuscenes": "NuScenesDataset", "argo2": "Argo2Dataset",
            "kitti": "KittiDataset", "lyft": "LyftDataset"}


def _pair(world, kind, pipeline=None, **kw):
    root, info = world[kind]
    make = lambda mod, build: getattr(mod, _CLASSES[kind])(  # noqa: E731
        data_root=root, info_path=info,
        pipeline=None if pipeline is None else build(
            copy.deepcopy(pipeline)), **kw)
    return make(tds, tbuild), make(jds, jbuild)


def _strip(sample):
    sample = dict(sample)
    info = sample.pop("info", None)
    return sample, info


def _assert_deep_equal(t, j, where="sample"):
    """Nested lists / dicts of arrays and scalars, equal bit for bit."""
    assert type(t) is type(j), where
    if isinstance(j, dict):
        assert sorted(t) == sorted(j), where
        for k in j:
            _assert_deep_equal(t[k], j[k], f"{where}.{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), where
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_deep_equal(a, b, f"{where}[{i}]")
    elif isinstance(j, np.ndarray):
        assert t.dtype == j.dtype and np.array_equal(t, j, equal_nan=(
            j.dtype.kind == "f")), where
    else:
        assert t == j, where


def _same(t, j):
    t, ti = _strip(t)
    j, ji = _strip(j)
    _assert_deep_equal(ti, ji, "info")
    sweeps_t, sweeps_j = t.pop("sweeps", None), j.pop("sweeps", None)
    _assert_deep_equal(sweeps_t, sweeps_j, "sweeps")
    _assert_same_sample(t, j)


_AUG = [
    dict(type="RandomFlip3D", flip_ratio_bev_horizontal=0.5,
         flip_ratio_bev_vertical=0.5),
    dict(type="GlobalRotScaleTrans", translation_std=(0.2, 0.2, 0.2)),
    dict(type="PointsRangeFilter", point_cloud_range=PCR),
    dict(type="ObjectRangeFilter", point_cloud_range=PCR),
    dict(type="PointShuffle"),
    dict(type="PadToCap", max_points=2048, max_gt=16),
]


@pytest.mark.parametrize("kind", ["nuscenes", "argo2", "kitti", "lyft"])
def test_dataset_samples_equal(world, kind):
    """Every sample of each dataset, raw and through an augmenting
    pipeline that ends in ``PadToCap`` (velocity columns kept for
    nuScenes, none for Argo2 and Lyft), equals JAX's bit for bit, and so
    does ``class_counts`` where the dataset has it."""
    t, j = _pair(world, kind)
    assert len(t) == len(j) > 0 and t.classes == j.classes
    for i in range(len(j)):
        _same(t.get_sample(i), j.get_sample(i))
    t, j = _pair(world, kind, _AUG)
    for i in range(len(j)):
        a, b = t[i], j[i]
        _same(a, b)
    if kind in ("nuscenes", "argo2", "lyft"):
        np.testing.assert_array_equal(t.class_counts(), j.class_counts())
        width = t.get_sample(0)["gt_boxes"].shape[1]
        assert width == (9 if kind == "nuscenes" else 7)
        # the invalid-flag and NaN-velocity rows are dropped / zeroed
        assert not np.isnan(t.get_sample(0)["gt_boxes"]).any()


def test_cbgs_indices_equal(world):
    """``CBGSDataset`` over the nuScenes set: the same resampled indices
    (``RandomState(0)``), from a dataset and from a config dict."""
    t, j = _pair(world, "nuscenes")
    tc, jc = tds.CBGSDataset(t), jds.CBGSDataset(j)
    assert tc.sample_indices == jc.sample_indices
    assert len(tc) != len(t)  # duplication happened
    root, info = world["nuscenes"]
    cfg = dict(type="NuScenesDataset", data_root=root, info_path=info)
    assert tds.CBGSDataset(cfg).sample_indices == jc.sample_indices
    _same(tc[3], jc[3])


def _waymo_sweeps(tmp_path, rng, n=3):
    """A Waymo-style sample: 4x4 poses of the frame and of each sweep."""
    def pose(yaw, t):
        m = np.eye(4)
        c, s = np.cos(yaw), np.sin(yaw)
        m[:2, :2] = [[c, -s], [s, c]]
        m[:3, 3] = t
        return m

    sweeps = []
    for k in range(n):
        p = rng.randn(300, 6).astype(np.float32) * 5
        path = str(tmp_path / f"w{k}.bin")
        p.tofile(path)
        sweeps.append(dict(data_path=path, timestamp=1.0 - 0.1 * (k + 1),
                           pose=pose(rng.uniform(-0.1, 0.1),
                                     rng.uniform(-2, 2, 3))))
    return {"points": rng.randn(400, 6).astype(np.float32) * 5,
            "timestamp": 1.0, "pose": pose(0.05, (1.0, 2.0, 0.0)),
            "sweeps": sweeps}


@pytest.mark.parametrize("case", ["nuscenes", "nuscenes_test_mode",
                                  "nuscenes_fewer", "waymo_pose",
                                  "empty_pad", "empty_pad_keep_close"])
def test_multisweeps_equal(world, tmp_path, case):
    """``LoadPointsFromMultiSweeps``: the nuScenes ``sensor2lidar`` route
    (a random choice of 2 of 3 sweeps, the first 2 in ``test_mode``, all
    when fewer than asked), Waymo's 4x4 ``pose`` route, and the padding of
    a sample without sweeps (with and without ``remove_close``); points,
    time-lag channel and the ``RandomState`` after."""
    rng = np.random.RandomState(7)
    if case.startswith("nuscenes"):
        t, _ = _pair(world, "nuscenes")
        sample = t.get_sample(1)
        sample.pop("info")
        cfg = dict(type="LoadPointsFromMultiSweeps",
                   sweeps_num=5 if case == "nuscenes_fewer" else 2,
                   load_dim=5, use_dim=(0, 1, 2, 3, 4),
                   test_mode=case == "nuscenes_test_mode")
    elif case == "waymo_pose":
        sample = _waymo_sweeps(tmp_path, rng)
        cfg = dict(type="LoadPointsFromMultiSweeps", sweeps_num=2,
                   load_dim=6, use_dim=(0, 1, 2, 3, 4, 5))
    else:
        sample = {"points": rng.randn(500, 5).astype(np.float32) * 3}
        cfg = dict(type="LoadPointsFromMultiSweeps", sweeps_num=2,
                   remove_close=1.0 if case == "empty_pad" else 0.0)
    sample["rng"] = np.random.RandomState(11)
    a = tbuild([cfg])(copy.deepcopy(sample))
    b = jbuild([cfg])(copy.deepcopy(sample))
    _same(a, b)
    lags = np.unique(a["points"][:, -1])
    assert len(lags) == (1 if case.startswith("empty") else 3) or \
        case == "nuscenes_fewer"


@pytest.mark.parametrize("seed", [0, 1])
def test_object_sample_equal(world, seed):
    """``ObjectSample`` over the gt database: the pasted objects, the
    points removed under them, the boxes (velocity columns zero-padded for
    the pasted rows) and labels, from one ``RandomState`` (the database
    sampler's own, seed 0, and the sample's)."""
    root, db = world["db"]
    cfg = [dict(type="ObjectSample", db_sampler=dict(
        info_path=db, data_root=root, rate=1.0,
        prepare=dict(filter_by_difficulty=[-1],
                     filter_by_min_points=dict(car=5)),
        sample_groups=dict(car=4, truck=3, trailer=2, bus=2),
        classes=fw.NUSC_CLASSES,
        points_loader=dict(load_dim=5, use_dim=(0, 1, 2, 3, 4))))]
    t, j = _pair(world, "nuscenes")
    tp, jp = tbuild(copy.deepcopy(cfg)), jbuild(copy.deepcopy(cfg))
    for i in range(3):
        a, b = _strip(t.get_sample(i))[0], _strip(j.get_sample(i))[0]
        a["rng"] = np.random.RandomState(seed * 10 + i)
        b["rng"] = np.random.RandomState(seed * 10 + i)
        a, b = tp(a), jp(b)
        _same(a, b)
        assert len(a["gt_labels"]) > len(t.get_sample(i)["gt_labels"])
        assert a["gt_boxes"].shape[1] == 9


def test_train_and_val_dataset_kinds_equal(world):
    """``build_train_dataset`` for the ``nuscenes`` kind (velocity, CBGS
    and a multi-sweep pipeline with ``ObjectSample``) and the ``argo2``
    kind, and ``build_val_dataset`` for both, against JAX's; the
    ``waymo_incremental`` kind, named directly, builds as JAX's does."""
    class _Model:
        point_cloud_range = PCR

    root, info = world["nuscenes"]
    _, db = world["db"]
    pipe = [dict(type="LoadPointsFromMultiSweeps", sweeps_num=2, load_dim=5,
                 use_dim=(0, 1, 2, 3)),
            dict(type="ObjectSample", db_sampler=dict(
                info_path=db, data_root=root, sample_groups=dict(car=3),
                classes=fw.NUSC_CLASSES,
                points_loader=dict(load_dim=5, use_dim=(0, 1, 2, 3))))] \
        + _AUG
    cfg = dict(capacity=dict(max_points=2048), data=dict(
        dataset="nuscenes", data_root=root, info_path=info,
        val_info_path=info, cbgs=True, use_dim=(0, 1, 2, 3),
        train_pipeline=pipe))
    for kind, c in (("nuscenes", cfg), ("argo2", dict(
            capacity=dict(max_points=2048), data=dict(
                dataset="argo2", data_root=world["argo2"][0],
                info_path=world["argo2"][1],
                val_info_path=world["argo2"][1])))):
        t = tsetup.build_train_dataset(copy.deepcopy(c), _Model())
        j = jsetup.build_train_dataset(copy.deepcopy(c), _Model())
        assert t[2] == j[2] == kind and len(t[0]) == len(j[0])
        if kind == "nuscenes":
            assert type(t[0]).__name__ == "CBGSDataset"
            assert t[0].sample_indices == j[0].sample_indices
        for i in (0, len(j[0]) - 1):
            _same(t[0][i], j[0][i])
        tv, tcls = tsetup.build_val_dataset(copy.deepcopy(c), _Model())
        jv, jcls = jsetup.build_val_dataset(copy.deepcopy(c), _Model())
        assert tcls == jcls
        _same(tv[1], jv[1])
    inc = copy.deepcopy(cfg)
    inc["data"]["dataset"] = "waymo_incremental"
    t = tsetup.build_train_dataset(copy.deepcopy(inc), _Model())
    j = jsetup.build_train_dataset(copy.deepcopy(inc), _Model())
    assert t[2] == j[2] == "waymo_incremental"
    assert type(t[0]).__name__ == "IncrementalWaymoDataset"
    assert len(t[0]) == len(j[0])


def _results(ds, seed, jitter=0.3):
    """Detections near each frame's gt (jittered by ``jitter`` m, some
    dropped, some spurious), in the datasets' ``evaluate`` layout."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(len(ds)):
        s = ds.get_sample(i)
        g = s["gt_boxes"]
        keep = rng.rand(len(g)) < 0.8
        boxes = g[keep].copy()
        boxes[:, :3] += rng.randn(len(boxes), 3).astype(np.float32) * jitter
        boxes[:, 6] += rng.randn(len(boxes)).astype(np.float32) * jitter
        extra = np.concatenate(
            [rng.uniform(-15, 15, (3, 2)), np.full((3, 1), -1.5),
             rng.uniform(0.5, 3, (3, 3)), rng.uniform(-3, 3, (3, 1)),
             np.zeros((3, g.shape[1] - 7))], 1).astype(np.float32)
        boxes = np.concatenate([boxes, extra])
        labels = np.concatenate([s["gt_labels"][keep],
                                 rng.randint(0, len(ds.classes), 3)])
        out.append(dict(boxes_3d=boxes,
                        scores_3d=rng.rand(len(boxes)).astype(np.float32),
                        labels_3d=labels.astype(np.int32)))
    return out


def _assert_metrics_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, (list, tuple, np.ndarray)):
            np.testing.assert_allclose(got[k], v, rtol=0, atol=EVAL_TOL,
                                       err_msg=k)
        elif isinstance(v, str):
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= EVAL_TOL, (k, got[k], v)


@pytest.mark.parametrize("kind", ["nuscenes", "argo2", "kitti", "lyft"])
def test_evaluations_equal(world, kind):
    """Each dataset's ``evaluate`` (nuScenes NDS with velocity errors,
    Argo2 CDS, KITTI R40 easy/moderate/hard in BEV and 3D, Lyft mAP over
    0.5:0.95) on the same detections: every number within 1e-6, and the
    metric is not degenerate."""
    t, j = _pair(world, kind)
    # Lyft's 3D IoU thresholds start at 0.5: jitter its boxes less
    res = _results(j, seed=5, jitter=0.05 if kind == "lyft" else 0.3)
    got, ref = t.evaluate(copy.deepcopy(res)), j.evaluate(copy.deepcopy(res))
    _assert_metrics_equal(got, ref)
    headline = {"nuscenes": "NDS", "argo2": "CDS", "kitti":
                "mAP_bev_hard_R40", "lyft": "Final mAP"}[kind]
    assert 0 < ref[headline] < 100


def test_feather_round_trip_and_roi_pruning_equal(world, tmp_path):
    """Argo2's feather output (``Argo2Dataset.evaluate`` with a prefix) is
    the same table in both packages and reads back to the detections; and
    ``prune_frames_to_roi`` on a map the test writes keeps the same boxes,
    so the ROI-filtered CDS is equal."""
    import pandas as pd

    t, j = _pair(world, "argo2")
    res = _results(j, seed=6)
    got = t.evaluate(copy.deepcopy(res), pklfile_prefix=str(tmp_path / "t"))
    ref = j.evaluate(copy.deepcopy(res), pklfile_prefix=str(tmp_path / "j"))
    a, b = pd.read_feather(got.pop("feather")), pd.read_feather(
        ref.pop("feather"))
    pd.testing.assert_frame_equal(a, b)
    assert len(a) == sum(len(r["scores_3d"]) for r in res)
    np.testing.assert_allclose(np.sort(a["score"].to_numpy()),
                               np.sort(np.concatenate(
                                   [r["scores_3d"] for r in res])))
    _assert_metrics_equal(got, ref)

    root = str(tmp_path / "av2")
    _write_fixture_log(root, yaw_deg=0.0, t_xyz=(110.0, 205.0, 0.0))
    rng = np.random.RandomState(8)
    boxes = np.concatenate([rng.uniform(-20, 20, (12, 2)),
                            np.zeros((12, 1)),
                            rng.uniform(1, 4, (12, 3)),
                            rng.uniform(-3, 3, (12, 1))], 1)
    preds = [dict(boxes=boxes, scores=rng.rand(12),
                  labels=np.zeros(12, np.int64))]
    gts = [dict(boxes=boxes[::2] + 0.1, labels=np.zeros(6, np.int64))]
    infos = [{"uuid": f"{LOG_ID}/{TS}"}]
    tp, tg = targo.prune_frames_to_roi(preds, gts, infos, root)
    jp, jg = jargo.prune_frames_to_roi(preds, gts, infos, root)
    for x, y in ((tp, jp), (tg, jg)):
        for k in y[0]:
            np.testing.assert_array_equal(x[0][k], y[0][k])
    assert 0 < len(tp[0]["boxes"]) < 12
    _assert_metrics_equal(targo.argo2_eval(tp, tg, ["REGULAR_VEHICLE"]),
                          jargo.argo2_eval(jp, jg, ["REGULAR_VEHICLE"]))
