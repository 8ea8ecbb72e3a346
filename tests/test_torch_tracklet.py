"""The port's CTRL data path against the JAX package, on the CPU, with no
model: ``core/tracklet.py`` (``LiDARTracklet``'s methods and
``pad_tracklet_arrays``) and ``data/tracklet_dataset.py``
(``WaymoTrackletDataset`` and ``collate_tracklets``) on the world of
tests/test_tracklet_dataset.py, which the fixture writes under ``tmp_path``.

Tolerances: every numpy result bit for bit (the port copies the JAX
package's numpy code, and its draws from the same ``RandomState`` seeds);
``to_world`` (float32 torch against JAX's float32 XLA: ``sin``, ``cos`` and
``atan2`` may round an ulp apart) within 1e-6 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sst_tpu.core import tracklet as jtrk
from sst_tpu.data import tracklet_dataset as jds
from sst_tpu_torch.core import tracklet as ttrk
from sst_tpu_torch.data import tracklet_dataset as tds
from test_tracklet_dataset import ctrl_world  # noqa: F401  (fixture)
from torch_threads import torch_threads_per_worker  # noqa: F401

_FIELDS = ("points", "valid", "frame_inds", "trk_boxes", "trk_scores",
           "trk_valid", "labels", "gt_boxes", "gt_valid")


def _track(cls, n=12, seed=0, gap_at=None):
    rng = np.random.RandomState(seed)
    ts = [1_000_000 + 100_000 * i for i in range(n)]
    if gap_at is not None:
        ts = ts[:gap_at] + [t + 900_000 for t in ts[gap_at:]]
    boxes = np.concatenate([
        np.cumsum(rng.uniform(0.5, 1.5, (n, 3)), 0),
        rng.uniform(1.0, 5.0, (n, 3)), rng.uniform(-3, 3, (n, 1))],
        1).astype(np.float32)
    return cls("ctx", "obj", 1, ts, boxes, rng.rand(n).astype(np.float32))


def _poses(track, seed=1):
    rng = np.random.RandomState(seed)
    out = {}
    for ts in track.timestamps:
        a = rng.uniform(-np.pi, np.pi)
        pose = np.eye(4)
        pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        pose[:3, 3] = rng.uniform(-50, 50, 3)
        out[ts] = pose
    return out


def _same(got, ref, atol=0.0):
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _same(g, r, atol)
        return
    if dataclasses.is_dataclass(ref):
        for f in dataclasses.fields(ref):
            _same(getattr(got, f.name), getattr(ref, f.name), atol)
        return
    if isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype
        if atol:
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(got, ref)
        return
    assert got == ref


_FULL_TS = [1_000_000 + 100_000 * i for i in range(-4, 16)]

# (name, call on a tracklet, tracklet kwargs); calls that draw take a fresh
# RandomState(3) in both packages
_METHODS = [
    ("len", lambda t: len(t), {}),
    ("center_frame", lambda t: t.center_frame(), {}),
    ("to_ego", lambda t: t.to_ego(_poses(t)), {}),
    ("velocity", lambda t: t.velocity(), {}),
    ("velocity_single", lambda t: t.velocity(), dict(n=1)),
    ("extend", lambda t: t.extend(3, "backward", _FULL_TS, 2), {}),
    ("extend_gap", lambda t: t.extend(3, "backward", _FULL_TS, 2),
     dict(gap_at=1)),
    ("extend_all", lambda t: t.extend_all(_FULL_TS, 2), {}),
    ("slice", lambda t: t.slice(2, 7), {}),
    ("remove", lambda t: t.remove(t.timestamps[1::3]), {}),
    ("random_frame_drop",
     lambda t: t.random_frame_drop(0.5, np.random.RandomState(3)), {}),
    ("random_frame_drop_all",
     lambda t: t.random_frame_drop(1.0, np.random.RandomState(3)), {}),
    ("ts_intersection", lambda t: t.ts_intersection(t.slice(3, 20)), {}),
    ("add_center_noise",
     lambda t: t.add_center_noise(0.3, np.random.RandomState(3)), {}),
    ("add_size_noise",
     lambda t: t.add_size_noise(2.0, np.random.RandomState(3), True), {}),
    ("add_yaw_noise",
     lambda t: t.add_yaw_noise(0.5, np.random.RandomState(3)), {}),
]


@pytest.mark.parametrize("name", [m[0] for m in _METHODS])
def test_tracklet_methods_equal_jax(name):
    _, call, kw = next(m for m in _METHODS if m[0] == name)
    ref = call(_track(jtrk.LiDARTracklet, **kw))
    got = call(_track(ttrk.LiDARTracklet, **kw))
    if isinstance(ref, jtrk.LiDARTracklet):
        assert isinstance(got, ttrk.LiDARTracklet)
    _same(got, ref)


def test_tracklet_to_world_matches_jax():
    ref = _track(jtrk.LiDARTracklet)
    ref = ref.to_world(_poses(ref))
    got = _track(ttrk.LiDARTracklet)
    got = got.to_world(_poses(got))
    _same(got, ref, atol=1e-6)


def test_extend_forward_raises():
    with pytest.raises(ValueError, match="backward"):
        _track(ttrk.LiDARTracklet).extend(3, "forward", _FULL_TS, 2)


@pytest.mark.parametrize("n_points,with_gt", [(300, True), (900, False),
                                              (0, True)])
def test_pad_tracklet_arrays_equal_jax(n_points, with_gt):
    """Fewer points than the cap, more (the RandomState(0) subsample), none;
    more frames than the cap; gt candidates or none."""
    rng = np.random.RandomState(n_points)
    pts = rng.randn(n_points, 6).astype(np.float32)
    fi = rng.randint(0, 14, n_points).astype(np.int32)
    boxes = rng.randn(12, 7).astype(np.float32)
    scores = rng.rand(12).astype(np.float32)
    gt = rng.randn(12, 7).astype(np.float32) if with_gt else None
    gv = rng.rand(12) > 0.3 if with_gt else None
    args = (pts, fi, boxes, scores, gt, gv, 2, 512, 10)
    ref = jtrk.pad_tracklet_arrays(*args)
    got = ttrk.pad_tracklet_arrays(*args)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _same(got[k], ref[k])


def _datasets(root, **kw):
    common = dict(
        data_root=str(root), tracklet_path=str(root / "tracklets.pkl"),
        poses_path=str(root / "poses.pkl"),
        frame_index_path=str(root / "frame_index.pkl"),
        candidates_path=str(root / "cands.pkl"), load_dim=6,
        use_dim=(0, 1, 2, 3, 4), **kw)
    return jds.WaymoTrackletDataset(**common), \
        tds.WaymoTrackletDataset(**common)


@pytest.mark.parametrize("caps", [dict(max_points=2048, max_frames=8),
                                  dict(max_points=256, max_frames=4)])
def test_tracklet_dataset_sample_equals_jax(ctrl_world, caps):  # noqa: F811
    """``WaymoTrackletDataset[0]``: the crop, the pose alignment into the
    track frame and the padding (at 256 points the RandomState(0)
    subsample, at 4 frames the frame cap) bit for bit."""
    jd, td = _datasets(ctrl_world, **caps)
    assert len(td) == len(jd) == 1
    ref, got = jd[0], td[0]
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k == "rng":
            assert (got[k].get_state()[1] == ref[k].get_state()[1]).all()
        else:
            _same(np.asarray(got[k]), np.asarray(ref[k]))
    assert got["valid"].sum() > 100 and got["trk_valid"].sum() == min(
        6, caps["max_frames"])


def test_collate_tracklets_equals_jax(ctrl_world):  # noqa: F811
    """``collate_tracklets`` of two samples: a torch ``TrackletBatch`` on
    the device asked for, every field JAX's batch bit for bit."""
    jd, td = _datasets(ctrl_world, max_points=2048, max_frames=8)
    ref = jds.collate_tracklets([jd[0], jd[0]])
    got = tds.collate_tracklets([td[0], td[0]], device="cpu")
    for k in _FIELDS:
        g, r = getattr(got, k), np.asarray(getattr(ref, k))
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        _same(g.numpy(), r)
